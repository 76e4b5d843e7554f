#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddlemix_tpu_torch) on one CUDA card.

Drives sixteen slices at their published widths with weights drawn on the
card from a seeded torch.Generator:

  - SDXL-1024 text-to-image through StableDiffusionXLPipeline.__call__, in
    bf16 and then in the static a8w8 configuration (one pipeline built with
    quant="a8w8_static" serves both: until its scales are loaded it is the
    bf16 path), the a8w8 request also with int8 QK^T attention
    (PMIX_INT8_ATTN=1);
  - LLaVA-1.5-7B generation through LlavaForConditionalGeneration.generate
    (CLIP ViT-L/14-336, mlp2x_gelu projector, Llama-7B, all 32 layers) at the
    JAX bench's shapes, in bf16, then weight-only int8 (wint8), then with
    dynamic int8 activations over int8 (a8w8) and packed int4 (a8w4, the
    bench's default; wint4 computes as a8w4) weights, each built afresh by
    random_llava(quant=...);
  - SD3-medium text-to-image through StableDiffusion3Pipeline.__call__
    (MM-DiT 24 x 1536, CLIP-L + bigG with projection, T5 v1.1-XXL encoder,
    16-channel VAE, FlowMatch Euler) in bf16;
  - Llama-2-7B serving (32 layers, 32 heads x 128, bf16 weights) through
    greedy_generate over the int8 KV cache (cachekv_int8) and through
    paged_greedy_generate over the paged KV cache;
  - Llama-2-7B LoRA supervised fine-tuning through
    tools.supervised_finetune.build_trainer and Trainer.train, with the
    published recipe configs/llava/lora_sft_7b.json (LoRA r 128 / alpha 256
    on every projection, AdamW at 2e-4, cosine, 100 warmup steps, bf16,
    MixToken packing to 2048) and its cuts (TRAIN_OVERRIDES: 2 rows x 8
    micro-batches an optimizer step; 24 micro-batches); then the model
    saved by save_pretrained and read back by AutoModel, and
    tools.supervised_finetune.main on that directory (SFT_MAIN_OVERRIDES:
    checkpoints inside accumulation windows kept to 1, an eval over a
    held-out split, a warmup of 2), resumed from its checkpoint, and its
    adapter read back, merged and merged again by `cli merge-lora`;
  - CLIP ViT-B/16 (the JAX bench's widths = examples/train_clip.py's VITB16,
    fp32 weights, bf16 compute) at batch 256: the dual-tower bench forward
    (models.clip.vitb16.pair_logits) and contrastive training through
    tools.train_clip.build_trainer and Trainer.train (lr 5e-4, cosine,
    warmup max(steps // 10, 1), clip 1.0; 6 steps, no checkpoints), and
    tools.train_clip.main --synthetic, the example's data plane (generated
    jpegs, PIL decode and CLIPImageProcessor in the loader's workers);
  - EVA02-CLIP-B/16 (EVA-CLIP's published EVA02-CLIP-B-16.json: rope,
    SwiGLU with sub-LN, bias-less k; the CLIP text tower; fp32 weights, bf16
    compute) at batch 256: Appflow zero-shot requests (one 640 x 480 jpeg
    against 1,000 labels), the zero-shot eval (a 1,000-class classifier over
    4 templates, 256 jpegs through CLIPImageProcessor's default and native
    paths) and contrastive training by configs/eva_clip/pretrain_b16.json's
    optimizer (lr 5e-4, cosine, weight decay 0.05, layer decay 0.75; cut to
    6 steps with a warmup of 2, no checkpoints);
  - SD1.5-512 text-to-image through StableDiffusionPipeline.__call__
    (runwayml/stable-diffusion-v1-5: UNet 320-1280 with 1x1-conv
    projections and 8 heads a block, so head_dim 40, 80 and 160; CLIP-L text;
    PNDM) in bf16, 50 steps, guidance 7.5;
  - SD1.5 UNet fine-tuning through tools.train_text_to_image.build_trainer
    and Trainer.train, the recipe of examples/train_text_to_image.py (DDPM
    noising at a random timestep, epsilon target, min-SNR gamma 5.0, AdamW
    at 1e-5, cosine over 1,000 steps, clip 1.0, shuffled batches of 8 over
    the example's 256 seeded samples of 64x64x4 latents and 77x768 hidden
    states), fp32 masters and bf16 compute; 5 steps, no checkpoints;
  - BLIP-2 OPT-2.7B captioning (Salesforce/blip2-opt-2.7b: the ViT-g tower,
    1,408 x 39 layers at 224 px, the Q-Former with 32 queries, OPT-2.7B,
    3.74 B parameters in bf16) through Blip2Processor on a jpeg and
    Blip2ForConditionalGeneration.generate over OPT's BOS, 32 new tokens;
  - diffusers checkpoints: an SD1.5 pipeline directory in diffusers' own
    layout (written from the seeded fp32 pipeline) read by
    DiffusionPipeline.from_pretrained, and the JAX examples run on it
    through the port's entry points: tools.text_to_image.main,
    tools.train_text_to_image.main, tools.train_dreambooth_lora.main and
    tools.train_dreambooth.main (the VAE encoder, LoRA over the UNet, the
    prior-preservation loss); an SDXL-base directory written by the port's
    save_pretrained and served from DiffusionPipeline.from_pretrained;
  - Qwen2-VL-7B serving (Qwen/Qwen2-VL-7B-Instruct: the 32-block 1,280-wide
    packed-patch vision tower, Qwen2-7B with 28 query heads on 4 KV heads
    under M-RoPE; 8.29 B bf16 parameters, nothing cut) through
    Qwen2VLImageProcessor, get_rope_index and
    Qwen2VLForConditionalGeneration.generate, read back from a directory in
    HF's layout: image, two-image and video requests of 128 new tokens;
  - SD3-medium from its published diffusers directory (written from the
    seeded bf16 pipeline, read by DiffusionPipeline.from_pretrained with the
    seeded T5 tokenizer as `tokenizer_3`), served by tools.text_to_image.main,
    and its transformer fine-tuned by the flow-match loss (fp32 masters, bf16
    compute, gradient checkpointing per block) through diffusers.sd3's
    sd3_trainer and Trainer.train at batch 2 on VAE latents of 1024 px jpegs;
  - SD1.5-512 under a ControlNet (lllyasviel/sd-controlnet-canny's config,
    361 M parameters) and under a full T2I-Adapter (TencentARC/
    t2iadapter_canny_sd15v2's widths, 3 input channels), both written into
    pipeline directories and served from DiffusionPipeline.from_pretrained
    (UniPC at 20 steps and DDIM at 50, CFG 7.5, on 512 px edge maps), trained
    by tools.train_controlnet.main (batch 4) and tools.train_t2i_adapter.main
    (batch 2 at 512 px), and the SD1.5 UNet trainer with gradient
    checkpointing per block;
  - DiT-XL/2-256 (facebook/DiT-XL-2-256's widths) and the SD VAE through
    DiTPipeline read from its directory (class-conditional, CFG 4.0, DDIM
    and DPM-Solver++) and trained by tools.train_dit.main (batch 16,
    gradient checkpointing); PixArt-XL-2-512x512 over T5 v1.1-XXL and the SD
    VAE through PixArtAlphaPipeline (20 DPM-Solver++ steps, CFG 4.5);
  - InternVL2-8B serving (OpenGVLab/InternVL2-8B: InternViT-300M over 448 px
    tiles, the pixel-unshuffle projector, InternLM2.5-7B at GQA 4; 8.08 B
    bf16 parameters) through InternVLImageProcessor's dynamic tiling (and
    MiniMonkey's) and InternVLChatModel.generate, read back from a directory
    in JAX's layout by AutoModel;
  - Qwen-VL-Chat serving (Qwen/Qwen-VL-Chat: ViT-bigG and its 256-query
    Resampler, Qwen-7B with logn attention and dynamic NTK; 9.66 B bf16
    parameters) through QwenVLProcessor's image processor and
    QwenVLForConditionalGeneration.generate, read back the same way.

Phases:

  1. device        card name and power limit, TF32 switches set and printed
  2. build         nvcc builds paddlemix_tpu_torch/csrc/*.cu into
                   build/kernels/, one process per source, in parallel
  3. kernels       each SDXL kernel against its plain PyTorch version at the
                   main path's shapes: kernel, plain and library-call times
                   from CUDA events, and the bound; flash is gated per
                   element, with a control (the plain version without the
                   last tile's keys) that must fail the same limit, also at
                   (1, 141, 4, 64), whose rows fill no tile; every flash
                   case (B1, its int8 form, B15) also prints the
                   instantiation that served it (csrc/flash_fwd.cu's width
                   table: compiled width, key tile, ring stages, the head
                   read in place or padded; the library's answer held
                   against the wrapper's mirror), its TFLOP/s beside the
                   bound, ptxas's registers and spills (a spill fails the
                   run) and its shared memory;
                   the int8 GEMM (B2) also at a ragged (1000, 1296, 1288),
                   each B2 case with its core and tile plan
                   (csrc/gemm_wg.cuh, ops/gemm_tiles.py), ptxas counts,
                   shared memory, TOP/s, and torch._int_mm on x quantized
                   beforehand beside bf16 torch.matmul; the int8 convs (B3,
                   B5) also at a ragged (1, 50, 100, 80 -> 200) and (1, 50,
                   100, 96 -> 200), each case with its core and tile plan
                   (ops/gemm_tiles.py conv_plan), ptxas counts, shared memory,
                   TOP/s and its parts' times (the activation pass, the conv,
                   for B5 the GroupNorm statistics), B5 with cuDNN's bf16
                   F.conv2d of the same conv beside it; B4 (csrc/norms.cu)
                   per element at SDXL's shapes and a ragged (1, 50, 100,
                   96), each with the 16-group control, in both of its plan's
                   forms; the library's plans held against the wrappers'
                   mirrors at every B4 shape of the module walks (printed
                   with the launches by shape of each path) and at the
                   LayerNorm backward's, with the clusters each runs at once;
                   B4's statistics per element at FUSED_CASES' shapes and a
                   ragged one, with a control (rstd from E[x^2]) that must
                   fail; two launches bit-identical and CUDA-graph replays
                   equal to them, and the kernels a call by the profiler, for
                   B4 in both forms, its statistics and the LayerNorm
                   backward with one cluster and with several
  4. agree         one full-width bf16 UNet forward at a small latent, kernels
                   vs plain
  5. serve         2 bf16 requests, 1024x1024, 25 Euler steps, guidance 5.0;
                   each must launch the kernels as often as walking the blocks
                   predicts
  6. calibrate     record and load the 771 UNet + 33 VAE static a8w8 scales
  7. a8w8 agree    the full-width a8w8 UNet at a small latent like the
                   calibration's, int8 kernels vs plain, and for each int8
                   kernel a control run whose plain version skips its
                   activation quantize, which must fail the same limit (and,
                   ungated, all kernels vs plain and a8w8 vs bf16)
  8. a8w8 serve    the same 2 requests in a8w8, with the same checks
  9. a8w8 int8-attn B1's int8 QK^T form against its plain version per
                   element at the SDXL and SD1.5 self-attention shapes, with
                   a control (quantizing by truncation) that must fail the
                   same limit; at each shape its activation pass
                   (quantize_qk_int8) against int8_qk_operands bit for bit
                   (q8, k8, sq, sk: 0 mismatches; the truncation control
                   must mismatch), and its time alone; before them the width
                   table at every head (8-256) and both forms, the
                   library's against the wrapper's mirror; the form with
                   causal, segment
                   ids (ragged), GQA and a ragged S at D 64 and 128
                   (INT8_ATTN_CASES), per element with the same gate and
                   control; with PMIX_INT8_ATTN=1, one full-width a8w8
                   UNet forward at the request's size whose 70 int8 calls
                   are each held per element against the plain version on
                   their own inputs, with the same control; then the first
                   a8w8 request, counts set to 0 just before it: all 1,750
                   flash calls on the int8 form, none on bf16 B1, image
                   finite in [0, 1]
 10. llava kernels the SDXL pipeline is freed; each LLaVA kernel (wint8 GEMM,
                   decode attention, RMSNorm) against its plain version at
                   the decode and prefill shapes (RMSNorm also at T5's 77
                   rows, the SD3 path's, and the SFT forward's 4,096; the
                   wint8 GEMM also at a ragged (77, 4112, 4104), each case
                   with its core as B2's), with times and bounds; N1 and N2
                   (csrc/a8w_gemm.cu: the dynamic a8w8 and a8w4 GEMMs) at the
                   wint8 GEMM's shapes and a ragged (77, 4112, 4104), N2's
                   (77, 4128, 4104) (it must refuse 4112 with a message),
                   bit for bit against their plain versions, each with a
                   control that must differ (N1: each row quantized with its
                   neighbour's sx; N2: the nibble halves swapped), with the
                   core, the tile plan held against the library's, ptxas
                   counts (a spill fails), and bf16 torch.matmul, B6 and,
                   above 16 rows, torch._int_mm on x quantized beforehand
                   beside them (it refuses one row: printed); their
                   activation pass alone bit for bit at the prefill's rows;
                   weights, caches and the RMSNorm input rotate through
                   copies that together pass three times the L2 cache, as
                   the model's layers find them cold (up to 64 copies: the
                   1-row RMSNorm's 8 KiB stays warm); decode attention is
                   also run with every length one short, which must fail
                   its limit; each decode case prints its split plan
                   (ops/decode_attention.py key_splits: blocks, waves, the
                   blocks an SM holds; all must be resident at once, a
                   multiple of the SM count) and ptxas counts; RMSNorm
                   (csrc/norms.cu) per element (RMS_SUM) with a control (the
                   plain version without the weight) that must fail, at the
                   path's shapes with the floor (an empty kernel of the
                   plan's launch shape, timed alike) and at a ragged width,
                   a misaligned view, a bf16 weight and fp32 x; the
                   library's plans of RMSNorm, adaLN, fused adaLN + residual
                   and LayerNorm's forward held against the wrappers'
                   mirrors at every path shape and extra case, two launches
                   bit-identical, CUDA-graph replays equal to them and one
                   launch counted a call, at every path shape of the four
 11. llava agree   LLaVA-7B bf16: prefill (608 tokens) + 4 decode steps, the
                   kernels vs their plain versions swapped in
 12. llava serve   1 request as the JAX bench makes it (576 image
                   placeholders + 32 text ids, seeded pixels, 128 new
                   tokens, eos -1): TTFT, decode tokens/s, peak memory, and
                   launches equal to `expected_launches_llava`
 13. quantized     wint8: quantize in place (seconds, bytes freed), then agree
                   and serve again with the wint8 GEMM as well; a8w8 and
                   a8w4: a fresh seeded random_llava(quant=mode) each (the
                   weights' bytes against bf16's), agree (N1 / N2 against
                   their plain versions swapped in as well) and 1 request
                   as in 12, launches as the walk says; wint4: one agree,
                   which must launch N2 and give a8w4's greedy tokens bit
                   for bit
 14. sd3 kernels   LLaVA is freed; adaLN (B12, csrc/norms.cu) and fused adaLN
                   + gated residual (B13, csrc/norms.cu) against their plain
                   versions at the image and context rows, each with a
                   control (the plain version without the shift, or without
                   the gate) that must fail the same limit, both with the
                   floor (B13 also with `copy_` of the residual and x, its
                   kernel and ptxas's registers and spills) and both also
                   at an offset view, fp32 modulation rows and a ragged
                   width;
                   flash at the ragged 4,250-token joint attention, whose
                   control leaves out the 26 keys of the ragged tail; times
                   and bounds as above
 15. sd3 agree     SD3-medium is built; one full-width transformer forward at
                   64x64 latents (1,024 + 154 tokens), kernels vs plain
 16. sd3 serve     3 requests, 1024x1024, 28 steps, guidance 7.0: seconds,
                   image finite in [0, 1], peak memory, and launches of every
                   kernel equal to `expected_launches_sd3` (B1, B4, B11, B12,
                   B13; every other kernel 0)
 17. llama kernels SD3 is freed; int8-cache decode attention (B8) and paged
                   decode attention (B9) against their plain versions at the
                   serving paths' shapes (B8 at 4,095 keys of a 4,096-slot
                   cache; B9 at the paged batch's last step over a permuted,
                   fragmented pool) and at one GQA shape each, gated per
                   element, each with a control that must fail the gate (B8:
                   the plain version without the last 64 keys; B9: without
                   each sequence's last, partly filled block); times, bounds
                   and library times (SDPA over the dequantized or gathered
                   bf16 cache, the dequant or gather not included)
 18. llama int8kv  Llama-2-7B is built with cachekv_int8; agree (prefill of
                   3,968 tokens + 4 decode steps, B8 and B11 vs their plain
                   versions); 1 request of 3,968 prompt tokens and 128 new
                   ones (no eos): TTFT, decode tokens/s, peak memory, cache
                   bytes, launches as `expected_launches_llama` derives them;
                   then the same request over the bf16 KVCache (B7)
 19. llama paged   a batch of 8 right-padded prompts (2,000 down to 130
                   tokens), 128 new tokens each, blocks of 128: agree (B9 and
                   B11 vs plain, and the paged path against the dense cache
                   on the same batch); 1 batch through paged_greedy_generate
                   over a pool of exactly the 67 blocks they need: batch
                   TTFT, aggregate decode tokens/s, peak memory, pool bytes
                   against a dense cache's, launches as derived
 20. train kernels Llama is freed; the lse forward (B15, B1's causal +
                   segments + GQA form), the backward's dkv and dq kernels
                   (B14) and RMSNorm's backward (B11, dx alone as the path
                   runs it, then with dw) against their plain versions at the
                   training path's shapes (2 x 2048 rows, 32 heads x 128,
                   4 segments a row; a GQA shape, 32 on 8 heads; and a ragged
                   (1, 1000, 4, 64)), gated per element, each with controls
                   that must fail (no causal mask; di dropped; a segment
                   boundary one row late; dw of the first pass alone); B14
                   also against its plain versions walked tile by tile with
                   the kernels' skips (`flash_bwd_*_tiled_ref`), with one more
                   control, the tiled walk skipping one tile pair that shares
                   a segment, and two launches held bit-identical; the
                   blocks of each B14 case (csrc/flash_bwd.cu's width table,
                   held against the wrapper's mirror) with ptxas's registers
                   and spills and their shared memory; times, bounds and
                   library times (SDPA and its backward, the backward of
                   F.rms_norm); B1's inference form at the SFT eval's
                   (2, 2048, 32, 128) causal + 4 segments, per element with
                   controls (no causal mask, a boundary one row late)
 21. train agree   Llama-2-7B is built with LoRA factors (b drawn non-zero):
                   one packed 1 x 2048 micro-batch, forward + backward, the
                   kernels vs their plain versions swapped in: the loss and
                   every factor's gradient, the gradients' gap held against
                   that of two plain versions one rounding apart (P rounded
                   to bf16 before P.V or not), and the launches of the kernel
                   run against `expected_launches_train`
 22. train         the factors are taken off; build_trainer + Trainer.train
                   over a seeded dataset: 3 optimizer steps (the second read
                   for a non-zero lora_b, the last under the profiler):
                   seconds a step, tokens/s, model TFLOP/s, busy share, B14's
                   share of the device time, peak memory; every loss and
                   grad_norm finite; launches equal to
                   `expected_launches_train` and no inference kernel launched
 22a. sft io       the factors are taken off again; after a check of the free
                   disk under a temporary directory (removed at the end of
                   22d, whatever happens), save_pretrained writes the model
                   (3 shards of flax-keyed safetensors and the index, by the
                   port's own core/safetensors.py) and AutoModel reads it
                   back onto the card in bf16: seconds and GB/s each way,
                   every tensor bit-equal to the original
 22b. sft main     the model is freed; supervised_finetune.main on that
                   directory over seeded jsonl files (the train phase's
                   samples; a held-out split of 16 samples packed into 4 rows
                   of 4 segments): 24 micro-batches, checkpoints at 10 and
                   20 and the eval's best at 20, rotation to 1, evals at
                   20 and at the end: finite loss and eval loss, the one
                   checkpoint left being 20's, its write and read seconds and
                   GB, the launches of the run equal to the walks
                   (`expected_launches_train` + `expected_launches_eval`)
 22c. sft resume   main again with resume_from_checkpoint at 20 (4 micro-
                   batches into its accumulation window): every LoRA factor,
                   moment, accumulator and counter bit-equal to the first
                   run's state at that step (kept on the host), then trained
                   on to 24; the launches equal to the walks; peak memory
 22d. sft adapter  the saved model is read again and main's adapter attached
                   (load_lora + attach_lora): evaluate over the held-out
                   batches under the profiler (seconds, device ms, busy
                   share, launches equal to `expected_launches_eval`: B1's
                   inference form at (2, 2048, 32, 128) causal + segment ids
                   and B11), its loss and main's against the same evaluate
                   with the kernels' plain versions swapped in (within
                   TRAIN_LOSS_TOL); merge_lora_into_model, its prefill
                   logits over 608 tokens against the attached model's
                   (within LLAMA_AGREE_TOL); `cli merge-lora` on the saved
                   directories, every merged tensor bit-equal to
                   merge_lora_into_model's
 23. clip kernels  Llama is freed; LayerNorm (B10, csrc/norms.cu, with the
                   floor, `copy_` of x, its kernel and ptxas's counts) and
                   its backward against
                   their plain versions at the CLIP path's rows (the vision
                   tower's 50,432 x 768, the text tower's 19,712 x 512, the
                   pooled 256 x 768 as a strided slice) and at the other
                   CLIP-family towers' rows (SDXL's and SD3's text towers 77
                   x 768 and 77 x 1280, LLaVA's ViT 577 x 1024), gated per element,
                   with controls that must fail (the variance without the
                   mean subtracted; dx without its mean(g w) term; dw and db of
                   the first partial sum's rows alone: the plan's first
                   cluster's, or first block's where one cluster takes every
                   row); times, bounds and library
                   times (F.layer_norm and its backward); the forward also
                   at a misaligned view, fp32 x and a ragged width, each
                   with the control; then EVA's sub-LN rows, 50,432 x 2,048
                   (B10's wide form: 64 elements a lane, w in shared memory,
                   one block an SM), and a ragged 1,000 x 1,960 the same way,
                   the backward's kernel and ptxas counts printed, and the
                   wide form's other plans (one cluster at 77 rows, fp32
                   rows, the one-element form, 1,288 wide) forward and
                   backward with the gates, the controls and the plans held
                   against the library's
 24. clip          CLIP ViT-B/16 is built; agree (the logits of one seeded
                   batch of 256, B10 vs plain, held within 1.25x of two plain
                   versions one bf16 rounding apart); 12 timed bench forwards
                   (zero pixels, ids all ones, as bench.py): pairs/s median
                   and spread, model TFLOP/s by the bench's flop count, busy
                   share of a profiled forward, peak memory, 51 B10 launches a
                   forward and no other kernel
 25. clip train  train agree (one batch, kernels vs plain: the loss within
                   10x, the gradients' median over all parameters and their
                   largest gap over the parameters whose gradient stands above
                   the rounding noise within 1.25x of two plain versions one
                   rounding apart; controls that must fail: B10 with its row
                   stride ignored for the loss, B10's dw and db of the first
                   partial sum's rows alone for the gradients),
                   then CLIP_TRAIN_STEPS (6) optimizer steps over
                   2,560 seeded pairs: seconds a step, samples/s, model
                   TFLOP/s (3x the forward's), reader share, busy share of a
                   profiled step, peak memory, finite losses, every parameter
                   moved, 51 B10 and 51 B10-backward launches a step
 26. c9            the four quantizers that divide by a constant
                   (quantize_weights_int8 / _int4 at 4096 -> 11008,
                   _quantize_kv at (1, 608, 32, 128), quantize_weight_per_cout
                   at 640 x 640 x 3 x 3) on the card equal the CPU's calls bit
                   for bit, values and scales; the scalar division they had,
                   a control, must give other scales
 27. eva agree     EVA02-CLIP-B/16 is built (norm affines drawn around 1 / 0);
                   the logits of one seeded batch of 256, B10 vs plain, within
                   1.25x of two plain versions one bf16 rounding apart; 49 + 25
                   B10 launches (4 a block and the pooled norm; 2 a text layer
                   and the final LN)
 28. eva appflow   2 Appflow zero_shot_classification requests, each one
                   generated 640 x 480 jpeg decoded by PIL against 1,000
                   candidate labels: seconds, device ms and busy share of the
                   last (profiled, its kernels by time), peak memory; every
                   label ranked, scores finite and sorted; launches as the
                   walk says
 29. eva eval      a 1,000-class classifier over the 4 default templates (64
                   text forwards), then 256 generated jpegs decoded and
                   preprocessed in 8 threads on CLIPImageProcessor's default
                   path and on its native path (PMIX_NATIVE_PREPROCESS=1, the
                   port's g++ build), encoded and scored: images/s of each,
                   top-1 and top-5 against seeded labels, which must be the
                   same top-1 on both paths; the paths' pixel and feature gaps
                   and their agreement printed
 30. eva train     EVA_TRAIN_STEPS (6) optimizer steps at batch 256 through the Trainer with
                   the recipe's optimizer (layer-decay scales checked at the
                   head, the patch embedding and a block), over 512 seeded
                   pairs: seconds a step, samples/s, busy share and kernels of
                   the profiled step, peak memory, finite losses, every
                   parameter moved, 74 B10 and 74 B10-backward launches a step
 31. clip main     tools/train_clip.main --synthetic with CLIP_STEPS 4 and
                   CLIP_BATCH 64: 256 generated jpegs decoded and
                   preprocessed in the loader's 8 workers, a seeded ViT-B/16
                   trained 4 steps: finite loss, 51 B10 and 51 B10-backward
                   launches a step
 32. sd15 kernels  EVA-CLIP is freed; B4 at SD1.5's GroupNorm shapes that
                   SDXL's lack (20 and 60 channels a group, the 512 px VAE),
                   on channels of their own mean and scale, with a control
                   (the plain version over 16 groups) that must fail; B1 at
                   SD1.5's three self-attention shapes (head_dim 40, 80 and
                   160) and at 256 (1, 1024, 4, 256), and its lse form (B15)
                   at 160 and 256, against their plain versions per
                   element, each with a control (the last key tile left out)
                   that must fail; B1 and B15 at heads 80 and 160 with causal
                   + segment ids + GQA at a ragged S the same way, and each
                   written into a view of a wider sentinel-filled buffer,
                   whose columns past the head must keep the sentinel
 33. sd15 agree    SD1.5 is built; one full-width UNet forward at 64x64
                   latents, kernels (B1 at head_dim 40, 80 and 160, B4) vs
                   plain
 34. sd15          3 requests, 512x512, 50 PNDM steps, guidance 7.5: seconds,
                   busy share of the last (profiled), peak memory, image
                   finite in [0, 1], launches equal to `expected_launches_sd15`
                   (750 B1 a request, 250 of them at head_dim 160; B4; 50 B10)
 35. sd15 train    SD1.5 is freed; B4 with fp32 weight and bias at every
     kernels       GroupNorm shape of the training path, each with the
                   16-group control; the lse forward (B15) and the flash
                   backward's dkv and dq kernels (B14, fed B15's lse and
                   the di of its o) against their plain versions per
                   element (c TRAIN_SUM) at the training path's
                   self-attention shapes (8, 4096, 8, 40), (8, 1024, 8, 80)
                   and (8, 256, 8, 160), at (1, 1024, 4, 256), at heads 32
                   (4, 1024, 8, 32) and 20 (2, 300, 8, 20, padded), and at
                   160, 256, 64 (2, 384, 8 on 2) and 24 (2, 333, 8 on 2)
                   with causal + segment ids + GQA; controls that must
                   fail: the last key tile left out (B15, B14), di dropped
                   (B14); B14 also against its tiled plain versions, with
                   the skipped-pair control where segments are, two
                   launches bit-identical, and the blocks each width runs
                   (both read every head of a multiple of 8 in place, at
                   64, 128, 192 and 256; the library's plans held against
                   the mirrors); times, bounds and library times (SDPA, the
                   backward of SDPA, graph-captured)
 36. sd15 train    the SD1.5 UNet is built (859.5 M fp32 parameters, bf16
     agree         compute); one micro-batch of 2 at 64x64 latents, fixed
                   timesteps and noise: the loss within 10x and the
                   gradients' median over all parameters and largest gap
                   over those above the rounding noise within 1.25x of two
                   plain versions one rounding apart (P rounded to bf16
                   before P.V or not); a control, B14's dK/dV without di,
                   must fail; launches as the walk says
 37. sd15 train    build_trainer + Trainer.train, 5 optimizer steps at batch
                   8 (the last under the profiler): seconds a step,
                   samples/s, model TFLOP/s (`unet_train_flops`, 3x the
                   forward's), reader and busy share, B14's share of the
                   device time, peak memory; finite
                   losses, every parameter moved; launches equal to
                   `expected_launches_sd15_train`: 15 B15, 15 B14 dkv and 15
                   B14 dq a step, 5 of each at head_dim 160, 61 B4, and no
                   other kernel
 38. blip2 kernels the SD1.5 UNet is freed; B10's forward at the BLIP-2 rows
                   (257 x 1,408, 32 x 768, 33 x 2,560 and 1 x 2,560; rows of
                   2,560 are new: the row form at two 16-byte chunks a
                   thread) and B7 at OPT's head_dim 80 (1 x 32 heads over 64
                   slots at length 40, a ragged pair over 96, a caption's last
                   step over 65) against their plain versions per element,
                   each with its control (the variance without the mean; every
                   length one short), with times, bounds, library calls
                   (F.layer_norm; SDPA with a bool mask), the floor and
                   ptxas counts; B10's backward must refuse 2,560 with a
                   message (no library plan either)
 39. blip2 agree   BLIP-2 OPT-2.7B is built (seeded bf16 weights, fp32 norm
                   affines); the prefill's logits (32 query features + BOS)
                   and those of 4 decode steps fed seeded non-BOS ids (the
                   greedy ids of random weights repeat BOS), kernels (B7,
                   B10) vs plain, within a relative L2 of 5e-2; launches as
                   the walk says
 40. blip2 serve   2 caption requests, each a generated 640 x 480 jpeg decoded
                   by PIL and processed by Blip2Processor, then generate over
                   OPT's BOS with 32 new tokens, eos off: seconds a request,
                   TTFT (a 1-token generate), decode tokens/s = 31 / (t32 -
                   TTFT), peak memory; each request's prefill logits over
                   the TTFT run's cache and the full run's must be
                   bit-equal (no dependence on the spare slots); one more
                   request under the profiler: device ms by category and
                   the busy share; every request
                   launches B10 2,190 times and B7 992 times
                   (`expected_launches_blip2`), and no other kernel
 41a. sd15 dir     BLIP-2 is freed; after a check of the free disk under a
                   temporary directory (removed at the end of 41d, whatever
                   happens), the seeded SD1.5 pipeline in fp32 is written in
                   diffusers' own layout (`write_diffusers_dir`: HF keys,
                   (out, in) Linears, OIHW convs, diffusers' config files,
                   model_index.json, PNDM's published scheduler config, the
                   tokenizer's vocab.json and merges.txt; 4.3 GB) and by the
                   port's save_pretrained (flax keys); each is read back by
                   DiffusionPipeline.from_pretrained in fp32, every tensor
                   bit-equal to the pipeline that wrote it: seconds and GB/s
                   each way
 41b. sd15 serve   tools.text_to_image.main on the diffusers directory (read
                   in bf16, 25 PNDM steps, 512 px, guidance 7.5, the PNG
                   written): the PNG finite in [0, 1], launches of B1, B4
                   and B10 as `expected_launches_sd15` walks the pipeline,
                   no other kernel; then a request on the pipeline read by
                   DiffusionPipeline.from_pretrained, unprofiled and
                   profiled: seconds, device ms, busy share, peak memory
 41c. vae encode   B4 per element at the VAE encoder's two new shapes,
                   (1, 256, 256, 128) and (1, 128, 128, 256), with the
                   16-group control; the full SD1.5 encoder in bf16 at 512
                   px, kernels vs plain (relative L2 of the mean and the
                   log-variance within AGREE_TOL), 22 B4 launches and no B1
                   (the 512-wide single head goes to math), its time
 41d. training     B15 and B14 per element at the DreamBooth batches (1 and 2
                   at SD1.5's three self-attention shapes) with their gates
                   and controls; then, on the directory, counts set to 0
                   before each: train_text_to_image.main (DIR_T2I_STEPS
                   steps at batch 8), train_dreambooth_lora.main over
                   DREAMBOOTH_IMAGES generated jpegs (DREAMBOOTH_STEPS steps
                   at batch 1), train_dreambooth.main with as many class
                   jpegs, prior weight 1.0 (DREAMBOOTH_STEPS steps at batch
                   2): finite losses, launches equal to the walks (the
                   encodes' B4, the prompts' B10, the training steps' B15,
                   B14 and B4), seconds a step, peak memory, and one more
                   step under the profiler (device ms, busy share); the
                   adapter read by load_lora (128 pairs, every b moved) and
                   merged by merge_lora_into_model, whose UNet's output agrees
                   with the attached one's within AGREE_TOL; the full run's
                   saved unet/ read back bit-equal to the trained model
 41e. sdxl dir     the seeded SDXL-base pipeline in fp32 (14 GB) written by
                   save_pretrained, cast to bf16 in memory and served one
                   request (1024 px, 25 Euler steps, CFG 5.0, seeded
                   latents); freed; DiffusionPipeline.from_pretrained reads
                   the directory in bf16 and serves the same request: the
                   image bit-equal, finite in [0, 1], the launches as
                   `expected_launches` walks them; the directory removed
 42a. qwen2vl      the SDXL pipeline is freed; B7 at GQA group 7 (Qwen2-7B's
      kernels      28 heads on 4 KV heads of 128: the image request's first
                   and last decode steps over 1,358 slots, a ragged pair,
                   the video request's last step over 2,554), B11 at
                   (1230, 3584) and (1, 3584) (its plan held against the
                   library's), B10 at (4864, 1280) and (9728, 1280), and B1
                   non-causal with segment ids at head_dim 80 at the
                   tower's three layouts ((1, 4864, 16, 80): one image of
                   4,784 patches and 80 pad rows in segment 0; (1, 3328,
                   16, 80): two of 1,564 and 200 pads; (1, 9728, 16, 80):
                   a video of 9,568 and 160 pads; pad rows attend among
                   themselves) against their plain versions per element,
                   each with its control (every length one short; the
                   weight left out; the variance without the mean; every
                   segment boundary one row late), with times, bounds,
                   library calls (SDPA with a bool mask, F.rms_norm,
                   F.layer_norm), ptxas counts (B7 at G 7: no spill)
 42b. qwen2vl dir  Qwen2-VL-7B is built (seeded bf16 weights, fp32 norm
                   affines); after a check of the free disk, written in
                   the published layout by qwen2vl7b.save_published (the
                   published config.json, no text_config: the language
                   model's fields at the top level, rope_scaling's
                   mrope_section, in_chans; the published checkpoint's keys
                   and its 5-D patch-embedding tensor, 5 shards) and by
                   save_pretrained (flax keys), each read back by
                   Qwen2VLForConditionalGeneration.from_pretrained in bf16:
                   the same config and every tensor bit-equal, seconds and
                   GB/s each way; the model served below is the one read
                   from the published layout; the directory removed
 42c. qwen2vl      the image request's prefill logits (1,230 tokens: a
      agree        1280 x 720 jpeg's 1,196 placeholders between the vision
                   start / end ids, 32 seeded text ids) and 4 decode steps
                   at M-RoPE positions max + 1 on, kernels (B1, B10, B11,
                   B7) vs plain, within a relative L2 of 5e-2; launches as
                   `expected_launches_qwen2_vl` walks them, no other kernel
 42d. qwen2vl      1 request of each kind, 128 new tokens, eos off: one
      serve        1280 x 720 jpeg; two 640 x 480 jpegs (782 placeholders in
                   two segments); a video of 16 frames of 640 x 360 (the
                   count smart_nframes picks for 8 s at 30 fps, fps 2;
                   2,392 placeholders; assembled from the processor's
                   functions, one segment); each timed as processor, vision
                   tower, prefill and decode; TTFT (a 1-token generate),
                   decode tokens/s = 127 / (t128 - TTFT), peak memory; the
                   prefill logits over the TTFT run's cache and the full
                   run's bit-equal; launches as walked, no other kernel;
                   one more image request under the profiler: device ms by
                   category and the busy share
 43a. sd3 dir      Qwen2-VL is freed; SD3-medium built in bf16 (seeded,
                   T5's norms fp32); after a check of the free disk under a
                   temporary directory (removed at the end of 43e, whatever
                   happens), written by save_published_sd3 in the published
                   layout and file names (model_index.json, transformer/ and
                   vae/ in diffusers' keys with diffusers' stored position
                   table, the text towers in transformers' keys, T5 in 2
                   shards with their index, the tokenizers, the published
                   scheduler_config.json; ~15.5 GB) and read back by
                   DiffusionPipeline.from_pretrained in bf16 with the seeded
                   T5 tokenizer as tokenizer_3: every tensor of the five
                   models bit-equal, T5's norms fp32; seconds and GB/s each
                   way (warm page cache)
 43b. sd3 serve    tools.text_to_image.main on the directory (read in bf16,
                   25 steps at the pipeline's defaults: 1024 px, guidance
                   7.0; the PNG written; tokenizer_3 passed as a component):
                   the PNG finite, launches equal to `expected_launches_sd3`
                   (B1, B4, B10, B11, B12, B13), no other kernel; then a
                   request on the pipeline read back in 43a, unprofiled and
                   profiled: seconds, device ms, busy share, peak memory;
                   then the training inputs: SD3_TRAIN_IMAGES seeded 1024 px
                   jpegs through the VAE encoder ((mode - shift) * scale, as
                   the pipeline's decode inverts it; B4) and as many prompts
                   through encode_prompt (B10, B11), launches as walked; the
                   pipeline freed
 43c. sd3 train    B15 and B14 per element at (2, 4250, 24, 64), non-causal,
      kernels      the joint attention of a training batch of 2 (4,096 image
                   + 154 context tokens, a ragged 26-key tail), with the
                   TRAIN_SUM gate and the controls (the last key tile left
                   out; di dropped), times, bounds and SDPA's forward and
                   backward; B12 and B13 under autograd at SD3's rows:
                   forward gated (ADALN_SUM, the control without the shift
                   failing) and gradients bit-equal to autograd of the
                   plain versions
 43d. sd3 train    the transformer read from the directory in fp32 masters,
      agree        bf16 compute, gradient checkpointing per block; one
                   flow-match micro-batch of 2 at fixed u and noise, kernels
                   (B15, B14, B12, B13) against two plain versions one
                   rounding apart (the forward's P rounded to bf16 before
                   P.V), held as the earlier training agrees
                   (CLIP_LOSS_RATIO on the loss, TRAIN_AGREE_RATIO on the
                   gradients' median and largest gap; the control, B14's
                   dK/dV without di, must fail); checkpointing keeps the
                   plain attention's (2, 24, 4250, 4250) fp32 logits to one
                   block at a time; launches as
                   `expected_launches_sd3_train` walks them (each block's
                   forward kernels twice)
 43e. sd3 train    sd3_trainer (AdamW at lr 1e-5, train_text_to_image's
                   arguments) for SD3_TRAIN_STEPS steps at batch 2 over the
                   encoded samples, the last under the profiler: seconds a
                   step, busy share, B14's share, peak memory, the bytes of
                   the masters and AdamW state, finite losses, every
                   parameter moved, launches as walked
 44a. control dir  SD3 is freed; SD1.5 (seeded, fp32) with a seeded ControlNet
                   and a seeded full adapter, every weight drawn (the
                   ControlNet's zero-initialised convs too, so no residual is
                   zero); after a check of the free disk under a temporary
                   directory (removed at the end of 44f, whatever happens),
                   StableDiffusionControlNetPipeline (UniPC) and
                   StableDiffusionAdapterPipeline (DDIM) written by
                   save_pretrained (model_index.json with `controlnet` /
                   `adapter`) and read back by DiffusionPipeline.from_pretrained
                   in fp32: 0 tensors differing, seconds and GB/s each way
 44b. control      the ControlNet directory read in bf16; agree: one
                   ControlNet + UNet forward at 64x64 latents, batch 2,
                   kernels vs plain (AGREE_TOL), the control (the UNet
                   without the ControlNet's residuals) must fail it, 21 B1
                   (7 at each head_dim 40, 80, 160) and the two models' B4;
                   each model's device ms of a step's forward (the
                   ControlNet's share); 1 request on a 512 px edge map that
                   numpy makes from smooth jpegs, 20 UniPC steps, CFG 7.5,
                   and one more under the profiler: seconds, busy share,
                   peak memory, image finite in [0, 1], launches equal to
                   `expected_launches_controlnet`
 44c. adapter      the adapter directory read in bf16; agree (the control:
                   the UNet without the adapter's features) and 1 + 1
                   requests the same way, 25 DDIM steps, launches equal to
                   `expected_launches_sd15` (the adapter launches no kernel)
 44d. control      B15 and B14 per element at the ControlNet trainer's batch
      train        4 and the adapter trainer's batch 2 at SD1.5's three
      kernels      self-attention shapes, with their gates and controls
 44e. control      the ControlNet trainer's loss at full width (one
      train        micro-batch of 2, fixed t and noise; the frozen UNet's
                   down blocks run B1, its mid and up blocks B15 / B14)
                   against two plain versions one rounding apart, as sd15
                   train agree (the control: B14's dK/dV without di), then
                   train_controlnet.main on the directory (CONTROL_TRAIN_STEPS
                   steps at batch 4, the example's 256 samples) and a
                   profiled step; the adapter trainer's step the same way,
                   then train_t2i_adapter.main --pretrained DIR --resolution
                   512 (ADAPTER_TRAIN_STEPS steps at batch 2), its saved
                   adapter read back bit-equal: seconds a step, busy share,
                   peak memory, finite losses, launches as walked
 44f. sd15         the SD1.5 UNet trainer's micro-batch of 8 (fixed t and
      checkpointing noise) with gradient_checkpointing off and on: the loss
                   bit-equal, the gradients within the gate of two plain
                   versions one rounding apart, the peak memory lower (both
                   printed), launches as walked (each block's B15 and B4
                   twice); then build_trainer + Trainer.train with it on,
                   GC_TRAIN_STEPS steps
 45a. dit dir      SD1.5's models are freed; DiT-XL/2-256 (every weight drawn,
                   the adaLN-zero Linears too, so no gate is zero) and the SD
                   VAE built seeded in bf16; after a check of the free disk
                   under a temporary directory (removed at the end of 45e,
                   whatever happens), DiTPipeline written by save_pretrained
                   with DDIM's scheduler config and with DPM-Solver++'s, each
                   read back by DiffusionPipeline.from_pretrained in bf16: 0
                   tensors differing, the scheduler classes, seconds each way
 45b. dit serve    agree: one full-width DiT forward at the CFG batch of 16
                   (8 labels and the null class), kernels (B1, B12) vs plain
                   (AGREE_TOL), two controls that must fail (adaLN without
                   the shift; attention without the last 128 keys), launches
                   as walked; a request of 8 labels, CFG 4.0, 25 DDIM steps,
                   and one more under the profiler: seconds, device ms by
                   kernel, busy share, peak memory, images finite in [0, 1],
                   launches equal to `expected_launches_dit` (57 B12 and 28
                   B1 at (16, 256, 16, 72) a step, the VAE's 30 B4); the
                   same request under DPM-Solver++
 45c. dit kernels  B1 at (16, 256, 16, 72), (2, 1024, 16, 72) and (2, 4096,
                   16, 72) on q / k / v that are strided views of one fused
                   projection (read in place); B15 and B14 at the training
                   batch (16, 256, 16, 72); B12 at DiT's rows (16, 256,
                   1152); B11 at T5's caption rows (120, 4096); B4 at the
                   VAE decode of 8 latents: each per element against its
                   plain version with its control, times, bounds and library
                   calls (SDPA and its backward; F.layer_norm then the
                   modulation; F.rms_norm; F.group_norm + F.silu)
 45d. dit train    agree: a micro-batch of 16 of the trainer's loss at fixed
                   t and noise through the full-width DiT (fp32 masters,
                   bf16 compute, gradient checkpointing per block), kernels
                   (B15, B14, B12) against two plain versions one rounding
                   apart (the control: B14's dK/dV without di), launches as
                   walked; then tools.train_dit.main at its batch of 16 with
                   gradient checkpointing (a config directory), cut to
                   DIT_TRAIN_STEPS steps, and a profiled step: seconds a
                   step, busy share, peak memory, finite losses, the
                   adaLN-zero Linears moved, launches as walked
 45e. pixart       PixArt-XL-2-512x512, T5 v1.1-XXL and the SD VAE built
                   seeded in bf16 on the card; agree: T5 over the negative
                   prompt and the prompt (2 x 120 tokens, 98 B11 calls),
                   kernels vs plain (AGREE_TOL; the plain version summing in
                   fp64 shows the rounding floor), the control the mean |x|
                   for the root mean square; then on that context one
                   full-width transformer forward at the CFG batch of 2: each
                   of its 28 B1 calls per element against its plain version
                   on its own inputs (control: the last 128 keys left out),
                   and its output, kernels vs plain (AGREE_TOL), with two
                   controls that must fail (v of the next head; k and v of
                   the other CFG row) and two faults printed that the output
                   is too coarse to show (the last 128 keys left out, the
                   softmax scale of D 128); a 20-step DPM-Solver++ request at CFG 4.5, 512
                   px, and one more under the profiler: seconds split into T5
                   encode, denoise and decode, busy share, peak memory,
                   images finite in [0, 1], launches equal to
                   `expected_launches_pixart`; last, the witness of T5's
                   seeded init: the T5 agree again with q and the
                   relative-position tables redrawn at the fan-in rule
 46a. internvl2    the DiT / PixArt models are freed; B1 at InternViT's (1,
      kernels      1025, 16, 64) and (13, 1025, 16, 64) on q / k / v that
                   are global-thirds views of one projection (read in place),
                   B10's forward at the tower's 1,024-wide rows (1,025 and
                   13,325) and the projector's 4,096-wide ones (256 and
                   3,328: the width new in this slice, its plans held
                   against the library's), B7 at G 4 over 3,489 keys, each
                   per element against its plain version with its control
                   (the last key tile left out; the variance without the
                   mean; every length one short), with times, bounds and
                   library calls (SDPA on the same views, F.layer_norm)
 46b. internvl2    InternVL2-8B is built (seeded bf16 weights, fp32 norms);
      dir          after a check of the free disk, written by
                   save_pretrained into a temporary directory and read back
                   by AutoModel.from_pretrained in bf16: the same config and
                   0 tensors differing, seconds and GB/s each way (warm page
                   cache); the model read back is served, the directory
                   removed
 46c. internvl2    the 12-tile request's prefill logits (13 tiles: 3,328
      agree        image tokens, 3,362 ids) and 4 decode steps fed seeded
                   ids, kernels (B1, B10, B11, B7) vs plain, within
                   AGREE_TOL; launches as `expected_launches_internvl2`
                   walks them
 46d. internvl2    3 requests of 128 new tokens, eos off, each a seeded jpeg
      serve        decoded and tiled, the padded stack and its mask handed
                   to generate (the tower runs the real tiles alone): a 448
                   x 448 image (1 tile), a 1024 x 768 one (12 tiles and a
                   thumbnail), the same through MiniMonkey's tiling (max 7:
                   9 tiles); each timed as processor, tower, prefill and
                   decode, TTFT (a 1-token generate), decode tokens/s = 127
                   / (t128 - TTFT), peak memory, launches as walked; one more
                   1-tile request under the profiler: device ms by category,
                   busy share
 47a. qwenvl       InternVL2 is freed; B1 at ViT-bigG's (1 and 2, 1024, 16,
      kernels      104) on per-head views of one projection (head 104 read in
                   place on the D 128 core) and the Resampler's 256 queries
                   over 1,024 keys (32 x 128), B10's forward at the trunk's
                   1,664-wide rows and the Resampler's 4,096-wide ones, B7 at
                   G 1 over the long request's 2,288 keys, with controls,
                   times, bounds and library calls as 46a
 47b. qwenvl dir   Qwen-VL-Chat is built and written and read back as 46b
 47c. qwenvl       the two-image request's prefill logits and 4 decode steps,
      agree        kernels vs plain, within AGREE_TOL; launches as walked
 47d. qwenvl       3 requests of 128 new tokens as 46d: one 640 x 480 jpeg,
      serve        two ("Picture 1 / 2"), and one image before 1,900 text ids,
                   whose positions pass seq_length 2,048: NTK alpha 3 for its
                   context (`set_ntk_alpha`; 1 for the others) and a logn
                   scale above 1 past position 2,047, printed; one more
                   image request under the profiler

Every section of main prints its host seconds as it ends ([phase] lines),
and a summary line gathers them.

Any failed check exits non-zero. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero before printing any result. The line
before the last is the card's `nvidia-smi` name and power limit, the one
before that a JSON summary of the kernels, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage: python3 chip_smoke.py
"""

import collections
import contextlib
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
HEIGHT = WIDTH = 1024
STEPS = 25
GUIDANCE = 5.0
# two requests a mode (three until the DiT and PixArt phases needed the time)
REQUESTS = [("a photograph of an astronaut riding a horse on the moon", 1),
            ("a watercolor painting of a lighthouse at dawn", 2)]
# B1 at the SDXL self-attention shapes, a ragged 1,000, and 77 + 64 = 141 rows,
# a multiple of no tile of either core (the wgmma core's TMA edge: zero fill
# past S, one partial tile of keys and of queries)
FLASH_SHAPES = [(2, 4096, 10, 64), (2, 1024, 20, 64), (1, 1000, 4, 64), (1, 141, 4, 64)]
GN_CASES = [((2, 128, 128, 320), "silu"), ((2, 64, 64, 960), "silu"),
            ((2, 32, 32, 1280), "none"), ((1, 1024, 1024, 256), "silu"),
            ((1, 1024, 1024, 128), "silu")]
# (M, K, N) of the int8 GEMM: GEGLU proj at 64x64 and 32x32, ff out at 32x32, attn2 k/v,
# and the 32x32 attention projections (the most B2 time of an a8w8 request)
GEMM_SHAPES = [(8192, 640, 5120), (2048, 1280, 10240), (2048, 5120, 1280), (154, 2048, 1280),
               (2048, 1280, 1280)]
# and a ragged one: M no multiple of the 128-row tile, N = 8 mod 16 (so the
# last pair of column tiles has its second past the edge), K no multiple of
# the 64-deep stage
GEMM_RAGGED = (1000, 1296, 1288)
# (B, H, W, C) of the int8 3x3 conv (C -> C): the UNet's and the VAE's up-sample convs
CONV_SHAPES = [(2, 64, 64, 1280), (2, 128, 128, 640), (1, 512, 512, 512), (1, 1024, 1024, 256)]
# (B, H, W, C, O) of a ragged one: W no power of two, B*H*W no multiple of the
# 128-pixel tile, C no multiple of the 64-channel stage, O = 8 mod 16
CONV_RAGGED = (1, 50, 100, 80, 200)
# ((B, H, W, C), O, epilogue) of the fused resnet conv: the UNet's at each
# resolution (1280 at 32x32, 320 at 128x128 and 640 at 64x64 carry the most
# B5 time), and the VAE's widest map
FUSED_CASES = [((2, 128, 128, 320), 320, None), ((2, 32, 32, 2560), 1280, "temb"),
               ((2, 32, 32, 1280), 1280, "residual"), ((2, 64, 64, 640), 640, "residual"),
               ((1, 1024, 1024, 128), 128, None)]
FUSED_RAGGED = ((1, 50, 100, 96), 200, "residual")  # as CONV_RAGGED (C divisible by 32 groups)
# B4 at a ragged map: 5,000 rows, 96 channels (3 a group, 24-channel slabs)
GN_RAGGED = (1, 50, 100, 96)
# B1: bf16 P and output against the fp32 plain version, per element:
# |out - ref| <= 2**-7 |ref| (the output's rounding) + FLASH_SUM |ref|max (P's
# rounding); the run prints the least c each shape needs. The plain version
# over all keys but the last tile's (the ragged tail of 26 keys at SD3's
# 4,250) must fail it (the control).
FLASH_ULP, FLASH_SUM = 2.0 ** -7, 4e-3
GN_TOL = 3e-2     # absolute: bf16 output rounding (half an ulp is 1.6e-2 below 8)
# B4's statistics (group_norm_stats): fp32 sums in another order than the
# plain version's, so |mean - ref| * rstd_ref and |rstd / rstd_ref - 1| are
# held within GN_STATS_TOL; the control, rstd from E[x^2] with the mean not
# subtracted, must fail it (the inputs' channels have their own offsets)
GN_STATS_TOL = 1e-4
# B2, B3, B5: the int32 sums are exact on both sides and the kernels round
# every fp32 step (affine, SiLU, quantize, dequant, epilogue) as the plain
# versions do, so they are bit-exact; the limit allows one bf16 rounding apart
# per element, |out - ref| <= 2**-7 * |ref| (see bf16_ulps). A plain version
# that skips its activation quantize must fail it (the control).
INT8_ULPS = 1.0
AGREE_TOL = 5e-2  # relative L2 of the full-width UNet output, kernels vs plain, bf16
A8W8_AGREE_TOL = 1e-3  # the same with B2/B3/B5 vs plain: bit-exact kernels read 0

# LLaVA-1.5-7B. (M, K, N) of the wint8 GEMM: decode q/k/v/o, gate/up, down,
# lm_head; prefill (608 prompt tokens) gate/up, down
WINT8_SHAPES = [(1, 4096, 4096), (1, 4096, 11008), (1, 11008, 4096), (1, 4096, 32000),
                (608, 4096, 11008), (608, 11008, 4096)]
WINT8_RAGGED = (77, 4112, 4104)  # the tiled path's ragged case, as GEMM_RAGGED
# N1 / N2 (csrc/a8w_gemm.cu), LLaVA's a8w8 / a8w4 projections at the same
# (M, K, N) as B6; each kernel is bit-exact against its plain version (exact
# int32 sums, every fp32 step rounded alike), so the gate is 0 elements apart.
# The ragged cases: M no multiple of a tile, N = 8 mod 16, K no multiple of a
# stage; N2's packed rows need K % 32 == 0 (16-byte rows of K / 2 bytes), so
# its ragged K is 4128, and it must refuse N1's 4112 with a message.
A8W_SHAPES = WINT8_SHAPES
A8W_RAGGED = {"a8w8": (77, 4112, 4104), "a8w4": (77, 4128, 4104)}
LLAVA_QUANT_MODES = ("a8w8", "a8w4")  # phase 13 builds a fresh LLaVA-7B for each
# (B, Hq, KVH, D, L, lengths) of decode attention: Llama-7B's first decode step
# over the bench's 736-slot cache, a long GQA cache, and the last step of the
# Llama-2-7B request over the bf16 cache (B8's shape, for comparison)
DECODE_CASES = [(1, 32, 32, 128, 736, (609,)), (2, 32, 8, 128, 4096, (4000, 1500)),
                (1, 32, 32, 128, 4096, (4095,))]
# (rows, width) of B11's forward: the LLaVA prefill, the decode row, T5's rows,
# the SFT forward's rows
RMS_SHAPES = [(608, 4096), (1, 4096), (77, 4096), (4096, 4096)]
# B11 beyond the path's bf16 rows and fp32 weight, each with the gate and the
# control: ((rows, width), x dtype, weight dtype, x one element past a
# 16-byte boundary): a ragged width and a misaligned view (both the
# one-element form), a bf16 weight, fp32 x
RMS_EXTRA_CASES = [((37, 4100), "bf16", "fp32", False), ((33, 4096), "bf16", "fp32", True),
                   ((608, 4096), "bf16", "bf16", False), ((77, 4096), "fp32", "fp32", False)]
# B6: fp32 sums of exact products in another order than the plain version's,
# then one bf16 rounding each: |out - ref| <= 2**-7 |ref| + 1e-5 |ref|max
WINT8_ULP, WINT8_SUM = 2.0 ** -7, 1e-5
# B7: bf16 P and output against the fp32 plain version, per element:
# |out - ref| <= 2**-7 |ref| (the output's rounding) + 4e-3 |ref|max (P's
# rounding). The same kernel run with every length one short, which drops the
# current key, must fail it (the control).
DECODE_ULP, DECODE_SUM = 2.0 ** -7, 4e-3
# B11's forward: fp32 sums in another order than the plain version's, then one
# rounding: |out - ref| <= 2**-7 |ref| + RMS_SUM |ref|max; the plain version
# without the weight must fail it (the control)
RMS_SUM = 1e-6
# relative L2 of the full-width LLaVA logits, kernels vs plain, prefill and
# decode steps apart (bf16)
LLAVA_AGREE_TOL = 5e-2
LLAVA_AGREE_STEPS = 4
LLAVA_NEW_TOKENS = 128
LLAVA_REQUESTS = [1]  # pixel seeds: one request a mode (three until the DiT and PixArt phases)
# SD3-medium: 1024 px, 28 FlowMatch steps, guidance 7.0 (CFG batch 2), the
# seeded T5 stand-in tokenizer
SD3_STEPS = 28
SD3_GUIDANCE = 7.0
SD3_REQUESTS = [("a photograph of an astronaut riding a horse on the moon", 0),
                ("a watercolor painting of a lighthouse at dawn", 1),
                ("a bowl of ramen on a wooden table, studio lighting", 2)]
SD3_T5_SEED = 0
# (B, S, H) of B12/B13: the image stream (4096 tokens) and the context stream
# (77 CLIP + 77 T5 tokens), CFG batch 2, hidden 1536
ADALN_SHAPES = [(2, 4096, 1536), (2, 154, 1536)]
# B12 and B13 beyond the path's aligned bf16 rows, each with the gate and the
# control (the plain version without the shift, or without the gate):
# ((B, S, H), modulation dtype, x one element past a 16-byte boundary): an
# offset view (the one-element form), fp32 modulation rows, a ragged width
ADALN_EXTRA_CASES = [((2, 154, 1536), "bf16", True), ((2, 4096, 1536), "fp32", False),
                     ((3, 50, 100), "bf16", False)]
SD3_FLASH_SHAPE = (2, 4250, 24, 64)  # the joint attention: 4096 + 154 tokens, ragged
# B12/B13: fp32 sums in another order than the plain version's, then one bf16
# rounding each: |out - ref| <= 2**-7 |ref| + ADALN_SUM |ref|max. The first
# run on an H100 needed at most 5.4e-9 |ref|max beyond one bf16 rounding; the
# plain version without the shift (B12) or the gate (B13) must fail it (the
# control).
ADALN_SUM = 1e-6
# Llama-2-7B serving. B8: (B, Hq, KVH, D, L, lengths), the int8 path's last
# decode step (4,095 keys of the 4,096-slot cache) and a GQA cache. B9:
# (B, H, KVH, D, bs, lengths), the paged batch's last step (each prompt + 127
# keys) and a GQA batch with ragged lengths (one of one key, one on a block
# edge)
INT8_DECODE_CASES = [(1, 32, 32, 128, 4096, (4095,)), (2, 32, 8, 128, 4096, (4000, 1500))]
PAGED_CASES = [(8, 32, 32, 128, 128, None), (4, 32, 8, 128, 128, (3000, 1, 700, 2048))]
# B8 and B9 keep P in fp32, so they differ from their fp32 plain versions by
# summation order and the output's bf16 rounding: |k - p| <= 2**-7 |p| +
# c |p|max. A first run on an H100 needed at most -9.0e-7 (B8; the rounding
# alone covers it) and 4.0e-8 (B9) |p|max beyond the rounding.
INT8_DECODE_SUM, PAGED_SUM = 1e-5, 1e-6
LLAMA_AGREE_TOL = 5e-2  # relative L2 of the full-width Llama logits, kernels vs plain
LLAMA_AGREE_STEPS = 4  # decode steps after the prefill in the Llama agree checks
LLAMA_REQUESTS = [1]  # prompt seeds (one: the whole run stays inside its 1,200 s)
# B1's int8 QK^T form (PMIX_INT8_ATTN=1) on the SDXL a8w8 request, and
# per element at the SDXL and SD1.5 self-attention shapes. The kernel's scores
# equal its plain version's bit for bit; the rest differs by P's rounding, as
# bf16 B1 does, so the gate is B1's: 2**-7 |ref| + INT8_ATTN_SUM |ref|max. The
# control quantizes by truncation in place of round-half-even and must fail.
INT8_ATTN_SUM = 4e-3
# The same gate on the 70 int8 calls of a full-width a8w8 UNet forward, on
# each call's own q / k / v: a first H100 run needed at most 1.21e-4 there,
# the truncation control 7.6e-6 to 9.0e-3 a call
# (tools/probe_torch_int8_attn_agree.py); a forward fails if any call does.
INT8_ATTN_PATH_SUM = 5e-4
INT8_ATTN_SHAPES = [(2, 4096, 10, 64), (2, 1024, 20, 64), (2, 4096, 8, 40), (2, 1024, 8, 80),
                    (2, 256, 8, 160)]
# B1's int8 form on the wgmma core with its options, per element with the
# same gate and control: (B, S, Hq, Hkv, D, causal, segments). A ragged S (a
# multiple of no tile), D 128, causal + GQA, causal + segment ids cut off every
# tile + GQA at a ragged S, and segment ids at a ragged S without causal; the
# segments of batch row i cut 11 i rows later than row 0's
INT8_ATTN_CASES = [(1, 1000, 4, 4, 64, False, False), (2, 1024, 8, 8, 128, False, False),
                   (2, 2048, 16, 4, 128, True, False), (2, 1000, 8, 2, 64, True, True),
                   (1, 777, 4, 2, 128, False, True)]
# SD1.5-512 (runwayml/stable-diffusion-v1-5 = the JAX package's single-file
# configs): 512 px, 50 PNDM steps, guidance 7.5 (CFG batch 2), the JAX
# pipeline's defaults. B1 at head_dim 160 (SD1.5's 1280-wide blocks over 256
# tokens) and 256 (no path model has it) per element, with B15 at both widths.
SD15_SIZE = 512
SD15_STEPS = 50
SD15_GUIDANCE = 7.5
SD15_REQUESTS = REQUESTS
# B1 at the three self-attention shapes of a request (the heads 40, 80 and
# 160 read in place by the D = 64, 128 and 192 instantiations) and at 256
SD15_FLASH_SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (1, 1024, 4, 256)]
# B1 and B15 at SD1.5's heads 80 and 160 with causal + segment ids (cut off
# every tile) + GQA at a ragged S: (B, S, Hq, Hkv, D). Each also writes into
# a view of a buffer SENTINEL_COLS columns wider, filled with SENTINEL, whose
# columns past the head must keep it
SD15_FLASH_MASKED_CASES = [(2, 1000, 8, 2, 80), (2, 333, 8, 2, 160)]
SENTINEL, SENTINEL_COLS = -3.5, 64
# heads the forward's width table routes, read in place or padded, at each
# compiled width and its edges; the library's plan for each, both forms,
# is held against the wrapper's mirror
FWD_TABLE_HEADS = (8, 32, 40, 64, 72, 80, 96, 100, 128, 136, 160, 192, 200, 256)
# B4 at SD1.5's shapes that GN_CASES (SDXL's) lacks: 20 and 60 channels a
# group in the UNet, the 512 px VAE decoder's; "none" before the transformer
# blocks' projections and the VAE's mid attention
SD15_GN_CASES = [((2, 32, 32, 640), "silu"), ((2, 8, 8, 1280), "silu"),
                 ((2, 16, 16, 1920), "silu"), ((2, 64, 64, 320), "none"),
                 ((1, 64, 64, 512), "none"), ((1, 256, 256, 256), "silu"),
                 ((1, 512, 512, 128), "silu")]
# SD1.5 UNet fine-tuning (examples/train_text_to_image.py): batches of 8 at
# 64x64 latents. B15 and B14 per element with their gate (TRAIN_SUM) at the
# path's three self-attention shapes (both read head_dim 40, 80 and 160 in
# place at D = 64, 128 and 192), at 256, and at 160 and 256 with causal +
# segment ids + GQA, which no path runs and which are compiled all the same;
# causal + segments + GQA at D = 64 (its ragged tiles: 384 rows are three
# 128-row query blocks, segment cuts off every tile); and heads of 32 or less
# at D = 64: 32 and 24 read in place (24 with causal + segments + GQA at a
# ragged S), 20 padded. (B, S, Hq, Hkv, D, causal with segments)
SD15_TRAIN_FLASH_CASES = [(8, 4096, 8, 8, 40, False), (8, 1024, 8, 8, 80, False),
                          (8, 256, 8, 8, 160, False), (1, 1024, 4, 4, 256, False),
                          (2, 512, 8, 2, 160, True), (1, 512, 4, 2, 256, True),
                          (2, 384, 8, 2, 64, True), (4, 1024, 8, 8, 32, False),
                          (2, 333, 8, 2, 24, True), (2, 300, 8, 8, 20, False)]
# B4 at every (shape, act) of the SD1.5 training path at batch 8: fp32
# weight and bias (the masters) beside bf16 rows, a specialization of its own
SD15_TRAIN_GN_CASES = [((8, 64, 64, c), "silu") for c in (320, 640, 960)] + \
    [((8, 32, 32, c), "silu") for c in (320, 640, 960, 1280, 1920)] + \
    [((8, 16, 16, c), "silu") for c in (640, 1280, 1920, 2560)] + \
    [((8, 8, 8, c), "silu") for c in (1280, 2560)] + \
    [((8, hw, hw, c), "none") for hw, c in ((64, 320), (32, 640), (16, 1280), (8, 1280))]
SD15_TRAIN_BATCH = 8
# optimizer steps of build_trainer -> Trainer.train (8 until the InternVL2 and Qwen-VL phases)
SD15_TRAIN_STEPS = 5
SD15_TRAIN_SAMPLES = 256  # the example's data
# sd15 train agree: one micro-batch of 2 at 64x64 latents with fixed
# timesteps and noise, held as CLIP's train agree is (CLIP_LOSS_RATIO,
# TRAIN_AGREE_RATIO, CLIP_SIGNAL_GAP)
SD15_AGREE_BATCH = 2
SD15_AGREE_T = (250, 750)
# The SD1.5 diffusers directory (phases 41a-41d): the published
# runwayml/stable-diffusion-v1-5 layout written from the seeded fp32 pipeline
# (HF keys and layouts, diffusers' config files, PNDM's published
# scheduler_config.json with steps_offset 1), then the JAX examples run on it:
# text_to_image (25 steps at 512 px, its own), train_text_to_image cut from
# 1,000 steps to DIR_T2I_STEPS, both DreamBooth mains cut from 500 and 800
# steps to DREAMBOOTH_STEPS over DREAMBOOTH_IMAGES generated jpegs (the
# instance and, for the full one, the class images); after each training
# main, one more step under the profiler
SD15_DIR_PROMPT = "a photograph of an astronaut riding a horse on the moon"
SD15_DIR_SCHEDULER = dict(_class_name="PNDMScheduler", _diffusers_version="0.6.0",
                          beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                          num_train_timesteps=1000, set_alpha_to_one=False, skip_prk_steps=True,
                          steps_offset=1, trained_betas=None, clip_sample=False)
DIR_T2I_STEPS = 2  # 4, and DREAMBOOTH_STEPS 8, until the InternVL2 and Qwen-VL phases
DREAMBOOTH_STEPS = 4
DREAMBOOTH_IMAGES = 4
DREAMBOOTH_PROMPTS = ("a photo of sks dog", "a photo of a dog")
# B4 at the VAE encoder's shapes at 512 px that no decoder has: the first
# resnet of the second and third down blocks (after each down-sample)
VAE_ENCODE_GN_CASES = [((1, 256, 256, 128), "silu"), ((1, 128, 128, 256), "silu")]
# B15 / B14 at the DreamBooth batches: 1 (LoRA) and 2 (full), SD1.5's heads
DREAMBOOTH_FLASH_CASES = [(b_, s_, 8, 8, d_, False) for b_ in (1, 2)
                          for s_, d_ in ((4096, 40), (1024, 80), (256, 160))]
# The SDXL directory (phase 41e): the seeded fp32 SDXL-base pipeline written by
# DiffusionPipeline.save_pretrained, read back in bf16, one request at the
# flagship's settings (1024 px, 25 Euler steps, CFG 5.0)
SDXL_DIR_SEED = 5
# Qwen2-VL-7B serving (Qwen/Qwen2-VL-7B-Instruct, models/qwen2_vl/qwen2vl7b.py),
# batch 1, 128 new tokens, eos off. The requests' jpegs: an image of 1280 x
# 720 (smart_resize: 728 x 1288, 4,784 patches, 1,196 placeholders, 4,864
# packed rows), two of 640 x 480 (476 x 644 each: 1,564 patches, 391
# placeholders; 3,328 rows), and a video of 16 frames of 640 x 360 (an 8 s
# clip at 30 fps sampled at fps 2; 364 x 644 each: 8 temporal groups of 1,196
# patches, 2,392 placeholders; 9,728 rows)
QWEN2VL_IMAGE = (720, 1280)
QWEN2VL_PAIR = (480, 640)
QWEN2VL_FRAME, QWEN2VL_CLIP_SECONDS, QWEN2VL_CLIP_FPS = (360, 640), 8, 30.0
QWEN2VL_REQUESTS = 1     # requests of each kind (one: the whole run stays inside its 1,200 s)
QWEN2VL_AGREE_STEPS = 4  # decode steps after the prefill in the agree
# B7 at G 7, (B, Hq, KVH, D, L, lengths): the image request's first and last
# decode steps (1,230-token prompt, 1,358 slots), a ragged pair, the video
# request's last step (2,426 + 127 keys)
QWEN2VL_DECODE_CASES = [(1, 28, 4, 128, 1358, (1231,)), (1, 28, 4, 128, 1358, (1357,)),
                        (2, 28, 4, 128, 1358, (1300, 611)), (1, 28, 4, 128, 2554, (2553,))]
QWEN2VL_RMS_SHAPES = [(1230, 3584), (1, 3584)]  # the image prefill's rows, a decode row
QWEN2VL_LN_SHAPES = [(4864, 1280, 1), (9728, 1280, 1)]  # the tower's rows, image and video
# B1 in the tower: (packed rows, the segments' lengths); the rest are pads, segment 0
QWEN2VL_FLASH_LAYOUTS = [(4864, (4784,)), (3328, (1564, 1564)), (9728, (9568,))]
# SD3-medium's directory and its training (phases 43a-43e): the published
# stabilityai/stable-diffusion-3-medium-diffusers layout written from the
# seeded bf16 pipeline (diffusers' and transformers' keys, T5 in shards) and
# read back; tools.text_to_image.main on it (25 steps at the pipeline's
# defaults: 1024 px, guidance 7.0); then flow-match fine-tuning of the
# transformer (fp32 masters, bf16 compute, gradient checkpointing per block)
# through sd3_trainer (train_text_to_image's arguments: AdamW at lr 1e-5) for
# SD3_TRAIN_STEPS steps of SD3_TRAIN_BATCH over SD3_TRAIN_IMAGES seeded 1024 px
# jpegs and as many prompts. B15 / B14 at the joint attention's training
# shape: (B, S, Hq, Hkv, D, causal with segments), 4,096 + 154 tokens, a
# ragged 26-key tail
SD3_TRAIN_FLASH_CASES = [(2, 4250, 24, 24, 64, False)]
SD3_TRAIN_IMAGES = 4
SD3_TRAIN_PROMPTS = tuple(p for p, _ in SD3_REQUESTS) + ("a red bicycle leaning on a brick wall",)
SD3_TRAIN_BATCH = 2
SD3_TRAIN_STEPS = 5  # 10 until the InternVL2 and Qwen-VL phases
SD3_AGREE_U = (0.3, 0.8)  # the train agree's fixed draws of u (sigma 0.5625, 0.9231)
# SD1.5 under a ControlNet and a T2I-Adapter (phases 44a-44f): SD1.5-512 with
# lllyasviel/sd-controlnet-canny's ControlNet (UniPC, CONTROL_STEPS steps: the
# request of diffusers' ControlNet guide) and a full adapter at
# TencentARC/t2iadapter_canny_sd15v2's widths with 3 input channels (DDIM,
# ADAPTER_STEPS steps), CFG 7.5, 512 px edge maps made from smooth jpegs; the
# trainers of examples/train_controlnet.py (batch 4 over the example's 256
# samples) and examples/train_t2i_adapter.py (batch 2 at --resolution 512),
# each cut to a few steps; and the SD1.5 UNet trainer at batch 8 with
# gradient checkpointing. B15 / B14 at the trainers' self-attention shapes
CONTROL_REQUESTS = [("a bird perched on a branch, high detail", 11)]  # one, and it again profiled
CONTROL_STEPS = 20
ADAPTER_STEPS = 25  # 50 until the InternVL2 and Qwen-VL phases
# the trainers' steps (4, 4 and 3 until the InternVL2 and Qwen-VL phases)
CONTROL_TRAIN_BATCH, CONTROL_TRAIN_STEPS = 4, 2
ADAPTER_TRAIN_BATCH, ADAPTER_TRAIN_STEPS = 2, 2
GC_TRAIN_STEPS = 2
CONTROL_TRAIN_FLASH_CASES = [(b_, s_, 8, 8, d_, False) for b_ in (CONTROL_TRAIN_BATCH,
                                                                 ADAPTER_TRAIN_BATCH)
                             for s_, d_ in ((4096, 40), (1024, 80), (256, 160))]
# B4 at the ControlNet trainer's batch 4 (the UNet's and the ControlNet's maps,
# fp32 weights) and at the adapter trainer's VAE encoder, batch 2 at 512 px
# (bf16 weights)
CONTROL_TRAIN_GN_CASES = [((CONTROL_TRAIN_BATCH,) + shape[1:], act, "fp32")
                          for shape, act in SD15_TRAIN_GN_CASES] + \
    [((ADAPTER_TRAIN_BATCH, hw, hw, c), act, "bf16")
     for hw, c, act in ((512, 128, "silu"), (256, 128, "silu"), (256, 256, "silu"),
                        (128, 256, "silu"), (128, 512, "silu"), (64, 512, "silu"),
                        (64, 512, "none"))]
# DiT-XL/2-256 (facebook/DiT-XL-2-256's widths) and the SD VAE: a request of
# 8 labels (classes of DiT's sample grid), CFG 4.0, 25 DDIM steps (and one
# under DPM-Solver++), the CFG batch of 16 at 256 tokens; tools.train_dit.main
# at its batch of 16 cut to DIT_TRAIN_STEPS steps with gradient checkpointing.
# PixArt-XL-2-512x512 over T5 v1.1-XXL (120 caption tokens) and the SD VAE: a
# 20-step DPM-Solver++ request at CFG 4.5, 1,024 tokens. B1 at head 72 as the
# two paths give it (DiT's q / k / v strided views of the fused projection)
# and at PixArt-XL-2-1024-MS's 4,096 tokens (a gate and a time only); B15 /
# B14 at the training batch; B12 at DiT's 4,096 rows; B11 at T5's caption
# rows; B4 at the VAE decode of 8 latents of 32 x 32
DIT_LABELS = (207, 360, 387, 974, 88, 979, 417, 279)
DIT_STEPS, DIT_GUIDANCE, DIT_SEED = 25, 4.0, 0
DIT_FLASH_SHAPES = [(16, 256, 16, 72), (2, 1024, 16, 72), (2, 4096, 16, 72)]
DIT_TRAIN_BATCH, DIT_TRAIN_STEPS = 16, 4
DIT_TRAIN_FLASH_CASES = [(DIT_TRAIN_BATCH, 256, 16, 16, 72, False)]
DIT_ADALN_SHAPE = (16, 256, 1152)
DIT_GN_CASES = [((8, 32, 32, 512), "silu"), ((8, 128, 128, 256), "silu"),
                ((8, 256, 256, 128), "silu")]
PIXART_RMS_SHAPES = [(120, 4096)]
PIXART_PROMPTS = ("a small cactus with a happy face in the Sahara desert",
                  "an astronaut riding a green horse")
PIXART_STEPS, PIXART_GUIDANCE, PIXART_SEED = 20, 4.5, 0
# InternVL2-8B (OpenGVLab/InternVL2-8B, models/internvl2/internvl2_8b.py) and
# Qwen-VL-Chat (Qwen/Qwen-VL-Chat, models/qwen_vl/qwenvl_chat.py) serving,
# batch 1, VLM_NEW_TOKENS new tokens, eos off. InternVL2: a 448 x 448 jpeg (one
# tile, 256 image tokens), a 1024 x 768 one (the 4 x 3 grid's 12 tiles and a
# thumbnail: 3,328 image tokens) and the same through MiniMonkey's tiling
# (max_num 7: 6 + 2 tiles and the thumbnail). Qwen-VL: one 640 x 480 jpeg (256
# features), two ("Picture 1 / 2"), and one image before QWENVL_LONG_TEXT text
# ids, whose positions pass seq_length 2,048 (logn scale above 1, NTK alpha 3)
VLM_NEW_TOKENS = 128
VLM_AGREE_STEPS = 4
INTERNVL2_ONE_TILE, INTERNVL2_BIG = (448, 448), (768, 1024)  # (h, w) of the jpegs
INTERNVL2_MINIMONKEY_MAX = 7
# B1 at InternViT's 1,025 tokens, 16 heads of 64, for 1 and 13 tiles; B10 at
# the tower's rows (1,025 a tile) and the projector's 4,096-wide (256 a tile);
# B7 at G 4, the 13-tile request's last decode step (3,362 + 127 keys)
INTERNVL2_FLASH_TILES = (1, 13)
INTERNVL2_LN_SHAPES = [(1025, 1024, 1), (13325, 1024, 1), (256, 4096, 1), (3328, 4096, 1)]
INTERNVL2_DECODE_CASES = [(1, 32, 8, 128, 3490, (3489,))]
QWENVL_IMAGE = (480, 640)
QWENVL_LONG_TEXT = 1900
# B1 at ViT-bigG's 1,024 tokens, 16 heads of 104 (per-head views), and the
# Resampler's 256 queries over 1,024 keys, 32 x 128, for 1 and 2 images; B10
# at the trunk's 1,664-wide rows and the Resampler's 4,096-wide ones (ln_kv
# 1,024 an image, ln_q and ln_post 256); B7 at G 1, the long request's last step
QWENVL_FLASH_IMAGES = (1, 2)
QWENVL_LN_SHAPES = [(1024, 1664, 1), (2048, 1664, 1), (256, 4096, 1), (1024, 4096, 1),
                    (2048, 4096, 1)]
QWENVL_DECODE_CASES = [(1, 32, 32, 128, 2289, (2288,))]
# H100 SXM peaks (NVIDIA data sheet, dense) for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
L2_BYTES = 50 * 2 ** 20


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


PHASE_SECONDS = {}  # host seconds of each of main's sections, in run order
_LAP = [T_START]


def lap(name):
    """Close the section `name` of main: its host seconds since the previous
    lap (the first since the start), printed and kept in PHASE_SECONDS."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = round(now - _LAP[0], 1)
    _LAP[0] = now
    print(f"[phase] {name}: {PHASE_SECONDS[name]:.1f} s (the run so far {now - T_START:.1f} s)",
          flush=True)


def cuda_ms(torch, fn, iters=10, warmup=3):
    """Mean device milliseconds of `fn` over `iters` launches, or over one
    pass through its copies if `cold` made more: after the warm-up (Triton
    compiles there) the launches are captured once in a CUDA graph, and one
    replay is timed by CUDA events, so the host's dispatch time, which
    exceeds a small kernel's own (a 1-row RMSNorm, a decode step's GEMV), is
    not in the number."""
    iters = max(iters, getattr(fn, "copies", 0))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(torch, kernel, plain):
    """Kernel and plain times measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def library_ms(torch, fn):
    """The one PyTorch call that computes a kernel's function, timed like it."""
    return None if fn is None else (cuda_ms(torch, fn) + cuda_ms(torch, fn)) / 2


def bound(nbytes, ops, kind):
    """(least ms the card could take, what bounds it): the larger of the bytes
    over the memory rate and the operations over the peak rate for their type."""
    return bound_parts(nbytes, [(ops, kind)])


def bound_parts(nbytes, parts):
    """`bound` for work of several types: the bytes' time, or the sum over
    (ops, type) of each part's operations over its peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(ops / PEAK_OPS_PER_S[kind] * 1e3 for ops, kind in parts)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def cold(fn, first, nbytes_each):
    """`fn` over `first` (a tensor or a tuple of them) and clones of it, in
    turn, enough to pass three times the L2 cache between two uses of one
    copy, as a model's next layer finds its weights and cache in device
    memory. `cuda_ms` captures a pass through all copies. At most 64 copies:
    an operand under 3 x 50 MiB / 64 = 2.3 MiB (the 1-row RMSNorm's 8 KiB)
    stays in L2 and is timed warm."""
    n = min(64, -(-3 * L2_BYTES // nbytes_each))
    clone = (lambda x: tuple(t.clone() for t in x)) if isinstance(first, tuple) else \
        (lambda x: x.clone())
    copies = [first] + [clone(first) for _ in range(n - 1)]
    it = itertools.cycle(copies)

    def call():
        return fn(next(it))
    call.copies = n
    return call


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def bf16_ulps(out, ref):
    """max |out - ref| in units of one bf16 ulp of ref (<= 2**-7 * |ref|)."""
    ref = ref.float()
    return ((out.float() - ref).abs() / (2.0 ** -7 * ref.abs() + 2.0 ** -126)).max().item()


def ulp_gate(out, ref, c):
    """(excess of |out - ref| over 2**-7 |ref| + c |ref|max, the least c that
    would pass); the excess must be <= 0."""
    ref = ref.float()
    diff = (out.float() - ref).abs() - 2.0 ** -7 * ref.abs()
    peak = ref.abs().max()
    return (diff - c * peak).max().item(), (diff.max() / peak).item()


def ptxas_counts(source, entry):
    """(registers, spills) that ptxas reported in this run's build of
    csrc/<source>.cu for the kernel whose mangled name holds `entry`."""
    import re

    from paddlemix_tpu_torch.kernels import build_log

    report = build_log[source]["ptxas"].splitlines()
    regs = spills = "not in this run's build log"
    for i, line in enumerate(report):
        if "Compiling entry" in line and entry in line:
            for nxt in report[i + 1:]:
                if "Compiling entry" in nxt:
                    break
                m = re.search(r"Used (\d+) registers", nxt)
                regs = m.group(1) if m else regs
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                spills = f"spills {m.group(1)} / {m.group(2)} bytes" if m else spills
    return regs, spills


def flash_core(d, int8=False):
    """(core, note) of the flash forward at the caller's head_dim d: the
    instantiation that the fixed width table of csrc/flash_fwd.cu
    (`flash_fwd_core`) serves the head with, held against the wrapper's
    mirror (`flash_fwd_plan`, `flash_fwd_smem`), ptxas's registers and
    spills for it (a spill fails the run) and its block's dynamic shared
    memory."""
    from paddlemix_tpu_torch.ops import attention as attn

    mirror = attn.flash_fwd_plan(d)
    plan, smem = attn.flash_fwd_core(mirror.width, int8)
    check(plan == mirror and smem == attn.flash_fwd_smem(plan.d_kernel, int8),
          f"flash_fwd_core at head {d} (int8 {int8}): {plan}, {smem} bytes; the mirror "
          f"{mirror}, {attn.flash_fwd_smem(mirror.d_kernel, int8)} bytes")
    regs, spills = ptxas_counts("flash_fwd", f"flash_fwd_wgmma_kernelILi{plan.d_kernel}ELb"
                                f"{int(int8)}ELi{plan.bn}ELi{plan.stages}EE")
    check(spills in ("spills 0 / 0 bytes", "not in this run's build log"),
          f"flash_fwd D {plan.d_kernel} int8 {int8}: {spills}")
    read = "in place" if plan.width == d else f"padded to {plan.width}"
    return "wgmma", (f"D {plan.d_kernel}{', s8 QK^T' if int8 else ''}, {plan.bn}-key tiles in "
                     f"{plan.stages} stages, the head read {read}; ptxas {regs} registers at "
                     f"entry (setmaxnreg: 240 a consumer thread, 24 a producer), {spills}; "
                     f"{smem:,} bytes of dynamic shared memory a block")


def recorder(summary):
    """The function that prints the times of one kernel case and keeps them in
    `summary` (kernel name -> rows) for the kernels line."""
    def record(label, name, shape, err, ms, plain_ms, lib_ms, bnd, extra="", flash=None,
               bwd=None, floor=None, copy=None):
        """Print the times of one kernel case and keep them for the summary;
        `flash` = (caller's head_dim, the bound's operations, int8) of a flash
        forward case, or `bwd` = (caller's head_dim, the bound's operations) of
        a flash backward one, adds the core that served it and its TFLOP/s;
        `floor` is the ms of an empty kernel of the case's launch shape, `copy`
        that of `copy_` of the bytes the case reads."""
        lib = "no single call" if lib_ms is None else f"{lib_ms:.3f} ms"
        fl = ("" if floor is None else f" | floor {floor:.4f} ms") + \
            ("" if copy is None else f" | copy_ {copy:.4f} ms")
        print(f"[{label}]   {name} {shape}{extra}: kernel {ms:.4f} ms | plain {plain_ms:.3f} ms "
              f"| library {lib} | bound {bnd[0]:.4f} ms ({bnd[1]}){fl}", flush=True)
        row = dict(shape=shape, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=bnd)
        if floor is not None:
            row["floor_ms"] = floor
        if copy is not None:
            row["copy_ms"] = copy
        if flash is not None or bwd is not None:
            d_, ops, int8 = flash if flash is not None else (*bwd, False)
            core, note = flash_core(d_, int8) if flash is not None else bwd_core(d_)
            row.update(core=core, tflops=ops / ms / 1e9)
            print(f"[{label}]   {name} {shape}: core {core} ({note}) | {ops / ms / 1e9:.1f} "
                  f"TFLOP/s of the bound's {ops:.4g} operations; the bound is "
                  f"{100 * bnd[0] / ms:.1f}% of the kernel's time", flush=True)
        summary.setdefault(name, []).append(row)
    return record


def gemm_core(kind, m, k, n):
    """(core, note) of B2 (kind "a8w8") or B6 ("wint8") at (M, K, N): the
    kernel the wrapper launches there and, for the wgmma core, its tile plan
    (ops/gemm_tiles.py), ptxas's registers and spills for that instantiation
    and its block's dynamic shared memory."""
    from paddlemix_tpu_torch.ops import conv_int8, gemm_tiles, quant

    if kind == "wint8" and m == 1:
        return "gemv", "wint8_gemv_kernel, M = 1"
    if kind == "a8w8":
        source, tiles, smem = "int8_gemm", gemm_tiles.A8W8_TILES, conv_int8.gemm_smem_bytes
        plan_fn, what = gemm_tiles.a8w8_plan, "rows of x by {} columns"
    else:
        source, tiles, smem = "wint8_gemm", gemm_tiles.WINT8_TILES, quant.wint8_smem_bytes
        plan_fn, what = gemm_tiles.wint8_plan, "weight rows by {} tokens"
    clusters = gemm_tiles.max_clusters(source, f"{source}_max_clusters", tiles, 0)
    plan = plan_fn(m, n, k, clusters)
    regs, spills = ptxas_counts(source, f"{source}_wgmma_kernelILi{plan.tile}E")
    return "wgmma", (f"tiles of 128 {what.format(plan.tile)}, {plan.outer_tiles} x "
                     f"{plan.inner_tiles}, {plan.grid} blocks in clusters of 2 "
                     f"({clusters[plan.tile]} fit at once); ptxas {regs} registers at entry "
                     f"(setmaxnreg: 232 a consumer thread, 40 a producer), {spills}; "
                     f"{smem(plan.tile):,} bytes of dynamic shared memory a block")


def a8w_core(kind, m, k, n):
    """(core, note) of N1 (kind "a8w8") or N2 ("a8w4") at (M, K, N): the GEMV
    at M = 1, else the tiled path's plan (ops/gemm_tiles.py), held against
    the library's own answer (`a8w_gemm_plan`); ptxas's registers and spills
    for the instantiation (a spill fails the run) and its shared memory."""
    from paddlemix_tpu_torch.ops import gemm_tiles, quant

    if m == 1:
        regs, spills = ptxas_counts("a8w_gemm", f"a8w_gemv_kernelILb{int(kind == 'a8w4')}E")
        check(spills in ("spills 0 / 0 bytes", "not in this run's build log"),
              f"{kind} GEMV: {spills}")
        return "gemv", (f"a8w_gemv_kernel<{'int4' if kind == 'a8w4' else 'int8'}>, M = 1: x's "
                        f"row quantized into shared memory in every block; ptxas {regs} "
                        f"registers, {spills}")
    plan = quant.a8w_tile_plan(kind, m, n, k, 0)
    mirror, lib = gemm_tiles.a8w_plan_fields(plan), quant.a8w_library_plan(kind, m, n, k,
                                                                           plan.tile)
    check(mirror == lib, f"{kind} {(m, k, n)}: plan {mirror} != the library's {lib}")
    spec = f"DynA8W8ILi{plan.tile}E" if kind == "a8w8" else f"A8W4ILi{plan.tile}E"
    regs, spills = ptxas_counts("a8w_gemm", spec)
    check(spills in ("spills 0 / 0 bytes", "not in this run's build log"),
          f"{kind} tile {plan.tile}: {spills}")
    what = ("SS, tiles of 128 rows of xq by {} weight rows" if kind == "a8w8"
            else "RS out^T = W4 xq^T, tiles of 128 weight rows by {} tokens")
    clusters = gemm_tiles.max_clusters("a8w_gemm", f"{kind}_gemm_max_clusters",
                                       gemm_tiles.A8W_TILES, 0)
    return "wgmma", (f"{what.format(plan.tile)}, {plan.outer_tiles} x {plan.inner_tiles}, "
                     f"{plan.grid} blocks in clusters of 2 ({clusters[plan.tile]} fit at once), "
                     f"{lib[2]} stages of K a tile in a ring of {lib[4]}; plan (unit_inner, "
                     f"units, k_blocks, pair_inner, stages, smem) {mirror} = the library's; "
                     f"ptxas {regs} registers at entry (setmaxnreg: 232 a consumer thread, 40 a "
                     f"producer), {spills}; {lib[5]:,} bytes of dynamic shared memory a block")


def neighbour_sx_control(torch, quant, x, wq, scale, after):
    """N1's control: the plain version with row m of x quantized, and
    scaled, by the sx of row m + 1 (`after`, one more row, follows the last;
    at M = 1 it is the only neighbour)."""
    k = x.shape[-1]
    _, sx = quant.quantize_rows_int8(torch.cat([x.reshape(-1, k), after.reshape(1, k)]))
    sx = sx[1:]
    xq = (x.float() / sx[:, None]).round().clamp(-127, 127).to(wq.dtype)
    acc = (xq.double() @ wq.double().t()).float()
    return ((acc * sx[:, None]) * scale).to(x.dtype)


def swapped_halves_control(torch, quant, x, wq4, scale):
    """N2's control: the plain version with the packed nibbles' halves
    swapped (the low nibble of byte j read as w[k / 2 + j])."""
    w = quant.unpack_int4(wq4)
    h = w.shape[1] // 2
    return quant._a8w_product(x, torch.cat([w[:, h:], w[:, :h]], dim=1), scale)


def gemm_note(label, name, kind, shape, ms, ops, unit, extra=None):
    """Print the core, rate and yardsticks of one B2 / B6 case and keep the
    core and rate in its summary row."""
    core, note = gemm_core(kind, *shape)
    print(f"[{label}]   {name} {shape}: core {core} ({note}) | {ops / ms / 1e9:.1f} {unit} "
          f"of the bound's {ops:.4g} operations" + (f" | {extra}" if extra else ""), flush=True)
    return dict(core=core, tflops=ops / ms / 1e9)


def conv_note(label, name, shape, ms, ops, parts, extra=None):
    """Print the core, tile plan (ops/gemm_tiles.py conv_plan), ptxas counts,
    shared memory and rate of one B3 / B5 case at (B, H, W, C, O), and the
    times of its parts: the activation pass, the conv, and for B5 the
    GroupNorm statistics (`parts`: {part: ms})."""
    from paddlemix_tpu_torch.ops import conv_int8, gemm_tiles

    b_, h_, w_, c_, o_ = shape
    clusters = gemm_tiles.max_clusters("int8_conv3x3", "conv3x3_max_clusters",
                                       gemm_tiles.CONV_TILES, 0)
    plan = gemm_tiles.conv_plan(b_, h_, w_, c_, o_, clusters)
    regs, spills = ptxas_counts(
        "int8_conv3x3", f"conv3x3_wgmma_kernelILi{plan.tile}ELi{plan.pixels // 128}E")
    print(f"[{label}]   {name} {shape}: core wgmma SS (tiles of {plan.tw} x {plan.th} pixels by "
          f"{plan.tile} columns, {plan.outer_tiles} x {plan.inner_tiles}, clusters pairing "
          f"{'column' if plan.pair_inner else 'pixel'} tiles, {plan.grid} blocks "
          f"({clusters[(plan.tile, plan.pixels)]} clusters fit at once), {plan.k_blocks} stages "
          f"a tile; ptxas {regs} registers at entry (setmaxnreg: 232 a consumer thread, 40 a "
          f"producer), {spills}; {conv_int8.conv_smem_bytes(plan.tile, plan.pixels):,} bytes of "
          f"dynamic shared memory a block) | {ops / ms / 1e9:.1f} TOP/s of the bound's "
          f"{ops:.4g} operations | parts: " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + (f" | {extra}" if extra else ""), flush=True)


def bwd_core(d):
    """(core, note) of the flash backward (B14) at the caller's head_dim d:
    the blocks that csrc/flash_bwd.cu's fixed width table (`flash_bwd_core`)
    serves the head with, held against the wrapper's mirror
    (`flash_bwd_plan`, `flash_bwd_smem`), ptxas's registers and spills for
    both kernels (a spill fails the run) and their blocks' dynamic shared
    memory."""
    from paddlemix_tpu_torch.ops import attention as attn

    mirror = attn.flash_bwd_plan(d)
    plan, smem = attn.flash_bwd_core(mirror.width)
    want = tuple(attn.flash_bwd_smem(mirror.d_kernel, dkv) for dkv in (True, False))
    check(plan == mirror and smem == want,
          f"flash_bwd_core at head {d}: {plan}, {smem} bytes; the mirror {mirror}, {want} bytes")
    parts = []
    for name, form, nbytes_ in (("dkv", plan.dkv, smem[0]), ("dq", plan.dq, smem[1])):
        regs, spills = ptxas_counts("flash_bwd", f"{name}_wgmma_kernelILi{plan.d_kernel}E")
        check(spills in ("spills 0 / 0 bytes", "not in this run's build log"),
              f"flash_bwd_{name} D {plan.d_kernel}: {spills}")
        parts.append(f"{name}: {form.own} rows a block, split by "
                     f"{'output' if form.split else 'rows'}, {form.stages} stages, ptxas {regs} "
                     f"registers at entry, {spills}, {nbytes_:,} bytes of dynamic shared memory")
    read = "in place" if plan.width == d else f"padded to {plan.width}"
    return "wgmma", (f"D {plan.d_kernel}, {plan.walk}-row walked tiles, the head read {read}; "
                     + "; ".join(parts) + " (setmaxnreg: 232 a consumer thread, 40 a producer)")


def bwd_share(label, by_kernel, device_ms):
    """Print and return the device ms of a profile's B14 kernels (dK/dV and
    dQ), by kernel and compiled width, and their share of the device time."""
    import re

    rows = [(ms_, n_, key) for ms_, n_, key in by_kernel if "flash_bwd" in key]
    total = sum(ms_ for ms_, _, _ in rows)
    names = [(re.search(r"flash_bwd_\w+<\d+>", key) or re.search(".{0,60}", key)).group(0)
             for _, _, key in rows]
    print(f"{label} B14: {total:.1f} ms of the {device_ms:.1f} ms of device time "
          f"({100 * total / device_ms:.1f}%): " + "; ".join(
              f"{ms_:.3f} ms {n_}x {name}" for (ms_, n_, _), name in zip(rows, names)),
          flush=True)
    return total


def wrongly_skipped(attn, s_, kw):
    """The backward kernels' tile visits with one pair more skipped: batch row
    0's visited pair below the diagonal and nearest to it, whose tiles share
    a segment (ids in packing order) and whose pairs causal keeps. The
    control of the tiled plain versions."""
    visits = attn.flash_bwd_tile_visits(s_, s_, **kw).clone()
    i, j = max(((i, j) for i, j in visits[0].nonzero().tolist() if i > j),
               key=lambda p: (p[1] - p[0], p[0]))
    visits[0, i, j] = False
    return visits


def plain_swaps(m, int8=True, bf16=True):
    """(module, wrapper name, plain version) for the kernel wrappers the model
    calls: the int8 ones (B2, B3, B5), and with `bf16` also flash attention
    and GroupNorm (B1, B4, and the GroupNorm statistics that make B5's
    affine)."""
    swaps = []
    if bf16:
        swaps += [
            (m.attn, "flash_attention", lambda q, k, v, **kw: m.attn.flash_attention_ref(
                q, k, v, scale=kw.get("scale"))),
            (m.resnet, "group_norm", m.norms.group_norm_ref),
            (m.fused, "group_norm_stats", m.norms._group_moments),
        ]
    if int8:
        swaps += [
            (m.quant, "int8_a8w8_matmul", m.conv_int8.int8_a8w8_matmul_ref),
            (m.quant, "int8_conv3x3_same", m.conv_int8.int8_conv3x3_same_ref),
            (m.resnet, "fused_gn_silu_conv3x3", m.fused.fused_gn_silu_conv3x3_ref),
        ]
    return swaps


def unquantized(m, plain):
    """`plain` with its activation quantize step removed: it convolves or
    multiplies x / sx unrounded and unclipped. The control of the int8 checks."""
    def no_quantize(x, sx):
        return x.float() * (1.0 / sx)

    def run(*args, **kwargs):
        with swapped([(m.conv_int8, "quantize_int8", no_quantize),
                      (m.fused, "quantize_int8", no_quantize)]):
            return plain(*args, **kwargs)
    return run


class swapped:
    """Inside the block, each (module, name) attribute is replaced by fn."""

    def __init__(self, swaps):
        self.swaps = list(swaps)

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.swaps]
        for mod, name, fn in self.swaps:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.swaps, self.saved):
            setattr(mod, name, fn)


# ------------------------------------------------------------ training slice
TRAIN_MICRO_STEPS = 24  # 3 optimizer steps (4 until the DiT and PixArt phases)
TRAIN_SAMPLES = 512
TRAIN_CONFIG = os.path.join(REPO, "configs", "llava", "lora_sft_7b.json")
# the published recipe's cuts: 2 rows x 8 micro-batches are its 16 rows an
# optimizer step; TRAIN_MICRO_STEPS micro-batches (3 optimizer steps) go to
# Trainer.train, since optax's cosine schedule refuses a total below its 100
# warmup steps: the schedule spans the epoch of the seeded dataset
# (TRAIN_SAMPLES samples of 128-1536 tokens, the first third of each labelled
# -100, MixToken-packed to 2048: over 100 micro-batches). The recipe's
# save_steps (500) falls past them: the train phase writes no checkpoint.
TRAIN_OVERRIDES = dict(per_device_train_batch_size=2, gradient_accumulation_steps=8)
# (B, S, Hq, Hkv, D): the path's attention (2 packed rows, causal + segments),
# a GQA shape and a ragged one (no multiple of any tile; head_dim 64, B14's
# other wgmma width); each row has 4 segments, cut off the 64-row tiles
TRAIN_FLASH_SHAPES = [(2, 2048, 32, 32, 128), (1, 2048, 32, 8, 128), (1, 1000, 4, 4, 64)]
TRAIN_SEGMENT_CUTS = (0.31, 0.58, 0.86)
TRAIN_RMS_SHAPE = (4096, 4096)  # rows x width of the path's RMSNorm backward
# B15 and B14 against their plain versions on the same bf16 inputs, per
# element: 2**-7 |ref| + TRAIN_SUM |ref|max; the lse within LSE_TOL (an lse
# error e scales p by 2**e). Sound kernels need c <= 1.6e-3 at these shapes
# (PERF.md); the gate sits 2.5x above. Three controls must fail it: no causal
# mask, di dropped, and the fine one, the middle segment boundary one row late
# (one query row and one key row of 2,048 wrong).
TRAIN_SUM, LSE_TOL = 4e-3, 1e-3
# B11 backward: dx is fp32 math rounded once to bf16; dw an fp32 sum over 4096
# rows in another order. The control, dw of the first pass alone (its first
# program's rows, no second pass), must fail.
RMS_BWD_SUM, RMS_DW_TOL = 1e-5, 1e-4
# train agree: one packed 1 x 2048 micro-batch through the full 32 layers,
# kernels vs plain versions: the loss (relative, within TRAIN_LOSS_TOL) and
# each LoRA factor's gradient (relative L2), bf16 model. The gradients' gap is
# the model's, not the kernels': two sound plain versions one rounding apart
# (the forward's P rounded to bf16 before P.V, as the kernels and JAX round
# it) differ as much, 3.5e-2 at the median of 448 factors and 4.8e-2 at most,
# and the gap grows with depth (PERF.md). So the kernels' median and largest
# gap are each held within TRAIN_AGREE_RATIO of that pair's, measured here.
TRAIN_LOSS_TOL, TRAIN_AGREE_RATIO = 1e-3, 1.25
TRAIN_AGREE_LENGTHS = (700, 520, 400, 300)  # 4 segments and 128 padding tokens
# supervised_finetune.main on the saved model (phases 22a-22d): TRAIN_OVERRIDES
# and TRAIN_MICRO_STEPS as max_steps (the schedule's total then, so its warmup
# is cut from 100 to 2, as the EVA phase cuts its own), checkpoints every 10
# micro-batches (10, 20: inside accumulation windows of 8; 20 is the one
# resumed, 4 micro-batches into its window) kept to 1, and an eval every 20
# (and at the end) over a held-out split of SFT_EVAL_SAMPLES packed as the
# training rows: 4 rows of 4 segments (1,920 tokens and 128 of padding), 2
# batches at the training shape (2, 2048). The eval's best at step 20 writes
# a checkpoint too.
SFT_RESUME_STEP = 20
SFT_MAIN_OVERRIDES = dict(TRAIN_OVERRIDES, max_steps=TRAIN_MICRO_STEPS, warmup_steps=2,
                          save_steps=10, save_total_limit=1, do_eval=True, eval_steps=20,
                          per_device_eval_batch_size=2, logging_steps=4)
SFT_EVAL_SAMPLES = TRAIN_AGREE_LENGTHS * 4
SFT_PROMPT_LEN = 608  # the adapter round trip's prefill, the LLaVA bench's prompt length


def backward_ms(torch, fwd, inputs, grad_out, iters=10):
    """Device ms of the backward of `fwd(*inputs)` w.r.t. `inputs`: forward +
    backward captured in one CUDA graph (warmed up on a side stream, as
    PyTorch's whole-network capture asks, so that autograd's host work is
    not in the number), less the forward alone captured the same way."""
    def both():
        torch.autograd.grad(fwd(*inputs), inputs, grad_out)

    def forward():
        with torch.no_grad():
            fwd(*inputs)

    times = []
    for fn in (both, forward):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times[0] - times[1]


def train_samples(np, lengths, vocab, seed):
    """Tokenized samples of these lengths, ids from a seed, the first third of
    each labelled -100."""
    rs = np.random.RandomState(seed)
    out = []
    for length in lengths:
        ids = rs.randint(3, vocab, int(length)).tolist()
        out.append({"input_ids": ids, "labels": [-100] * (length // 3) + ids[length // 3:]})
    return out


def train_kernels(torch, F, dev, gen, record, m):
    """B15 (the lse forward), B14 (dkv, dq) and B11's backward against their
    plain versions at the path's shapes, each with a control; times, bounds
    and library times."""
    bf16 = torch.bfloat16
    attn, norms = m.attn, m.norms
    sound, controls_need = [], []  # least c of the kernels, of the controls
    for b_, s_, h_, kvh, d_ in TRAIN_FLASH_SHAPES:
        shape = (b_, s_, h_, kvh, d_)
        q = torch.randn((b_, s_, h_, d_), generator=gen, device=dev).to(bf16)
        k, v = (torch.randn((b_, s_, kvh, d_), generator=gen, device=dev).to(bf16)
                for _ in range(2))
        do = torch.randn((b_, s_, h_, d_), generator=gen, device=dev).to(bf16)
        seg = torch.ones((b_, s_), dtype=torch.int32, device=dev)
        late = torch.ones_like(seg)  # the fine control's: the middle boundary one row late
        for i, cut in enumerate(TRAIN_SEGMENT_CUTS):
            seg[:, int(cut * s_):] += 1
            late[:, int(cut * s_) + (i == 1):] += 1
        segs, segs_late = attn.SegmentIds(seg, seg), attn.SegmentIds(late, late)
        lengths = [int(n) for n in torch.unique_consecutive(seg[0], return_counts=True)[1]]
        pairs = b_ * h_ * sum(n * (n + 1) // 2 for n in lengths)  # causal, within segments
        scale = d_ ** -0.5
        qs = (q.float() * (scale * attn.LOG2E)).to(bf16)
        kw = dict(causal=True, segment_ids=segs)
        # B15
        o, lse = attn.flash_fwd_lse(qs, k, v, **kw)
        torch.cuda.synchronize()
        ro, rlse = attn.flash_fwd_lse_ref(qs.float(), k.float(), v.float(), **kw)
        excess, need = ulp_gate(o, ro, TRAIN_SUM)
        lse_err = (lse - rlse).abs().max().item()
        ctrl = [ulp_gate(attn.flash_fwd_lse_ref(qs.float(), k.float(), v.float(), **c_kw)[0],
                         ro, TRAIN_SUM)
                for c_kw in (dict(segment_ids=segs), dict(causal=True, segment_ids=segs_late))]
        sound.append(need)
        controls_need += [c_[1] for c_ in ctrl]
        print(f"[train kernels] flash_fwd_lse {shape} causal + 4 segments: o excess "
              f"{excess:.3e} (least c {need:.2e}, c {TRAIN_SUM}), lse max err {lse_err:.3e} "
              f"(tol {LSE_TOL}); controls, least c (must be > c): without the causal mask "
              f"{ctrl[0][1]:.2e}, a boundary one row late {ctrl[1][1]:.2e}", flush=True)
        check(bool(torch.isfinite(o).all()) and excess <= 0 and lse_err <= LSE_TOL,
              f"flash_fwd_lse {shape}: excess {excess}, lse err {lse_err}")
        check(all(c_[0] > 0 for c_ in ctrl), f"flash_fwd_lse {shape}: a control passes {ctrl}")
        ms, plain_ms = timed_pair(torch, lambda: attn.flash_fwd_lse(qs, k, v, **kw),
                                  lambda: attn.flash_fwd_lse_ref(qs, k, v, **kw))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=h_ != kvh))
        record("train kernels", "flash_fwd_lse", shape, (o.float() - ro).abs().max().item(),
               ms, plain_ms, lib_ms,
               bound(nbytes(qs, k, v, o, lse, seg, seg), 4 * d_ * pairs, "bf16"),
               " | library: SDPA is_causal, no segments", flash=(d_, 4 * d_ * pairs, False))
        # B14, from the plain forward's o and lse
        di = (ro * do.float()).sum(-1).transpose(1, 2).contiguous()
        dkv_ref = attn.flash_bwd_dkv_ref(qs.float(), k.float(), v.float(), do.float(), rlse,
                                         di, **kw)
        dq_ref = attn.flash_bwd_dq_ref(qs.float(), k.float(), v.float(), do.float(), rlse, di,
                                       scale=scale, **kw)
        dk, dv = attn.flash_bwd_dkv(qs, k, v, do, rlse, di, **kw)
        dq = attn.flash_bwd_dq(qs, k, v, do, rlse, di, scale=scale, **kw)
        again = (*attn.flash_bwd_dkv(qs, k, v, do, rlse, di, **kw),
                 attn.flash_bwd_dq(qs, k, v, do, rlse, di, scale=scale, **kw))
        torch.cuda.synchronize()
        same = all(torch.equal(a_, b_) for a_, b_ in zip((dk, dv, dq), again))
        del again
        no_di = torch.zeros_like(di)
        kw_late = dict(causal=True, segment_ids=segs_late)
        f32 = (qs.float(), k.float(), v.float(), do.float(), rlse)
        bad = wrongly_skipped(attn, s_, kw)
        tiled = {"flash_bwd_dkv": attn.flash_bwd_dkv_tiled_ref(*f32, di, **kw),
                 "flash_bwd_dq": (attn.flash_bwd_dq_tiled_ref(*f32, di, scale=scale, **kw),)}
        controls = {"flash_bwd_dkv": (attn.flash_bwd_dkv_ref(*f32, no_di, **kw),
                                      attn.flash_bwd_dkv_ref(*f32, di, **kw_late),
                                      attn.flash_bwd_dkv_tiled_ref(*f32, di, visits=bad, **kw)),
                    "flash_bwd_dq": ((attn.flash_bwd_dq_ref(*f32, no_di, scale=scale, **kw),),
                                     (attn.flash_bwd_dq_ref(*f32, di, scale=scale, **kw_late),),
                                     (attn.flash_bwd_dq_tiled_ref(*f32, di, scale=scale,
                                                                  visits=bad, **kw),))}
        core, note = bwd_core(d_)
        print(f"[train kernels] flash_bwd {shape}: core {core} ({note}); two launches "
              f"bit-identical: {same}", flush=True)
        check(same, f"flash_bwd {shape}: two launches differ")
        lib_bwd = (backward_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, is_causal=True, enable_gqa=h_ != kvh),
            tuple(t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)),
            do.transpose(1, 2)) + backward_ms(torch, lambda *t: F.scaled_dot_product_attention(
                *t, is_causal=True, enable_gqa=h_ != kvh),
                tuple(t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)),
                do.transpose(1, 2))) / 2
        for name, outs, refs, ops in (("flash_bwd_dkv", (dk, dv), dkv_ref, 8 * d_ * pairs),
                                      ("flash_bwd_dq", (dq,), (dq_ref,), 6 * d_ * pairs)):
            # against the plain version and its tiled walk (the kernels' skips)
            gates = [ulp_gate(o_, r_, TRAIN_SUM) for o_, r_ in zip(outs, refs)] + \
                [ulp_gate(o_, r_, TRAIN_SUM) for o_, r_ in zip(outs, tiled[name])]
            # each control fails if any of its outputs does
            ctrl = [max((ulp_gate(c_, r_, TRAIN_SUM) for c_, r_ in zip(c_outs, refs)),
                        key=lambda g: g[0]) for c_outs in controls[name]]
            sound += [g[1] for g in gates]
            controls_need += [c_[1] for c_ in ctrl]
            err = max((o_.float() - r_).abs().max().item() for o_, r_ in zip(outs, refs))
            print(f"[train kernels] {name} {shape}: excess {[f'{g[0]:.3e}' for g in gates]} "
                  f"(least c {[f'{g[1]:.2e}' for g in gates]}, c {TRAIN_SUM}; plain, then "
                  f"tiled); controls, least c (must be > c): di dropped {ctrl[0][1]:.2e}, a "
                  f"boundary one row late {ctrl[1][1]:.2e}, a tile pair sharing a segment "
                  f"skipped {ctrl[2][1]:.2e}", flush=True)
            check(all(bool(torch.isfinite(o_).all()) for o_ in outs)
                  and all(g[0] <= 0 for g in gates), f"{name} {shape}: excess {gates}")
            check(all(c_[0] > 0 for c_ in ctrl), f"{name} {shape}: a control passes {ctrl}")
            if name == "flash_bwd_dkv":
                ms, plain_ms = timed_pair(
                    torch, lambda: attn.flash_bwd_dkv(qs, k, v, do, rlse, di, **kw),
                    lambda: attn.flash_bwd_dkv_ref(qs, k, v, do, rlse, di, **kw))
            else:
                ms, plain_ms = timed_pair(
                    torch, lambda: attn.flash_bwd_dq(qs, k, v, do, rlse, di, scale=scale, **kw),
                    lambda: attn.flash_bwd_dq_ref(qs, k, v, do, rlse, di, scale=scale, **kw))
            record("train kernels", name, shape, err, ms, plain_ms, lib_bwd,
                   bound(nbytes(qs, k, v, do, rlse, di, seg, seg, *outs), ops, "bf16"),
                   " | library: the backward of SDPA is_causal (dq, dk, dv together), no "
                   "segments", bwd=(d_, ops))
        del o, ro, dkv_ref, dq_ref, dk, dv, dq, controls, tiled
    print(f"[train kernels] B15 / B14 gate c {TRAIN_SUM}: the kernels' least c at most "
          f"{max(sound):.2e}, the controls' at least {min(controls_need):.2e}", flush=True)
    # B11 backward at the path's rows: dx alone (the norms are frozen), then with dw
    rows, h = TRAIN_RMS_SHAPE
    x = torch.randn((rows, h), generator=gen, device=dev).to(bf16)
    w = 1 + 0.1 * torch.randn(h, generator=gen, device=dev)
    g = torch.randn((rows, h), generator=gen, device=dev).to(bf16)
    dx, _ = norms.rms_norm_backward(x, w, g, 1e-5, need_dw=False)
    dx2, dw = norms.rms_norm_backward(x, w, g, 1e-5)
    torch.cuda.synchronize()
    rdx, rdw = norms.rms_norm_backward_ref(x.float(), w, g.float(), 1e-5)
    excess, need = ulp_gate(dx, rdx, RMS_BWD_SUM)
    dw_err = ((dw - rdw).abs().max() / rdw.abs().max()).item()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    first = -(-rows // (norms._RMS_DW_PROGRAMS_PER_SM * sms))
    ctrl_dw = norms.rms_norm_backward_ref(x[:first].float(), w, g[:first].float(), 1e-5)[1]
    ctrl = ((ctrl_dw - rdw).abs().max() / rdw.abs().max()).item()
    print(f"[train kernels] rms_norm_backward {TRAIN_RMS_SHAPE}: dx excess {excess:.3e} (least "
          f"c {need:.2e}, c {RMS_BWD_SUM}), the same dx with dw: {torch.equal(dx, dx2)}; dw "
          f"max err {dw_err:.3e} |ref|max (tol {RMS_DW_TOL}); control, the first pass's first "
          f"{first} rows alone: {ctrl:.3e} (must be > tol)", flush=True)
    check(excess <= 0 and torch.equal(dx, dx2) and dw_err <= RMS_DW_TOL,
          f"rms_norm_backward: excess {excess}, dw err {dw_err}")
    check(ctrl > RMS_DW_TOL, f"rms_norm_backward: the dw control passes ({ctrl})")
    w16 = w.to(bf16)
    for need_dw, label in ((False, "dx"), (True, "dx + dw")):
        ms, plain_ms = timed_pair(
            torch, lambda: norms.rms_norm_backward(x, w, g, 1e-5, need_dw=need_dw),
            lambda: norms.rms_norm_backward_ref(x, w, g, 1e-5, need_dw=need_dw))
        lib_ms = None if need_dw else sum(backward_ms(
            torch, lambda x_: F.rms_norm(x_, (h,), w16, 1e-5), (x.detach().requires_grad_(),),
            g) for _ in range(2)) / 2
        record("train kernels", "rms_norm_backward", (rows, h),
               (dx.float() - rdx).abs().max().item(), ms, plain_ms, lib_ms,
               bound(nbytes(x, w, g, dx, dw if need_dw else None), 8 * x.numel(), "fp32"),
               f" {label} | library: the backward of F.rms_norm (bf16 weight), x only")
    del x, g, dx, dx2, rdx
    autograd_kinds(torch, dev, gen, m)


def autograd_kinds(torch, dev, gen, m):
    """The three kinds of gradient on the card: flash and RMSNorm through
    their backward kernels (the train phases count those launches); adaLN
    (B12) through autograd of its plain version, recomputed; an inference
    kernel (B6) refusing a call autograd would record."""
    bf16 = torch.bfloat16
    x = torch.randn((2, 64, 1536), generator=gen, device=dev).to(bf16).requires_grad_()
    sc, sh = (torch.randn((2, 1536), generator=gen, device=dev).to(bf16).requires_grad_()
              for _ in range(2))
    before = m.norms.adaptive_layer_norm.launches
    y = m.norms.adaptive_layer_norm(x, sc, sh)
    gy = torch.randn(y.shape, generator=gen, device=dev).to(bf16)
    got = torch.autograd.grad(y, (x, sc, sh), gy)
    want = torch.autograd.grad(m.norms.adaptive_layer_norm_ref(x, sc, sh), (x, sc, sh), gy)
    same = all(rel_l2(a.float(), b.float()) <= 1e-6 for a, b in zip(got, want))
    launched = m.norms.adaptive_layer_norm.launches - before
    wq, scale = m.quant.quantize_weights_int8(torch.randn((256, 512), generator=gen, device=dev))
    xin = torch.randn((4, 512), generator=gen, device=dev).to(bf16).requires_grad_()
    try:
        m.quant.wint8_matmul(xin, wq, scale)
        refused = False
    except RuntimeError:
        refused = True
    print(f"[train kernels] autograd kinds: adaptive_layer_norm under grad launched "
          f"{launched} kernel, its gradients equal autograd of the plain version: {same}; "
          f"wint8_matmul on an input that requires grad refused: {refused}", flush=True)
    check(launched == 1 and same and refused, "autograd kinds: B12's plain backward or B6's "
          "refusal does not hold")
    m.norms.adaptive_layer_norm.launches = before


def agree_inputs(torch, np, dev, model, cfg):
    """train agree's inputs: LoRA factors on `model` (b drawn non-zero, so
    that every factor has a gradient), the loss over them and one packed
    1 x 2048 row of TRAIN_AGREE_LENGTHS samples. Returns (LoraConfig, factors,
    loss_fn, batch)."""
    from paddlemix_tpu_torch.datasets import pack_samples, pad_collate
    from paddlemix_tpu_torch.peft import LoraConfig, lora_init, lora_loss_fn
    from paddlemix_tpu_torch.tools import supervised_finetune as sft

    lcfg = LoraConfig(r=int(cfg["lora_rank"]), lora_alpha=int(cfg["lora_alpha"]))
    factors = lora_init(model, lcfg, torch.Generator(device=dev).manual_seed(1))
    loss_fn = lora_loss_fn(sft.default_lm_loss(model), model)
    with torch.no_grad():
        g_b = torch.Generator(device=dev).manual_seed(2)
        for name, p in factors.items():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.01, generator=g_b)
    row = pad_collate(pack_samples(train_samples(np, TRAIN_AGREE_LENGTHS,
                                                 model.config.vocab_size, seed=1), 2048))
    return lcfg, factors, loss_fn, {k: torch.as_tensor(v).to(dev) for k, v in row.items()}


def train_plain_swaps(torch, m):
    """(the plain versions of the training kernels as swaps, the same with
    the forward's P rounded to bf16 before P.V, as the kernels and JAX round
    it: two sound plain versions one rounding apart)."""
    attn = m.attn

    def fwd_p_rounded(qs, k, v, *, causal=False, segment_ids=None):
        _, lse = attn.flash_fwd_lse_ref(qs, k, v, causal=causal, segment_ids=segment_ids)
        ke, ve = attn._expand_kv(k, v, qs.shape[2])
        p = attn._probs(qs, ke, lse, causal, segment_ids).to(v.dtype).float()
        return torch.einsum("bhqk,bkhd->bqhd", p, ve.float()).to(v.dtype), lse

    plain = [(attn, "flash_fwd_lse", attn.flash_fwd_lse_ref),
             (attn, "flash_bwd_dkv", attn.flash_bwd_dkv_ref),
             (attn, "flash_bwd_dq", attn.flash_bwd_dq_ref),
             (m.norms, "_rms_forward", m.norms.rms_norm_ref),
             (m.norms, "rms_norm_backward", m.norms.rms_norm_backward_ref)]
    return plain, [(attn, "flash_fwd_lse", fwd_p_rounded)] + plain[1:]


def gradient_gap(grads_a, grads_b):
    """(median, max) relative L2 of one set of factor gradients to another."""
    rels = sorted(rel_l2(a.float(), b.float()) for a, b in zip(grads_a, grads_b))
    return rels[len(rels) // 2], rels[-1]


def remove_lora(parametrize, model):
    """Take every LoRA parametrization off, the base weights as they were."""
    for module in list(model.modules()):
        if parametrize.is_parametrized(module, "weight"):
            parametrize.remove_parametrizations(module, "weight", leave_parametrized=False)


def train_slice(torch, F, np, dev, m, card):
    """train agree and train, then on the same model phases 22a-22d
    (`sft_durable_slice`; see the module docstring). Returns the launches of
    the train phase and its numbers, then those of 22a-22d."""
    from torch.nn.utils import parametrize

    from paddlemix_tpu_torch.models.llama import expected_launches_train, random_llama
    from paddlemix_tpu_torch.tools import supervised_finetune as sft

    counters = {"rms_norm": m.norms.rms_norm, "rms_norm_backward": m.norms.rms_norm_backward,
                "flash_fwd_lse": m.attn.flash_fwd_lse, "flash_bwd_dkv": m.attn.flash_bwd_dkv,
                "flash_bwd_dq": m.attn.flash_bwd_dq, "flash_attention": m.attn.flash_attention,
                "decode_attention": m.da.decode_attention,
                "decode_attention_int8": m.da.decode_attention_int8,
                "paged_decode_attention": m.pa.paged_decode_attention,
                "wint8_matmul": m.quant.wint8_matmul}
    cfg = sft.load_config(TRAIN_CONFIG, TRAIN_OVERRIDES)
    t0 = time.perf_counter()
    model = random_llama(dev, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"[train] Llama-2-7B built in {time.perf_counter() - t0:.1f} s; config "
          f"{os.path.relpath(TRAIN_CONFIG, REPO)} + {TRAIN_OVERRIDES}", flush=True)

    # ------------------------------------------------------------ train agree
    lcfg, factors, loss_fn, batch = agree_inputs(torch, np, dev, model, cfg)
    plain, plain_rounded = train_plain_swaps(torch, m)

    def loss_and_grads(swaps=()):
        with swapped(swaps):
            loss = loss_fn(factors, batch, None)
            grads = torch.autograd.grad(loss, list(factors.values()))
        return loss.detach().float(), grads

    for fn in counters.values():
        fn.launches = 0
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    got = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches_train(model, 1, 2048)
    loss_p, grads_p = loss_and_grads(plain)
    loss_r, grads_r = loss_and_grads(plain_rounded)
    kernel_gap, floor_gap = gradient_gap(grads_k, grads_p), gradient_gap(grads_r, grads_p)
    loss_rel = abs(loss_k - loss_p).item() / abs(loss_p).item()
    print(f"[train agree] full-width Llama-2-7B LoRA r {lcfg.r}, one packed 1 x 2048 micro-batch "
          f"({len(TRAIN_AGREE_LENGTHS)} segments), kernels vs plain: loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (relative {loss_rel:.3e}, tol {TRAIN_LOSS_TOL}; the plain "
          f"versions one rounding apart: {abs(loss_r - loss_p).item() / abs(loss_p).item():.3e}); "
          f"relative L2 of the {len(grads_k)} factor gradients, median / max: kernels vs plain "
          f"{kernel_gap[0]:.3e} / {kernel_gap[1]:.3e}, the plain versions one rounding apart "
          f"{floor_gap[0]:.3e} / {floor_gap[1]:.3e} (ratio tol {TRAIN_AGREE_RATIO}); launches "
          f"{got} (walk: {want})", flush=True)
    check(bool(torch.isfinite(loss_k)) and loss_rel <= TRAIN_LOSS_TOL
          and all(k_ <= TRAIN_AGREE_RATIO * f_ for k_, f_ in zip(kernel_gap, floor_gap)),
          f"train agree: loss {loss_rel}, grads {kernel_gap} against {floor_gap}")
    check(got == want, f"train agree: launches {got} != {want}")
    del grads_k, grads_p, grads_r, factors, loss_fn
    remove_lora(parametrize, model)

    # ------------------------------------------------------------------ train
    samples = train_samples(np, np.random.RandomState(0).randint(128, 1537, TRAIN_SAMPLES),
                            model.config.vocab_size, seed=0)
    t0 = time.perf_counter()
    trainer, lcfg = sft.build_trainer(model, samples, cfg)
    print(f"[train] build_trainer {time.perf_counter() - t0:.2f} s: "
          f"{len(trainer.train_dataloader.dataset)} packed rows, {len(trainer.train_dataloader)} "
          f"micro-batches an epoch (the schedule's total), LoRA r {lcfg.r} alpha "
          f"{lcfg.lora_alpha}: {sum(p.numel() for p in trainer.params.values())} trainable "
          f"parameters in {len(trainer.params)} factors; recompute "
          f"{model.config.gradient_checkpointing}", flush=True)
    k = trainer.args.gradient_accumulation_steps
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    # three calls (each walks the loader anew, as a JAX Trainer.train call does):
    # two optimizer steps, then b is read; one more; the last under the profiler
    trainer.train(2 * k)
    b_after_2 = [p for n, p in trainer.params.items() if n.endswith("lora_b")]
    b_moved = sum(bool(p.abs().max() > 0) for p in b_after_2)
    trainer.train(TRAIN_MICRO_STEPS - k)
    # the last optimizer step under the profiler: device time and busy share
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        trainer.train(TRAIN_MICRO_STEPS)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t_prof
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = {name: fn.launches for name, fn in counters.items()}
    want = expected_launches_train(model, TRAIN_MICRO_STEPS, cfg.get("max_length", 2048))
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    device_ms = sum(ms_ for ms_, _, _ in by_kernel)
    hist = trainer.history
    # the clip reads the global norm on the host at every optimizer step, so
    # the step boundaries' host times follow the device
    ends = [t_start] + [h["time"] for h in hist[k - 1::k]]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    losses = torch.stack([h["loss"] for h in hist]).float()
    norms_ = torch.stack([h["grad_norm"] for h in hist]).float()
    tokens = k * trainer.args.per_device_train_batch_size * int(cfg.get("max_length", 2048))
    steady = sorted(step_s[1:-1])
    s_step = steady[len(steady) // 2]
    flops = train_flops(model, tokens)
    print(f"[train] {TRAIN_MICRO_STEPS} micro-batches = {len(step_s)} optimizer steps of "
          f"{tokens} tokens: seconds a step {[round(t, 3) for t in step_s]} (the last under "
          f"the profiler); median of the middle "
          f"{s_step:.3f} s -> {tokens / s_step:.0f} tokens/s, {flops / s_step / 1e12:.1f} model "
          f"TFLOP/s ({flops:.3e} flops a step); profiled step {t_prof:.3f} s with "
          f"{device_ms:.1f} ms of device time: busy {100 * device_ms / 1e3 / t_prof:.1f}%; peak "
          f"memory {peak:.2f} GiB", flush=True)
    for ms_, n_, key in by_kernel[:12]:
        print(f"[train]   profiled step: {ms_:9.1f} ms {100 * ms_ / device_ms:5.1f}% {n_:6d}x "
              f"{key[:110]}", flush=True)
    b14_ms = bwd_share("[train]", by_kernel, device_ms)
    print(f"[train] losses {[round(x, 4) for x in losses.tolist()]}; grad_norm "
          f"{[round(x, 4) for x in norms_.tolist()]}; lora_b non-zero after the second "
          f"optimizer step: {b_moved} of {len(b_after_2)}; launches {got} (walk: {want})",
          flush=True)
    check(bool(torch.isfinite(losses).all() and torch.isfinite(norms_).all()),
          "train: a loss or grad_norm is not finite")
    check(b_moved == len(b_after_2), f"train: {len(b_after_2) - b_moved} lora_b still zero "
          f"after the second optimizer step")
    check(got == want, f"train: launches {got} != expected {want}")
    train_stats = dict(step_s=s_step, tokens_per_s=tokens / s_step, tflops=flops / s_step / 1e12,
                       busy=device_ms / 1e3 / t_prof, peak_gib=peak, b14_ms=b14_ms,
                       b14_share=b14_ms / device_ms)
    del trainer, b_after_2
    remove_lora(parametrize, model)
    holder = [model]  # the durable slice takes the model's last reference
    del model
    gc.collect()
    torch.cuda.empty_cache()
    sft_got, sft_eval_got, sft_stats = sft_durable_slice(torch, np, dev, m, counters, holder,
                                                         card)
    return got, train_stats, sft_got, sft_eval_got, sft_stats


def train_flops(model, tokens):
    """Model flops of one optimizer step of `tokens` tokens, LoRA on every
    projection: the forward and dX of the projections and the lm_head (2 flops
    a weight a token each), dW of the adapted projections (dW_eff, 2 more),
    and causal attention over full rows (4 D flops a visible pair forward, 10
    backward; the segments' savings not counted). The factors' own products
    (fp32, b @ a and its gradients) are left out."""
    cfg = model.config
    proj = sum(m.in_features * m.out_features for n, m in model.named_modules()
               if n.endswith("_proj"))
    head = cfg.hidden_size * cfg.vocab_size
    s = 2048
    attn = 14 * cfg.head_dim_ * cfg.num_attention_heads * (s * (s + 1) // 2) \
        * cfg.num_hidden_layers * (tokens // s)
    return 2 * tokens * (2 * (proj + head) + proj) + attn



def eval_kernels(torch, F, dev, gen, record, m):
    """B1's inference form at the SFT eval's shape, (2, 2048, 32, 128) causal
    + 4 segments a row (`Trainer.evaluate` runs it under inference_mode),
    against its plain version per element, with controls (no causal mask; the
    middle segment boundary one row late) that must fail the gate; times,
    bound and SDPA's time (is_causal, no segments)."""
    bf16 = torch.bfloat16
    attn = m.attn
    b_, s_, h_, kvh, d_ = TRAIN_FLASH_SHAPES[0]
    q = torch.randn((b_, s_, h_, d_), generator=gen, device=dev).to(bf16)
    k, v = (torch.randn((b_, s_, kvh, d_), generator=gen, device=dev).to(bf16) for _ in range(2))
    seg = torch.ones((b_, s_), dtype=torch.int32, device=dev)
    late = torch.ones_like(seg)
    for i, cut in enumerate(TRAIN_SEGMENT_CUTS):
        seg[:, int(cut * s_):] += 1
        late[:, int(cut * s_) + (i == 1):] += 1
    segs, segs_late = attn.SegmentIds(seg, seg), attn.SegmentIds(late, late)
    lengths = [int(n) for n in torch.unique_consecutive(seg[0], return_counts=True)[1]]
    pairs = b_ * h_ * sum(n * (n + 1) // 2 for n in lengths)
    kw = dict(causal=True, segment_ids=segs)
    with torch.inference_mode():
        out = attn.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attn.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        excess, need = ulp_gate(out, ref, FLASH_SUM)
        ctrl = [ulp_gate(attn.flash_attention_ref(q.float(), k.float(), v.float(), **c_kw), ref,
                         FLASH_SUM)
                for c_kw in (dict(segment_ids=segs), dict(causal=True, segment_ids=segs_late))]
        print(f"[eval kernels] flash_attention {(b_, s_, h_, d_)} causal + 4 segments, "
              f"inference form: excess {excess:.3e} over {FLASH_ULP:.4g}|ref| + "
              f"{FLASH_SUM:g}|ref|max (least c {need:.2e}); controls, least c (must be > c): "
              f"without the causal mask {ctrl[0][1]:.2e}, a boundary one row late "
              f"{ctrl[1][1]:.2e}", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"eval flash_attention: excess {excess}")
        check(all(c_[0] > 0 for c_ in ctrl), f"eval flash_attention: a control passes {ctrl}")
        ms, plain_ms = timed_pair(torch, lambda: attn.flash_attention(q, k, v, **kw),
                                  lambda: attn.flash_attention_ref(q, k, v, **kw))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                          is_causal=True))
        record("eval kernels", "flash_attention", (b_, s_, h_, d_),
               (out.float() - ref).abs().max().item(), ms, plain_ms, lib_ms,
               bound(nbytes(q, k, v, out, seg, seg), 4 * d_ * pairs, "bf16"),
               " causal + 4 segments | library: SDPA is_causal, no segments",
               flash=(d_, 4 * d_ * pairs, False))


def eval_plain_swaps(m):
    """The eval forward's kernels (B1's inference form, B11's forward) as
    their plain versions."""
    attn = m.attn

    def flash_plain(q, k, v, *, causal=False, scale=None, segment_ids=None, int8_qk=None):
        return attn.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                        segment_ids=segment_ids)

    return [(attn, "flash_attention", flash_plain),
            (m.norms, "_rms_forward", m.norms.rms_norm_ref)]


def write_jsonl(path, samples):
    with open(path, "w") as f:
        for sample in samples:
            f.write(json.dumps(sample) + "\n")


def sft_durable_slice(torch, np, dev, m, counters, holder, card):
    """Phases 22a-22d (see the module docstring) on the train phase's model,
    handed over in `holder` (a one-element list, so that this function holds
    its last reference and frees it). Everything is written under one
    temporary directory, removed in a `finally`. Returns the launches of the
    main runs, of the direct eval, and the numbers."""
    import shutil
    import tempfile

    from paddlemix_tpu_torch import cli
    from paddlemix_tpu_torch.auto import AutoModel
    from paddlemix_tpu_torch.core import torch_to_flax_state_dict
    from paddlemix_tpu_torch.core.modeling import load_flat_state
    from paddlemix_tpu_torch.datasets import DataLoader, MixTokenMapDataset, pad_collate
    from paddlemix_tpu_torch.models.llama import (
        LlamaForCausalLM,
        expected_launches_eval,
        expected_launches_train,
        llama2_7b_config,
    )
    from paddlemix_tpu_torch.peft import attach_lora, load_lora, lora_loss_fn, \
        merge_lora_into_model
    from paddlemix_tpu_torch.tools import supervised_finetune as sft
    from paddlemix_tpu_torch.trainer import Trainer, train_state_dict

    model = holder.pop()
    with torch.device("meta"):  # the module walk's model: no memory
        walk = LlamaForCausalLM(llama2_7b_config())
    stats = {}

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def add(a, b):
        return {k: a[k] + b[k] for k in a}

    tmp = tempfile.mkdtemp(prefix="pmix_smoke_sft_")
    try:
        # ------------------------------------------------------ 22a weights io
        model_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
        rank = int(sft.load_config(TRAIN_CONFIG)["lora_rank"])
        factor_bytes = sum(4 * rank * (mod.in_features + mod.out_features)
                           for n, mod in model.named_modules() if n.endswith("_proj"))
        ckpt_bytes = 4 * factor_bytes  # params, mu, nu, the accumulator: fp32
        # at most: the base + two checkpoints (one being rotated in) + the
        # adapter, or the base + the merged model + the adapter + one checkpoint
        need = max(model_bytes + 2 * ckpt_bytes, 2 * model_bytes + ckpt_bytes) \
            + factor_bytes + 2 ** 30
        free = shutil.disk_usage(tmp).free
        print(f"[sft io] {tmp}: {free / 1e9:.1f} GB free; this phase needs up to "
              f"{need / 1e9:.1f} GB (the model {model_bytes / 1e9:.2f} GB, a checkpoint "
              f"{ckpt_bytes / 1e9:.2f} GB)", flush=True)
        check(free >= need, f"sft io: {free / 1e9:.1f} GB free under {tmp}, {need / 1e9:.1f} GB "
              f"needed (set TMPDIR to a larger disk)")
        base_dir = os.path.join(tmp, "base")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = model.save_pretrained(base_dir)
        t_save = time.perf_counter() - t0
        files = sorted(os.listdir(base_dir))
        t0 = time.perf_counter()
        loaded = AutoModel.from_pretrained(base_dir, device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        mine, theirs = model.state_dict(), loaded.state_dict()
        unequal = [k for k, v in mine.items() if not (v.dtype == theirs[k].dtype
                                                      and torch.equal(v, theirs[k]))]
        total = sum(written.values())
        print(f"[sft io] save_pretrained of Llama-2-7B ({len(mine)} tensors, "
              f"{model_bytes / 1e9:.3f} GB of bf16 weights and fp32 norm scales): "
              f"{t_save:.2f} s, {total / 1e9:.3f} GB in {files} ({total / 1e9 / t_save:.2f} "
              f"GB/s); AutoModel.from_pretrained back to the card {t_load:.2f} s "
              f"({total / 1e9 / t_load:.2f} GB/s); tensors not bit-equal to the original: "
              f"{len(unequal)} {unequal[:3]} ({card})", flush=True)
        check(len(written) == 3 and "model.safetensors.index.json" in files,
              f"sft io: {files}: not 3 shards and the index")
        check(type(loaded).__name__ == "LlamaForCausalLM" and not unequal
              and mine.keys() == theirs.keys(), f"sft io: {len(unequal)} tensors differ")
        stats.update(save_s=t_save, load_s=t_load, weight_gb=total / 1e9)
        del mine, theirs, loaded, model
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------------------------------- 22b supervised_finetune.main
        train_path, eval_path = os.path.join(tmp, "train.jsonl"), os.path.join(tmp, "eval.jsonl")
        vocab = walk.config.vocab_size
        write_jsonl(train_path, train_samples(
            np, np.random.RandomState(0).randint(128, 1537, TRAIN_SAMPLES), vocab, seed=0))
        eval_samples = train_samples(np, SFT_EVAL_SAMPLES, vocab, seed=7)
        write_jsonl(eval_path, eval_samples)
        eval_loader = DataLoader(MixTokenMapDataset(eval_samples, 2048), batch_size=2,
                                 collate_fn=pad_collate)
        eval_forwards = len(eval_loader)
        check(eval_forwards == 2 and len(eval_loader.dataset) == 4,
              f"sft: the eval split packs to {len(eval_loader.dataset)} rows, not 4")
        out_dir = os.path.join(tmp, "out")
        overrides = dict(SFT_MAIN_OVERRIDES, model_name_or_path=base_dir,
                         dataset_path=train_path, eval_dataset_path=eval_path,
                         output_dir=out_dir)
        snapshot, io_times = {}, {"save": [], "load": []}
        saving, loading = Trainer.save_checkpoint, Trainer.load_checkpoint

        def save_checkpoint(self, step):
            if step == SFT_RESUME_STEP and not snapshot:  # the state to resume, on the host
                snapshot.update({k: v.to("cpu", copy=True)
                                 for k, v in train_state_dict(self.state, self.tx).items()})
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            path = saving(self, step)
            io_times["save"].append(time.perf_counter() - t0_)
            return path

        def load_checkpoint(self, path):
            t0_ = time.perf_counter()
            loading(self, path)
            torch.cuda.synchronize()
            io_times["load"].append(time.perf_counter() - t0_)
            restored = train_state_dict(self.state, self.tx)
            snapshot["restored_keys"] = sorted(restored)
            snapshot["unequal"] = [k for k, v in restored.items()
                                   if k not in snapshot or not torch.equal(v.cpu(), snapshot[k])]

        Trainer.save_checkpoint, Trainer.load_checkpoint = save_checkpoint, load_checkpoint
        try:
            reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res1 = sft.main(TRAIN_CONFIG, overrides)
            t_main1 = time.perf_counter() - t0
            got1 = launches()
            left = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
            ckpt_gb = os.path.getsize(os.path.join(out_dir, "checkpoints", left[0],
                                                   "state.safetensors")) / 1e9 if left else 0
            # 22c: resume from the checkpoint inside the last window
            reset()
            t0 = time.perf_counter()
            res2 = sft.main(TRAIN_CONFIG, dict(overrides, resume_from_checkpoint=os.path.join(
                out_dir, "checkpoints", str(SFT_RESUME_STEP))))
            t_main2 = time.perf_counter() - t0
            got2 = launches()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            Trainer.save_checkpoint, Trainer.load_checkpoint = saving, loading
        want1 = add(expected_launches_train(walk, TRAIN_MICRO_STEPS),
                    expected_launches_eval(walk, 2 * eval_forwards))
        want2 = add(expected_launches_train(walk, TRAIN_MICRO_STEPS - SFT_RESUME_STEP),
                    expected_launches_eval(walk, eval_forwards))
        print(f"[sft main] supervised_finetune.main over {os.path.basename(base_dir)} "
              f"({os.path.relpath(TRAIN_CONFIG, REPO)} + {SFT_MAIN_OVERRIDES}): {t_main1:.1f} s "
              f"(the model's load included); loss {res1['loss']:.4f}, eval loss "
              f"{res1.get('eval_loss', float('nan')):.4f}; checkpoints written "
              f"{len(io_times['save'])} in {[round(t, 2) for t in io_times['save']]} s, "
              f"{ckpt_gb:.3f} GB each, left after rotation {left}; launches {got1} (walk: "
              f"{want1}) ({card})", flush=True)
        check(np.isfinite(res1["loss"]) and np.isfinite(res1.get("eval_loss", np.nan))
              and res1["final_step"] == TRAIN_MICRO_STEPS, f"sft main: {res1}")
        check(left == [str(SFT_RESUME_STEP)], f"sft main: checkpoints left {left}")
        check(got1 == want1, f"sft main: launches {got1} != {want1}")
        n_state = len(snapshot.get("restored_keys", ()))
        print(f"[sft resume] main with resume_from_checkpoint at step {SFT_RESUME_STEP} "
              f"(micro-batch {SFT_RESUME_STEP % TRAIN_OVERRIDES['gradient_accumulation_steps']} "
              f"of its window): {t_main2:.1f} s; checkpoint read {io_times['load']} s; "
              f"{n_state} state tensors (factors, moments, accumulators, counters) not "
              f"bit-equal to the first run's at that step: {len(snapshot.get('unequal', [0]))} "
              f"{snapshot.get('unequal', [])[:3]}; trained on to {res2['final_step']}: loss "
              f"{res2['loss']:.4f}, eval loss {res2.get('eval_loss', float('nan')):.4f}; "
              f"launches {got2} (walk: {want2}); peak memory over both runs {peak:.2f} GiB "
              f"({card})", flush=True)
        check(n_state > 4 * 448 and snapshot.get("unequal") == [],
              f"sft resume: {snapshot.get('unequal')} differ from the saved state")
        check(res2["final_step"] == TRAIN_MICRO_STEPS and np.isfinite(res2["loss"]),
              f"sft resume: {res2}")
        check(got2 == want2, f"sft resume: launches {got2} != {want2}")
        stats.update(main_s=t_main1, resume_s=t_main2, ckpt_gb=ckpt_gb,
                     ckpt_save_s=io_times["save"], ckpt_load_s=io_times["load"], peak_gib=peak)
        snapshot.clear()
        shutil.rmtree(os.path.join(out_dir, "checkpoints"))

        # ------------------------------------------------- 22d the adapter
        base = AutoModel.from_pretrained(base_dir, device=dev, dtype=torch.bfloat16)
        factors, lcfg = load_lora(os.path.join(out_dir, "lora"))
        lora = attach_lora(base, factors, lcfg)
        trainer = Trainer(params=lora, loss_fn=lora_loss_fn(sft.default_lm_loss(base), base),
                          eval_dataloader=eval_loader)
        from torch.profiler import ProfilerActivity, profile

        reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ev_k = trainer.evaluate()["eval_loss"]
            t_eval = time.perf_counter() - t0
        got_eval = launches()
        want_eval = expected_launches_eval(walk, eval_forwards)
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        with swapped(eval_plain_swaps(m)):
            ev_p = trainer.evaluate()["eval_loss"]
        rel_main = abs(res2["eval_loss"] - ev_p) / abs(ev_p)
        rel_k = abs(ev_k - ev_p) / abs(ev_p)
        print(f"[sft eval] the adapter (load_lora + attach_lora) on the base: evaluate over "
              f"{eval_forwards} batches of (2, 2048) in {t_eval:.3f} s, {device_ms:.1f} ms of "
              f"device time (busy {100 * device_ms / 1e3 / t_eval:.1f}%); eval loss kernels "
              f"{ev_k:.6f}, main's {res2['eval_loss']:.6f}, plain {ev_p:.6f} (relative "
              f"{rel_k:.3e} / {rel_main:.3e}, tol {TRAIN_LOSS_TOL}); launches {got_eval} "
              f"(walk: {want_eval}) ({card})", flush=True)
        check(rel_k <= TRAIN_LOSS_TOL and rel_main <= TRAIN_LOSS_TOL,
              f"sft eval: kernels {ev_k}, main {res2['eval_loss']}, plain {ev_p}")
        check(got_eval == want_eval, f"sft eval: launches {got_eval} != {want_eval}")
        stats.update(eval_s=t_eval, eval_device_ms=device_ms, eval_busy=device_ms / 1e3 / t_eval)
        del trainer, lora, prof
        ids = torch.as_tensor(np.random.RandomState(3).randint(3, vocab, (1, SFT_PROMPT_LEN)),
                              device=dev)

        def prefill():
            with torch.inference_mode():
                return base(ids, cache=base.init_cache(1, SFT_PROMPT_LEN + 1))[0].float()

        attached = prefill()
        merge_lora_into_model(base)
        merged = prefill()
        rel_merge = rel_l2(merged, attached)
        merged_dir = os.path.join(tmp, "merged")
        t0 = time.perf_counter()
        check(cli.main(["merge-lora", base_dir, os.path.join(out_dir, "lora"), merged_dir,
                        "--dtype", "bf16", "--device", str(dev)]) == 0, "cli merge-lora failed")
        t_cli = time.perf_counter() - t0
        gc.collect()
        ours = torch_to_flax_state_dict(base, base.flax_key_map)
        theirs = load_flat_state(merged_dir)
        differ = [k for k, v in ours.items() if not torch.equal(v, theirs[k].to(dev))]
        print(f"[sft adapter] merge_lora_into_model: prefill logits over {SFT_PROMPT_LEN} "
              f"tokens, merged vs LoRA-attached relative L2 {rel_merge:.3e} (tol "
              f"{LLAMA_AGREE_TOL}); cli merge-lora {t_cli:.1f} s: {len(theirs)} tensors, "
              f"{len(differ)} not bit-equal to the merged model's {differ[:3]} ({card})",
              flush=True)
        check(bool(torch.isfinite(merged).all()) and rel_merge <= LLAMA_AGREE_TOL,
              f"sft adapter: merged logits {rel_merge}")
        check(ours.keys() == theirs.keys() and not differ, f"sft adapter: cli merge-lora "
              f"differs in {differ[:5]}")
        stats.update(merge_rel_l2=rel_merge, cli_merge_s=t_cli)
        del base, ours, theirs, merged, attached
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return add(got1, got2), got_eval, stats


# ---------------------------------------------------------------- CLIP slice
# CLIP ViT-B/16 at the JAX bench's widths (models/clip/vitb16.py VITB16, the
# recipe of examples/train_clip.py), batch 256: the rows of B10 (LayerNorm)
# and its backward on the path: the vision tower's 256 x 197 tokens, the text
# tower's 256 x 77 and the pooled CLS rows (every 197th row of the tokens, a
# strided slice). The other CLIP-family towers launch B10 too, at rows of
# their own: SDXL's and SD3's text towers 77 a prompt at 768 (CLIP-L) and
# 1280 (bigG, the only width with 2 rows a program), LLaVA's ViT-L/14-336 577
# at 1024. (rows, width, row stride in rows)
CLIP_LN_SHAPES = [(50432, 768, 1), (19712, 512, 1), (256, 768, 197), (77, 768, 1),
                  (77, 1280, 1), (577, 1024, 1)]
# B10 forward: fp32 math rounded once to bf16 against the fp32 plain version,
# |out - ref| <= 2**-7 |ref| + LN_SUM |ref|max; the control (variance taken
# as mean(x^2), the mean not subtracted) must fail it. Backward: dx the same
# with LN_BWD_SUM; dw and db fp32 sums in another order, within LN_DW_TOL of
# |ref|max; controls: dx without its mean(g w) term, and dw and db of the
# first program's rows alone.
LN_SUM, LN_BWD_SUM, LN_DW_TOL = 1e-6, 1e-5, 1e-4
# B10's forward beyond the path's bf16 rows, each with the gate and the
# control: ((rows, width), x dtype, x one element past a 16-byte boundary): a
# misaligned view (the one-element form), fp32 x at the text tower's rows and
# at LLaVA's tower's, a ragged width (no whole 16 bytes a row) at many rows
LN_EXTRA_CASES = [((77, 768), "bf16", True), ((19712, 512), "fp32", False),
                  ((577, 1024), "fp32", False), ((3000, 100), "bf16", False)]
CLIP_FORWARDS = 12  # timed bench forwards (after 2 warm-up ones)
# optimizer steps of build_trainer -> Trainer.train (10 until the InternVL2 and Qwen-VL phases)
CLIP_TRAIN_STEPS = 6
CLIP_TRAIN_SAMPLES = 2560  # seeded (pixels, caption) pairs: one epoch of 10 batches
# clip train agree, against two plain versions one rounding apart (the pair).
# The loss is one number, a single draw of the rounding noise that the pair
# samples once, so its gap is held within CLIP_LOSS_RATIO of the pair's (the
# kernels read 2.6x on an H100). The gradients are held by TRAIN_AGREE_RATIO:
# the median gap over every parameter, and the largest over the parameters
# whose plain gradient stands above the rounding noise, those the pair moves
# by at most CLIP_SIGNAL_GAP of their norm (the key projections' biases have
# a true gradient of 0, softmax being blind to a shift common to a row: the
# pair moves them by more than their norm).
CLIP_LOSS_RATIO, CLIP_SIGNAL_GAP = 10, 0.5

# ------------------------------------------------------------ EVA-CLIP slice
# EVA02-CLIP-B/16 (models/clip/eva02_b16.py EVA02_B16, EVA-CLIP's published
# EVA02-CLIP-B-16.json) at batch 256. Its tower's B10 rows are the CLIP
# tower's (50,432 x 768 for norm1, norm2 and inner_attn_ln, the pooled CLS
# rows, the text tower's 19,712 x 512) and the sub-LN ffn_ln's 50,432 x 2,048,
# the first rows wider than 1,280 that B10 takes (its wide form); a ragged
# width beside it. (rows, width, row stride in rows)
EVA_LN_SHAPES = [(50432, 2048, 1), (1000, 1960, 1)]
# B10 forward and backward at the wide form's other plans, each with the
# gates and controls: ((rows, width), x dtype, x one element past a 16-byte
# boundary): one cluster, fp32 rows (one ring stage), the one-element form
# (dx, g and x read from device memory a pass), the narrowest wide width
LN_WIDE_EXTRA_CASES = [((77, 2048), "bf16", False), ((3000, 2048), "fp32", False),
                       ((3000, 2048), "bf16", True), ((5000, 1288), "bf16", False)]
# BLIP-2 OPT-2.7B captioning (Salesforce/blip2-opt-2.7b, models/blip2/opt27b.py),
# batch 1, the prompt OPT's BOS alone: B10's rows on the path (the ViT-g's 257
# tokens at 1,408, the Q-Former's 32 queries at 768, OPT's prefill of the 32
# query features and the id, and its decode rows, at 2,560)
BLIP2_LN_SHAPES = [(257, 1408), (32, 768), (33, 2560), (1, 2560)]
# B7 at OPT's head_dim 80, (B, Hq, KVH, D, L, lengths): 32 heads over 64
# slots at length 40, a ragged pair of sequences, a caption's last step (65
# keys: the 33-token prefill and 32 new ones)
BLIP2_DECODE_CASES = [(1, 32, 32, 80, 64, (40,)), (2, 32, 32, 80, 96, (90, 17)),
                      (1, 32, 32, 80, 65, (64,))]
# caption requests, one 640 x 480 jpeg each (three until the DiT and PixArt phases)
BLIP2_REQUESTS = 2
BLIP2_AGREE_STEPS = 4   # decode steps after the prefill in the agree
# Appflow zero-shot requests, one 640 x 480 jpeg each (3 until the InternVL2 and Qwen-VL phases)
EVA_REQUESTS = 2
EVA_LABELS = 1000       # candidate labels a request, classes of the eval (ImageNet-1k's)
EVA_EVAL_IMAGES = 256   # generated jpegs of the zero-shot eval, one batch
EVA_TRAIN_STEPS = 6  # 10 until the InternVL2 and Qwen-VL phases
EVA_TRAIN_SAMPLES = 512  # seeded (pixels, caption) pairs: 2 batches of 256 an epoch
EVA_CONFIG = os.path.join(REPO, "configs", "eva_clip", "pretrain_b16.json")
# the recipe's cuts: 6 steps, the warmup of 2,000 steps cut to 2 (cosine
# needs more steps than warmup), no checkpoints, logging every step (the
# profiler steps on the logging callback)
EVA_TRAIN_OVERRIDES = dict(max_steps=EVA_TRAIN_STEPS, warmup_steps=2, save_steps=0,
                           logging_steps=1)
CLIP_MAIN_STEPS, CLIP_MAIN_BATCH = 4, 64  # tools/train_clip.main --synthetic


def ln_no_mean(x, w, b, eps):
    """The forward control: B10 with the variance taken as mean(x^2)."""
    xf = x.float()
    y = (xf - xf.mean(-1, keepdim=True)) * (xf * xf).mean(-1, keepdim=True).add(eps).rsqrt()
    return (y * w.float() + b.float()).to(x.dtype)


def ln_stride_ignored(norms):
    """The loss's control: B10 reading its rows as if they lay one after
    another, the row stride ignored, so that the pooled x[:, 0] reads the
    first images' tokens instead of each image's first."""
    def forward(x, w, b, eps):
        h = x.shape[-1]
        rows = x if x.is_contiguous() else x.as_strided((x.numel() // h, h), (h, 1))
        return norms.layer_norm_ref(rows, w, b, eps).reshape(x.shape)
    return forward


def ln_rounded(x, w, b, eps):
    """A plain LayerNorm one rounding apart from B10's: the normalised rows
    rounded to x's dtype before the fp32 affine (flax's LayerNorm under a
    bf16 dtype rounds there too)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xhat = ((xf - mu) * (xf - mu).square().mean(-1, keepdim=True).add(eps).rsqrt()).to(x.dtype)
    return (xhat.float() * w.float() + b.float()).to(x.dtype)


def ln_first_rows(norms, rows, h, esize):
    """The rows of the LayerNorm backward's first partial sum: its first
    cluster's (csrc/norms.cu's plan), or its first block's where one cluster
    takes every row. dw and db of these rows alone are the controls."""
    plan = norms.layer_norm_bwd_plan(rows, h, esize)
    if plan.clusters > 1:
        return len(plan.cluster_rows(0, rows))
    return min(rows, plan.warps * plan.rpw)


def group_norm_walks():
    """B4's launches by (wrapper, (B, H, W, C), act) in one request or
    training step of each path, from the module walks (diffusers/sdxl.py
    `unet_group_norm_calls`, `vae_group_norm_calls`): SDXL in bf16 and under
    static a8w8 (whose resnets take B5's statistics), SD3 (its VAE), SD1.5 and
    an SD1.5 training step at batch 8."""
    from paddlemix_tpu_torch.diffusers import sd3, sd15, sdxl

    def times(calls, k):
        return collections.Counter({key: n * k for key, n in calls.items()})
    lat = HEIGHT // 8
    return {
        "sdxl_bf16": times(sdxl.unet_group_norm_calls(sdxl.SDXL_UNET, 2, lat), STEPS)
        + sdxl.vae_group_norm_calls(sdxl.SDXL_VAE, lat),
        "sdxl_a8w8": times(sdxl.unet_group_norm_calls(sdxl.SDXL_UNET, 2, lat, fused=True), STEPS)
        + sdxl.vae_group_norm_calls(sdxl.SDXL_VAE, lat, fused=True),
        "sd3": sdxl.vae_group_norm_calls(sd3.SD3_VAE, lat),
        "sd15": times(sdxl.unet_group_norm_calls(sd15.SD15_UNET, 2, SD15_SIZE // 8), SD15_STEPS)
        + sdxl.vae_group_norm_calls(sd15.SD15_VAE, SD15_SIZE // 8),
        "sd15_train": sdxl.unet_group_norm_calls(sd15.SD15_UNET, SD15_TRAIN_BATCH, SD15_SIZE // 8),
    }


def device_ops(torch, fn):
    """The kernels (device operations) one call of `fn` runs, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.self_device_time_total > 0}


def replays_agree(torch, fn, want):
    """fn's outputs, captured once in a CUDA graph and replayed three times,
    equal `want` bit for bit at every replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    ok = True
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        ok &= all(torch.equal(a, b) for a, b in zip(out, want))
    return ok


def norms_kernels(torch, dev, gen, record, norms):
    """csrc/norms.cu beyond the per-element GroupNorm cases: the library's
    plans against the wrappers' mirrors at every B4 shape the paths give (the
    module walks) and the lists', and the LayerNorm backward's at the CLIP
    rows and ragged ones, with the clusters each plan's launch shape runs at
    once; B4's statistics per element at FUSED_CASES' shapes and a ragged one,
    with a control; two launches bit-identical and CUDA-graph replays equal
    to them (B4 in both forms, its statistics, the backward with one cluster
    and with several, whose tickets every launch leaves at 0); kernels a call
    by the profiler."""
    bf16, f32 = torch.bfloat16, torch.float32
    walks = group_norm_walks()
    for path, calls in walks.items():
        by = collections.Counter()
        for (name, _, _), n in calls.items():
            by[name] += n
        print(f"[norms] B4 launches a {'step' if 'train' in path else 'request'} by the walks, "
              f"{path}: {dict(by)}; by (wrapper, shape): "
              f"{sorted(calls.items())}", flush=True)
    shapes = {(name, shape) for calls in walks.values() for name, shape, _ in calls}
    shapes |= {("group_norm", s) for s, _ in GN_CASES + SD15_GN_CASES + SD15_TRAIN_GN_CASES}
    shapes |= {("group_norm", GN_RAGGED)} | {("group_norm_stats", s) for s, _, _ in FUSED_CASES}
    shapes |= {("group_norm_stats", FUSED_RAGGED[0])}
    checked = 0
    for name, shape in sorted(shapes):
        b_, c = shape[0], shape[-1]
        n = shape[1] * shape[2]
        for dtype in (bf16, f32):
            for stats in ({True} if name == "group_norm_stats" else {False, True}):
                mirror = norms.group_norm_plan(b_, n, c, 32, torch.empty(0, dtype=dtype)
                                               .element_size(), stats=stats)
                lib = norms.group_norm_plan_library(b_, n, c, 32, dtype, stats=stats)
                check(mirror == lib, f"group_norm plan {name} {shape} {dtype} stats {stats}: the "
                                     f"library's {lib}, the mirror's {mirror}")
                checked += 1
        plan = norms.group_norm_plan(b_, n, c, 32, 2, stats=name == "group_norm_stats")
        kind = 0 if plan.form == norms.RESIDENT else 1
        most = norms.norms_max_clusters(kind, plan.threads, plan.smem, plan.cluster)
        clusters = b_ * (c // plan.slab)
        print(f"[norms] {name} {shape} bf16: {plan} | {clusters} clusters, {most} run at once "
              f"({'one wave' if clusters <= most else 'more than one wave'})", flush=True)
    ln_cases = [(r, h) for r, h, _ in CLIP_LN_SHAPES + EVA_LN_SHAPES] + [(1000, 200), (3000, 100)] \
        + [shape for shape, _, _ in LN_WIDE_EXTRA_CASES]
    for rows, h in ln_cases:
        for dtype in (bf16, f32):
            for aligned in (True, False):
                es = torch.empty(0, dtype=dtype).element_size()
                mirror = norms.layer_norm_bwd_plan(rows, h, es, aligned)
                lib = norms.layer_norm_bwd_plan_library(rows, h, dtype, aligned)
                check(mirror == lib, f"layer_norm_bwd plan {(rows, h)} {dtype} aligned {aligned}: "
                                     f"the library's {lib}, the mirror's {mirror}")
                checked += 1
        plan = norms.layer_norm_bwd_plan(rows, h, 2)
        wide = plan.epl > norms.LN_HOLD_EPL  # the wide form: one block an SM
        most = norms.norms_max_clusters(3 if wide else 2, plan.warps * 32, plan.smem, plan.cluster)
        print(f"[norms] layer_norm_backward {(rows, h)} bf16 ({'wide' if wide else 'held'} "
              f"form): {plan} | {most} clusters run at once", flush=True)
    print(f"[norms] {checked} plans: the library's equal the mirrors'", flush=True)

    # B4's statistics per element, with the control
    for shape in [s for s, _, _ in FUSED_CASES] + [FUSED_RAGGED[0]]:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev)
             * (0.5 + 1.5 * torch.rand(c, generator=gen, device=dev))
             + torch.randn(c, generator=gen, device=dev)).to(bf16)
        mean, rstd = norms.group_norm_stats(x, 32, 1e-5)
        torch.cuda.synchronize()
        rmean, rrstd = norms._group_moments(x.float(), 32, 1e-5)

        def gap(m, r):
            return max(((m - rmean).abs() * rrstd).max().item(), (r / rrstd - 1).abs().max().item())
        err = gap(mean, rstd)
        xf = x.float()
        sq = (xf * xf).mean(dim=tuple(range(1, x.ndim - 1))).reshape(shape[0], 32, -1).mean(-1)
        control = gap(rmean, torch.rsqrt(sq + 1e-5))
        print(f"[norms] group_norm_stats {shape} bf16: {err:.3e} of the group's std and of rstd "
              f"(tol {GN_STATS_TOL}); control, rstd from E[x^2]: {control:.3e} (must exceed the "
              f"tol)", flush=True)
        check(bool(torch.isfinite(rstd).all()) and err <= GN_STATS_TOL,
              f"group_norm_stats {shape}: {err}")
        check(control > GN_STATS_TOL, f"group_norm_stats {shape}: the control passes ({control})")
        ms, plain_ms = timed_pair(torch, lambda: norms.group_norm_stats(x, 32, 1e-5),
                                  lambda: norms._group_moments(x, 32, 1e-5))
        # one pass over x: bytes bound it; no single PyTorch call computes it
        record("kernels", "group_norm_stats", shape, err, ms, plain_ms, None,
               bound(nbytes(x, mean, rstd), 3 * x.numel(), "fp32"))
        del x, xf

    # bit-identical launches, CUDA-graph replays, kernels a call
    for shape in [(2, 32, 32, 1280), (2, 128, 128, 320), GN_RAGGED]:
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        w = (1 + 0.05 * torch.randn(c, generator=gen, device=dev)).to(bf16)
        b = (0.05 * torch.randn(c, generator=gen, device=dev)).to(bf16)
        plan = norms.group_norm_plan(shape[0], shape[1] * shape[2], c, 32, 2)
        y1, y2 = (norms.group_norm(x, w, b, 32, 1e-5, "silu") for _ in range(2))
        s1, s2 = (norms.group_norm_stats(x, 32, 1e-5) for _ in range(2))
        same = torch.equal(y1, y2) and all(map(torch.equal, s1, s2))
        replay = replays_agree(torch, lambda: (norms.group_norm(x, w, b, 32, 1e-5, "silu"),), (y1,)) \
            and replays_agree(torch, lambda: norms.group_norm_stats(x, 32, 1e-5), s1)
        ops = device_ops(torch, lambda: norms.group_norm(x, w, b, 32, 1e-5, "silu"))
        ops_stats = device_ops(torch, lambda: norms.group_norm_stats(x, 32, 1e-5))
        print(f"[norms] group_norm {shape} ({'resident' if plan.form == norms.RESIDENT else 're-read'}"
              f" form): two launches bit-identical {same}, graph replays equal {replay}; kernels a "
              f"call {ops} (want {plan.launches()}), statistics {ops_stats} (want 1)", flush=True)
        check(same and replay, f"group_norm {shape}: launches differ")
        check(sum(ops.values()) == plan.launches() and sum(ops_stats.values()) == 1,
              f"group_norm {shape}: kernels a call {ops}, {ops_stats}")
        del x
    for rows, h in [(19712, 512), (577, 1024), (77, 768), (8192, 2048), (77, 2048)]:
        x = torch.randn((rows, h), generator=gen, device=dev).to(bf16)
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        g = torch.randn((rows, h), generator=gen, device=dev).to(bf16)
        plan = norms.layer_norm_bwd_plan(rows, h, 2)
        o1, o2 = (norms.layer_norm_backward(x, w, g, 1e-5) for _ in range(2))
        same = all(map(torch.equal, o1, o2))
        replay = replays_agree(torch, lambda: norms.layer_norm_backward(x, w, g, 1e-5), o1)
        ops = device_ops(torch, lambda: norms.layer_norm_backward(x, w, g, 1e-5))
        tickets = norms._tickets(dev).cpu().tolist()
        print(f"[norms] layer_norm_backward {(rows, h)} ({plan.clusters} cluster(s) of "
              f"{plan.cluster}): two launches bit-identical {same}, graph replays equal {replay}; "
              f"kernels a call {ops} (want 1); tickets after {tickets}", flush=True)
        check(same and replay and sum(ops.values()) == 1 and not any(tickets),
              f"layer_norm_backward {(rows, h)}: {same}, {replay}, {ops}, {tickets}")
        del x, g


def row_norm_checks(torch, dev, gen, norms):
    """B11's forward, B12, B13 and B10's forward beyond the per-element cases:
    the library's plans against the wrappers' mirrors at every path shape and
    the extra cases', in each dtype, aligned and not; two launches
    bit-identical, CUDA-graph replays equal to them, and one launch counted a
    call, at every path shape."""
    bf16 = torch.bfloat16
    checked = 0
    for rows, h in RMS_SHAPES + [shape for shape, _, _, _ in RMS_EXTRA_CASES]:
        for dtype in (bf16, torch.float16, torch.float32):
            for aligned in (True, False):
                es = torch.empty(0, dtype=dtype).element_size()
                mirror = norms.rms_norm_plan(rows, h, es, aligned)
                lib = norms.rms_norm_plan_library(rows, h, dtype, aligned)
                check(mirror == lib, f"rms_norm plan {(rows, h)} {dtype} aligned {aligned}: the "
                                     f"library's {lib}, the mirror's {mirror}")
                checked += 1
    for shape in ADALN_SHAPES + [shape for shape, _, _ in ADALN_EXTRA_CASES]:
        for aligned in (True, False):
            mirror, lib = norms.adaln_plan(*shape, aligned), norms.adaln_plan_library(*shape, aligned)
            check(mirror == lib, f"adaln plan {shape} aligned {aligned}: the library's {lib}, "
                                 f"the mirror's {mirror}")
            mirror = norms.fused_adaln_plan(*shape, aligned)
            lib = norms.fused_adaln_plan_library(*shape, aligned)
            check(mirror == lib, f"fused_adaln plan {shape} aligned {aligned}: the library's "
                                 f"{lib}, the mirror's {mirror}")
            checked += 2
    for rows, h in [(r, h) for r, h, _ in CLIP_LN_SHAPES] + [sh for sh, _, _ in LN_EXTRA_CASES] \
            + BLIP2_LN_SHAPES:
        for dtype in (bf16, torch.float32):
            for aligned in (True, False):
                es = torch.empty(0, dtype=dtype).element_size()
                mirror = norms.layer_norm_plan(rows, h, es, aligned)
                lib = norms.layer_norm_plan_library(rows, h, dtype, aligned)
                check(mirror == lib, f"layer_norm plan {(rows, h)} {dtype} aligned {aligned}: "
                                     f"the library's {lib}, the mirror's {mirror}")
                checked += 1
    print(f"[row norms] {checked} plans: the library's equal the mirrors'", flush=True)
    for rows, h in RMS_SHAPES:
        x = (3 * torch.randn((rows, h), generator=gen, device=dev)).to(bf16)
        w = 1 + 0.1 * torch.randn(h, generator=gen, device=dev)
        before = norms.rms_norm.launches
        y1, y2 = (norms.rms_norm(x, w, 1e-5) for _ in range(2))
        counted = norms.rms_norm.launches - before
        same = torch.equal(y1, y2)
        replay = replays_agree(torch, lambda: (norms.rms_norm(x, w, 1e-5),), (y1,))
        print(f"[row norms] rms_norm {(rows, h)}: {norms.rms_norm_plan(rows, h, 2)} | two launches "
              f"bit-identical {same}, graph replays equal {replay}; launches counted {counted} "
              f"for 2 calls", flush=True)
        check(same and replay and counted == 2, f"rms_norm {(rows, h)}: {same}, {replay}, "
                                                f"{counted}")
    for shape in ADALN_SHAPES:
        b_, _, h_ = shape
        x = (2 * torch.randn(shape, generator=gen, device=dev)).to(bf16)
        mod = torch.randn((b_, 6 * h_), generator=gen, device=dev).to(bf16)
        shift, scale, gate = mod.chunk(6, -1)[:3]
        before = norms.adaptive_layer_norm.launches
        y1, y2 = (norms.adaptive_layer_norm(x, scale, shift) for _ in range(2))
        counted = norms.adaptive_layer_norm.launches - before
        same = torch.equal(y1, y2)
        replay = replays_agree(torch, lambda: (norms.adaptive_layer_norm(x, scale, shift),), (y1,))
        print(f"[row norms] adaptive_layer_norm {shape}: {norms.adaln_plan(*shape)} | two launches "
              f"bit-identical {same}, graph replays equal {replay}; launches counted {counted} "
              f"for 2 calls", flush=True)
        check(same and replay and counted == 2, f"adaptive_layer_norm {shape}: {same}, "
                                                f"{replay}, {counted}")
        residual = x.flip(-1)
        before = norms.fused_adaln_scale_residual.launches
        o1, o2 = (norms.fused_adaln_scale_residual(residual, x, gate, scale, shift)
                  for _ in range(2))
        counted = norms.fused_adaln_scale_residual.launches - before
        same = all(map(torch.equal, o1, o2))
        replay = replays_agree(
            torch, lambda: norms.fused_adaln_scale_residual(residual, x, gate, scale, shift), o1)
        print(f"[row norms] fused_adaln_scale_residual {shape}: {norms.fused_adaln_plan(*shape)} | "
              f"two launches bit-identical {same}, graph replays equal {replay}; launches "
              f"counted {counted} for 2 calls", flush=True)
        check(same and replay and counted == 2, f"fused_adaln_scale_residual {shape}: {same}, "
                                                f"{replay}, {counted}")
    for rows, h, span in CLIP_LN_SHAPES:
        x = (2 * torch.randn((rows, span, h), generator=gen, device=dev)).to(bf16)[:, 0]
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        before = norms.layer_norm.launches
        y1, y2 = (norms.layer_norm(x, w, b, 1e-5) for _ in range(2))
        counted = norms.layer_norm.launches - before
        same = torch.equal(y1, y2)
        replay = replays_agree(torch, lambda: (norms.layer_norm(x, w, b, 1e-5),), (y1,))
        stride = f" (row stride {span * h})" if span > 1 else ""
        print(f"[row norms] layer_norm {(rows, h)}{stride}: {norms.layer_norm_plan_of(x, w, b)} | "
              f"two launches bit-identical {same}, graph replays equal {replay}; launches "
              f"counted {counted} for 2 calls", flush=True)
        check(same and replay and counted == 2, f"layer_norm {(rows, h)}: {same}, {replay}, "
                                                f"{counted}")
        del x, y1, y2


def floor_ms(torch, norms, blocks, threads, copies):
    """An empty kernel of a plan's launch shape (blocks x threads), timed as a
    kernel of that plan is: `copies` launches (the kernel's pass through its
    cold copies, at least 10) in one CUDA graph."""
    return cuda_ms(torch, lambda: norms.empty_launch(blocks, threads), iters=copies)


def norm_kernel_note(norms, plan, op, fp32=False):
    """The kernel of csrc/norms.cu that a B13 (op OP_FUSED) or B10-forward
    (OP_LN, of bf16 or `fp32` rows) plan launches, with ptxas's registers and
    spills for it (a spill fails the run)."""
    form = "warp" if plan.form == norms.NORM_WARP else "row"
    args = [] if op == norms.OP_FUSED else ["f" if fp32 else "13__nv_bfloat16"]
    args += [] if form == "warp" else [f"Li{plan.vec}E"]
    args += [f"Li{plan.cpt}E"]
    name = f"{'fused_adaln_residual' if op == norms.OP_FUSED else 'layer_norm_fwd'}_{form}_kernel"
    regs, spills = ptxas_counts("norms", f"{name}I{''.join(args)}E")
    check(spills in ("spills 0 / 0 bytes", "not in this run's build log"),
          f"{name} {plan}: {spills}")
    return f"{name} ({plan}); ptxas {regs} registers, {spills}"


def offset_copy(torch, t):
    """t's values in a contiguous tensor that starts one element past a
    16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def rms_kernels(torch, F, dev, gen, record, norms, shapes=RMS_SHAPES, extra=RMS_EXTRA_CASES,
                label="llava kernels"):
    """B11's forward against its plain version: per element (RMS_SUM) with the
    control (the plain version without the weight) that must fail, at the
    path's shapes (times, bounds, library times and the floor) and at the
    `extra` cases."""
    bf16 = torch.bfloat16
    dts = {"bf16": bf16, "fp32": torch.float32}
    cases = [(shape, "bf16", "fp32", False, True) for shape in shapes] + \
        [case + (False,) for case in extra]
    for (rows, h), xd, wd, misaligned, timed in cases:
        x = (3 * torch.randn((rows, h), generator=gen, device=dev)).to(dts[xd])
        if misaligned:
            x = offset_copy(torch, x)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(dts[wd])
        out = norms.rms_norm(x, w, 1e-5)
        torch.cuda.synchronize()
        ref = norms.rms_norm_ref(x.float(), w, 1e-5)
        err = (out.float() - ref).abs().max().item()
        excess, need = ulp_gate(out, ref, RMS_SUM)
        control, _ = ulp_gate(norms.rms_norm_ref(x.float(), torch.ones_like(w), 1e-5), ref, RMS_SUM)
        plan = norms.rms_norm_plan_of(x, w)
        case = f"{(rows, h)} {xd} x, {wd} weight{', x misaligned' if misaligned else ''}"
        print(f"[{label}] rms_norm {case}: max_abs_err {err:.3e}, excess {excess:.3e} over "
              f"2**-7|ref| + {RMS_SUM:g}|ref|max (least c {need:.2e}); control without the "
              f"weight: excess {control:.3e} (must be > 0) | {plan}", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0, f"rms_norm {case}: excess {excess}")
        check(control > 0, f"rms_norm {case}: the control passes ({control})")
        if not timed:
            continue
        kernel = cold(lambda x_: norms.rms_norm(x_, w, 1e-5), x, nbytes(x))
        ms, plain_ms = timed_pair(torch, kernel,
                                  cold(lambda x_: norms.rms_norm_ref(x_, w, 1e-5), x, nbytes(x)))
        w16 = w.to(bf16)
        lib_ms = library_ms(torch, cold(lambda x_: F.rms_norm(x_, (h,), w16, 1e-5), x, nbytes(x)))
        floor = floor_ms(torch, norms, plan.blocks, plan.threads, kernel.copies)
        record(label, "rms_norm", (rows, h), err, ms, plain_ms, lib_ms,
               bound(nbytes(x, w, out), 4 * x.numel(), "fp32"), floor=floor)
        del x, out, ref


def adaln_extra_cases(torch, dev, gen, norms):
    """B12 and B13 at ADALN_EXTRA_CASES, per element (ADALN_SUM) with the
    controls (the plain version without the shift, or without the gate) that
    must fail."""
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for shape, md, misaligned in ADALN_EXTRA_CASES:
        b_, _, h_ = shape
        x = (2 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
        residual = (2 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
        if misaligned:
            x = offset_copy(torch, x)
        mod = torch.randn((b_, 6 * h_), generator=gen, device=dev).to(dts[md])
        shift, scale, gate = mod.chunk(6, -1)[:3]
        out = norms.adaptive_layer_norm(x, scale, shift)
        torch.cuda.synchronize()
        ref = norms.adaptive_layer_norm_ref(x, scale, shift)
        excess, need = ulp_gate(out, ref, ADALN_SUM)
        control, _ = ulp_gate(norms.adaptive_layer_norm_ref(x, scale, 0 * shift), ref, ADALN_SUM)
        label = f"{shape} {md} modulation{', x misaligned' if misaligned else ''}"
        print(f"[sd3 kernels] adaptive_layer_norm {label}: excess {excess:.3e} (least c "
              f"{need:.2e}); control without the shift: excess {control:.3e} (must be > 0) | "
              f"{norms.adaln_plan_of(x, scale, shift)}", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"adaptive_layer_norm {label}: excess {excess}")
        check(control > 0, f"adaptive_layer_norm {label}: the control passes ({control})")
        y, resi = norms.fused_adaln_scale_residual(residual, x, gate, scale, shift)
        torch.cuda.synchronize()
        ref_y, ref_r = norms.fused_adaln_scale_residual_ref(residual, x, gate, scale, shift)
        (ex_y, need_y), (ex_r, need_r) = ulp_gate(y, ref_y, ADALN_SUM), ulp_gate(resi, ref_r,
                                                                                  ADALN_SUM)
        ungated = norms.fused_adaln_scale_residual_ref(residual, x, torch.ones_like(gate), scale,
                                                       shift)
        control = max(ulp_gate(ungated[0], ref_y, ADALN_SUM)[0],
                      ulp_gate(ungated[1], ref_r, ADALN_SUM)[0])
        print(f"[sd3 kernels] fused_adaln_scale_residual {label}: excess y {ex_y:.3e} resi "
              f"{ex_r:.3e} (least c {max(need_y, need_r):.2e}); control without the gate: excess "
              f"{control:.3e} (must be > 0) | "
              f"{norms.fused_adaln_plan_of(residual, x, gate, scale, shift)}", flush=True)
        check(bool(torch.isfinite(y).all() and torch.isfinite(resi).all())
              and max(ex_y, ex_r) <= 0, f"fused_adaln_scale_residual {label}: {ex_y}, {ex_r}")
        check(control > 0, f"fused_adaln_scale_residual {label}: the control passes ({control})")
        del x, residual, out, ref, y, resi, ref_y, ref_r, ungated


def ln_extra_cases(torch, dev, gen, norms):
    """B10's forward at LN_EXTRA_CASES, per element (LN_SUM) with the control
    (the variance without the mean subtracted) that must fail."""
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for (rows, h), xd, misaligned in LN_EXTRA_CASES:
        scale = 0.5 + 2.5 * torch.rand((rows, 1), generator=gen, device=dev)
        x = (torch.randn((rows, h), generator=gen, device=dev) * scale
             + 2 * torch.randn((rows, 1), generator=gen, device=dev)).to(dts[xd])
        if misaligned:
            x = offset_copy(torch, x)
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        y = norms.layer_norm(x, w, b, 1e-5)
        torch.cuda.synchronize()
        ref = norms.layer_norm_ref(x.float(), w, b, 1e-5)
        excess, need = ulp_gate(y, ref, LN_SUM)
        control, _ = ulp_gate(ln_no_mean(x.float(), w, b, 1e-5), ref, LN_SUM)
        label = f"{(rows, h)} {xd}{', x misaligned' if misaligned else ''}"
        print(f"[clip kernels] layer_norm {label}: excess {excess:.3e} (least c {need:.2e}); "
              f"control, the variance without the mean subtracted: excess {control:.3e} (must be "
              f"> 0) | {norms.layer_norm_plan_of(x, w, b)}", flush=True)
        check(bool(torch.isfinite(y).all()) and y.dtype == x.dtype and excess <= 0,
              f"layer_norm {label}: excess {excess}")
        check(control > 0, f"layer_norm {label}: the control passes ({control})")
        del x, y, ref


def clip_kernels(torch, F, dev, gen, record, norms, shapes=CLIP_LN_SHAPES, backward=True,
                 label="clip kernels"):
    """B10 and (with `backward`) its backward against their plain versions at
    `shapes` (the CLIP path's rows by default), each gate with its controls;
    times, bounds and library times (F.layer_norm and its backward, bf16
    weight and bias); the backward's kernel and ptxas's counts for it."""
    bf16 = torch.bfloat16
    for rows, h, span in shapes:
        pooled = span > 1
        # rows with their own offsets and scales, as a residual stream's; the
        # pooled rows are every 197th row of a token tensor, as x[:, 0] is
        base = torch.randn((rows, span, h), generator=gen, device=dev)
        scale = 0.5 + 2.5 * torch.rand((rows, 1, 1), generator=gen, device=dev)
        offset = 2 * torch.randn((rows, 1, 1), generator=gen, device=dev)
        x = (base * scale + offset).to(bf16)[:, 0]
        del base
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        g = torch.randn((rows, h), generator=gen, device=dev).to(bf16) if backward else None
        shape = (rows, h)
        y = norms.layer_norm(x, w, b, 1e-5)
        torch.cuda.synchronize()
        ref = norms.layer_norm_ref(x.float(), w, b, 1e-5)
        excess, need = ulp_gate(y, ref, LN_SUM)
        ctrl, _ = ulp_gate(ln_no_mean(x.float(), w, b, 1e-5), ref, LN_SUM)
        print(f"[{label}] layer_norm {shape}{' (pooled rows, a strided slice)' if pooled else ''}"
              f" bf16: excess {excess:.3e} (least c {need:.2e}, c {LN_SUM}); control, the "
              f"variance without the mean subtracted: excess {ctrl:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(y).all()) and excess <= 0, f"layer_norm {shape}: {excess}")
        check(ctrl > 0, f"layer_norm {shape}: the control passes ({ctrl})")
        if backward:
            ln_backward_case(torch, F, record, norms, label, x, w, b, g)
        w16, b16 = w.to(bf16), b.to(bf16)
        kernel = cold(lambda x_: norms.layer_norm(x_, w, b, 1e-5), x, nbytes(x))
        ms, plain_ms = timed_pair(torch, kernel,
                                  cold(lambda x_: norms.layer_norm_ref(x_, w, b, 1e-5), x,
                                       nbytes(x)))
        lib_ms = library_ms(torch, cold(lambda x_: F.layer_norm(x_, (h,), w16, b16, 1e-5), x,
                                        nbytes(x)))
        plan = norms.layer_norm_plan_of(x, w, b)
        floor = floor_ms(torch, norms, plan.nb, plan.threads, kernel.copies)
        copy = cuda_ms(torch, cold(lambda x_: torch.empty_like(x_).copy_(x_), x, nbytes(x)))
        record(label, "layer_norm", shape, (y.float() - ref).abs().max().item(), ms,
               plain_ms, lib_ms, bound(nbytes(x, w, b, y), 8 * x.numel(), "fp32"),
               f" | library: F.layer_norm, bf16 weight and bias | "
               f"{norm_kernel_note(norms, plan, norms.OP_LN)}", floor=floor, copy=copy)
        del x, g, y, ref
    torch.cuda.empty_cache()


def ln_backward_case(torch, F, record, norms, label, x, w, b, g):
    """B10's backward at x's rows for the output gradient g against its
    plain version: dx per element,
    dw and db within LN_DW_TOL of |ref|max, with controls (dx without its
    mean(g w) term; dw and db of the first partial sum's rows alone); times,
    the bound and the library's backward."""
    bf16 = torch.bfloat16
    rows, h = x.shape
    shape = (rows, h)
    dx, dw, db = norms.layer_norm_backward(x, w, g, 1e-5)
    torch.cuda.synchronize()
    rdx, rdw, rdb = norms.layer_norm_backward_ref(x.float(), w, g.float(), 1e-5)
    dx_excess, dx_need = ulp_gate(dx, rdx, LN_BWD_SUM)
    xf, gf = x.float(), g.float()
    xhat = norms.layer_norm_ref(xf, None, None, 1e-5)
    rstd = (xf - xf.mean(-1, keepdim=True)).square().mean(-1, keepdim=True).add(1e-5).rsqrt()
    dxhat = gf * w
    ctrl_dx, _ = ulp_gate(rstd * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True)), rdx,
                          LN_BWD_SUM)
    rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()  # noqa: E731
    dw_err, db_err = rel(dw, rdw), rel(db, rdb)
    first = ln_first_rows(norms, rows, h, 2)
    cdw, cdb = norms.layer_norm_backward_ref(xf[:first], w, gf[:first], 1e-5)[1:]
    ctrl_dwdb = min(rel(cdw, rdw), rel(cdb, rdb))
    print(f"[{label}] layer_norm_backward {shape}: dx excess {dx_excess:.3e} (least c "
          f"{dx_need:.2e}, c {LN_BWD_SUM}); dw / db max err {dw_err:.3e} / {db_err:.3e} "
          f"|ref|max (tol {LN_DW_TOL}); controls: dx without mean(g w) excess {ctrl_dx:.3e} "
          f"(must be > 0), dw / db of the first partial sum's {first} rows alone {ctrl_dwdb:.3e} "
          f"(must be > tol)", flush=True)
    check(bool(torch.isfinite(dx).all()) and dx_excess <= 0 and max(dw_err, db_err) <= LN_DW_TOL,
          f"layer_norm_backward {shape}: dx {dx_excess}, dw {dw_err}, db {db_err}")
    check(ctrl_dx > 0 and ctrl_dwdb > LN_DW_TOL,
          f"layer_norm_backward {shape}: a control passes ({ctrl_dx}, {ctrl_dwdb})")
    w16, b16 = w.to(bf16), b.to(bf16)
    ms, plain_ms = timed_pair(torch, lambda: norms.layer_norm_backward(x, w, g, 1e-5),
                              lambda: norms.layer_norm_backward_ref(x, w, g, 1e-5))
    lib_ms = sum(backward_ms(
        torch, lambda *t: F.layer_norm(t[0], (h,), t[1], t[2], 1e-5),
        tuple(t.detach().clone().requires_grad_() for t in (x, w16, b16)), g)
        for _ in range(2)) / 2
    record(label, "layer_norm_backward", shape,
           (dx.float() - rdx).abs().max().item(), ms, plain_ms, lib_ms,
           bound(nbytes(x, w, g, dx, dw, db), 14 * x.numel(), "fp32"),
           f" | library: the backward of F.layer_norm (x, weight, bias; graph-captured) | "
           f"{ln_bwd_note(norms, rows, h)}")


def clip_slice(torch, np, dev, m, counters):
    """clip and clip train (see the module docstring): the bench forward of
    CLIP ViT-B/16 at batch 256 and its training by the example's recipe.
    `counters` are every kernel wrapper's, by name: the path must launch B10
    and its backward as the walk says, and nothing else. Returns the
    launches of each phase and its numbers."""
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.models.clip import clip_contrastive_loss
    from paddlemix_tpu_torch.models.clip.vitb16 import (
        BENCH_BATCH,
        bench_inputs,
        expected_launches_clip,
        forward_flops,
        pair_logits,
        random_clip,
        seeded_inputs,
    )
    from paddlemix_tpu_torch.tools import train_clip

    bf16 = torch.bfloat16
    norms = m.norms

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def walk(**kw):
        want = expected_launches_clip(model, **kw)
        return {name: want.get(name, 0) for name in counters}

    t0 = time.perf_counter()
    model = random_clip(dev, seed=0)
    # norms as a trained model holds them, not the init's weight 1 / bias 0,
    # whose affine is exact in bf16 (the agree's rounding pair needs one)
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1
                        + name.endswith("weight"))
    torch.cuda.synchronize()
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[clip] CLIP ViT-B/16 built in {time.perf_counter() - t0:.1f} s: {n_params} fp32 "
          f"parameters, bf16 compute", flush=True)

    # ------------------------------------------------- clip: agree, then serve
    plain = [(norms, "_ln_forward", norms.layer_norm_ref),
             (norms, "layer_norm_backward", norms.layer_norm_backward_ref)]
    rounded = [(norms, "_ln_forward", ln_rounded)] + plain[1:]
    px, ids = seeded_inputs(cfg, BENCH_BATCH, seed=1, device=dev)

    def logits(swaps=()):
        with torch.inference_mode(), swapped(swaps):
            return pair_logits(model, px.to(bf16), ids)

    zero()
    lk = logits()
    torch.cuda.synchronize()
    got = launches()
    lp, lr = logits(plain), logits(rounded)
    gap, floor = rel_l2(lk, lp), rel_l2(lr, lp)
    print(f"[clip agree] full-width ViT-B/16 forward at batch {BENCH_BATCH} (seeded pixels, ids "
          f"ending in eos), logits {tuple(lk.shape)} {lk.dtype}: relative L2 kernels vs plain "
          f"{gap:.3e}; two plain versions one rounding apart (the normalised rows rounded to bf16 "
          f"before the affine) {floor:.3e} (ratio tol {TRAIN_AGREE_RATIO}); |logits| max "
          f"{lp.abs().max().item():.3f}; launches {got}", flush=True)
    check(lk.shape == (BENCH_BATCH, BENCH_BATCH) and lk.dtype == torch.float32
          and bool(torch.isfinite(lk).all()), f"clip agree: logits {lk.shape} {lk.dtype}")
    check(gap <= TRAIN_AGREE_RATIO * floor, f"clip agree: kernels vs plain {gap} against {floor}")
    check(got == walk(forwards=1), f"clip agree: launches {got} != {walk(forwards=1)}")
    del lk, lp, lr

    pxb, idsb = bench_inputs(cfg, BENCH_BATCH, dev)
    flops = forward_flops(cfg, BENCH_BATCH)
    with torch.inference_mode():
        for _ in range(2):
            pair_logits(model, pxb, idsb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        seconds = []
        for _ in range(CLIP_FORWARDS):
            t0 = time.perf_counter()
            out = pair_logits(model, pxb, idsb)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        got = launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            pair_logits(model, pxb, idsb)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t_prof
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    device_ms = sum(ms_ for ms_, _, _ in by_kernel)
    pairs = sorted(BENCH_BATCH / s for s in seconds)
    s_med = sorted(seconds)[len(seconds) // 2]
    tflops = flops / s_med / 1e12
    print(f"[clip] {CLIP_FORWARDS} bench forwards at batch {BENCH_BATCH} (zero pixels, ids all "
          f"ones, as bench.py): seconds {[round(s, 4) for s in seconds]}; pairs/s median "
          f"{BENCH_BATCH / s_med:.1f}, spread {pairs[0]:.1f}-{pairs[-1]:.1f}; {tflops:.1f} model "
          f"TFLOP/s ({flops:.4e} flops a forward), {100 * tflops / 989:.1f}% of 989; profiled "
          f"forward {1e3 * t_prof:.2f} ms with {device_ms:.2f} ms of device time: busy "
          f"{100 * device_ms / 1e3 / t_prof:.1f}%; peak memory {peak:.2f} GiB; logits "
          f"{tuple(out.shape)} {out.dtype} finite {bool(torch.isfinite(out).all())}; launches {got}",
          flush=True)
    for ms_, n_, key in by_kernel[:10]:
        print(f"[clip]   profiled forward: {ms_:8.2f} ms {100 * ms_ / device_ms:5.1f}% {n_:5d}x "
              f"{key[:100]}", flush=True)
    check(out.shape == (BENCH_BATCH, BENCH_BATCH) and bool(torch.isfinite(out).all()),
          "clip: bench logits not finite")
    check(got == walk(forwards=CLIP_FORWARDS), f"clip: launches {got} != "
          f"{walk(forwards=CLIP_FORWARDS)}")
    clip_stats = dict(pairs_per_s=BENCH_BATCH / s_med, pairs_min=pairs[0], pairs_max=pairs[-1],
                      tflops=tflops, busy=device_ms / 1e3 / t_prof, peak_gib=peak)
    launches_clip = got
    del out, pxb, idsb

    # ------------------------------------------------------ clip train: agree
    loss_fn = train_clip.clip_loss_fn(model)
    params = [p for p in model.parameters() if p.requires_grad]
    batch = {"pixel_values": px, "input_ids": ids}

    def loss_and_grads(swaps=()):
        with swapped(swaps):
            loss = loss_fn(None, batch, None)[0]
            grads = torch.autograd.grad(loss, params)
        return loss.detach().float(), grads

    def first_rows_backward(x, w, g, eps):
        """The gradients' control: B10's backward with dw and db of the first
        partial sum's rows alone (a reduction that kept one partial)."""
        h = x.shape[-1]
        x2, g2 = x.reshape(-1, h), g.reshape(-1, h)
        first = ln_first_rows(norms, x2.shape[0], h, x.element_size())
        dx = norms.layer_norm_backward_ref(x, w, g, eps)[0]
        return (dx,) + norms.layer_norm_backward_ref(x2[:first], w, g2[:first], eps)[1:]

    zero()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    got = launches()
    loss_p, grads_p = loss_and_grads(plain)
    loss_r, grads_r = loss_and_grads(rounded)
    loss_c, grads_c = loss_and_grads([(norms, "_ln_forward", norms.layer_norm_ref),
                                      (norms, "layer_norm_backward", first_rows_backward)])
    with torch.no_grad(), swapped([(norms, "_ln_forward", ln_stride_ignored(norms))]):
        loss_st = loss_fn(None, batch, None)[0].float()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    gaps = {key: [rel_l2(a.float(), b.float()) for a, b in zip(grads, grads_p)]
            for key, grads in (("kernels", grads_k), ("pair", grads_r), ("control", grads_c))}
    signal = [i for i, gap_ in enumerate(gaps["pair"]) if gap_ <= CLIP_SIGNAL_GAP]

    def median_max(key):
        return (sorted(gaps[key])[len(names) // 2], max(gaps[key][i] for i in signal))

    (k_med, k_max), (r_med, r_max), (c_med, c_max) = map(median_max, ("kernels", "pair", "control"))
    rel_loss = lambda loss: abs(loss - loss_p).item() / abs(loss_p).item()  # noqa: E731
    loss_gap, loss_pair, loss_ctrl = rel_loss(loss_k), rel_loss(loss_r), rel_loss(loss_st)
    noise = sorted((gaps["pair"][i], names[i]) for i in range(len(names)) if i not in signal)
    pair_q = sorted(gaps["pair"])
    quantiles = [f"{pair_q[int(q * (len(names) - 1))]:.3e}" for q in (0.1, 0.5, 0.9, 0.99)]
    worst = max(signal, key=lambda i: gaps["kernels"][i])
    print(f"[clip train agree] {len(signal)} of {len(names)} parameters carry signal (the pair "
          f"moves them by at most {CLIP_SIGNAL_GAP} of their norm; the pair's gaps at the "
          f"10/50/90/99th percentile {quantiles}); left out, rounding noise alone: {len(noise)}, "
          f"{[f'{n_} {g_:.3f}' for g_, n_ in noise]}; the kernels' largest gap among the rest: "
          f"{names[worst]} {gaps['kernels'][worst]:.3e} (the pair "
          f"{gaps['pair'][worst]:.3e})", flush=True)
    print(f"[clip train agree] full-width ViT-B/16, one batch of {BENCH_BATCH}, kernels vs plain: "
          f"loss {loss_k.item():.6f} vs {loss_p.item():.6f} (relative {loss_gap:.3e}; the plain "
          f"versions one rounding apart {loss_pair:.3e}, ratio tol {CLIP_LOSS_RATIO}); relative L2 "
          f"of the parameters' gradients, median of all {len(names)} / max of the {len(signal)} "
          f"with signal: kernels vs plain {k_med:.3e} / {k_max:.3e}, the plain versions one "
          f"rounding apart {r_med:.3e} / {r_max:.3e} (ratio tol {TRAIN_AGREE_RATIO}); controls: "
          f"the loss with B10's row stride ignored (the pooled rows read the first images' "
          f"tokens) {loss_ctrl:.3e} (must be > "
          f"{CLIP_LOSS_RATIO * loss_pair:.3e}), the gradients with B10's dw and db of the first "
          f"program's rows alone {c_med:.3e} / {c_max:.3e} (must fail); launches {got}",
          flush=True)
    check(bool(torch.isfinite(loss_k)) and loss_gap <= CLIP_LOSS_RATIO * loss_pair
          and k_med <= TRAIN_AGREE_RATIO * r_med and k_max <= TRAIN_AGREE_RATIO * r_max,
          f"clip train agree: loss {loss_gap} against {loss_pair}, grads {k_med} / {k_max} "
          f"against {r_med} / {r_max}")
    check(loss_ctrl > CLIP_LOSS_RATIO * loss_pair,
          f"clip train agree: the loss control passes ({loss_ctrl})")
    check(c_med > TRAIN_AGREE_RATIO * r_med or c_max > TRAIN_AGREE_RATIO * r_max,
          f"clip train agree: the gradients' control passes ({c_med} / {c_max})")
    check(got == walk(forwards=1, backwards=1), f"clip train agree: launches {got}")
    del grads_k, grads_p, grads_r, grads_c, px, ids, batch

    # ------------------------------------------------------ clip train: steps
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    t0 = time.perf_counter()
    pixels = rng.standard_normal((CLIP_TRAIN_SAMPLES, size, size, 3), dtype=np.float32)
    words = [f"w{i}" for i in range(4096)]
    items = [(pixels[i], " ".join(rng.choice(words, rng.integers(3, 40))))
             for i in range(CLIP_TRAIN_SAMPLES)]
    trainer = train_clip.build_trainer(model, train_clip.ImageTextDataset(
        items, None, train_clip._hash_tokenize), BENCH_BATCH, CLIP_TRAIN_STEPS)
    print(f"[clip train] {CLIP_TRAIN_SAMPLES} seeded (pixels, caption) pairs in "
          f"{time.perf_counter() - t0:.1f} s; build_trainer: {len(trainer.train_dataloader)} "
          f"batches of {BENCH_BATCH} an epoch, lr {trainer.args.learning_rate}, warmup "
          f"{trainer.args.warmup_steps}, {trainer.args.lr_scheduler_type}, {CLIP_TRAIN_STEPS} "
          f"steps, prefetch depth {trainer.args.prefetch_depth}", flush=True)
    before = [p.detach().clone() for p in params]
    # the callbacks run every step (the recipe logs every 10th): one of them
    # steps the profiler, whose one active window is step CLIP_TRAIN_STEPS - 1
    trainer.args.logging_steps = 1
    profiled = CLIP_TRAIN_STEPS - 1
    zero()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA], schedule=torch.profiler.schedule(
            wait=profiled - 2, warmup=1, active=1, repeat=1)) as prof:
        trainer.callbacks.append(lambda step, metrics: prof.step())
        trainer.train()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = launches()
    want = walk(forwards=CLIP_TRAIN_STEPS, backwards=CLIP_TRAIN_STEPS)
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    device_ms = sum(ms_ for ms_, _, _ in by_kernel)
    hist = trainer.history
    ends = [t_start] + [h["time"] for h in hist]
    step_s = [b_ - a_ for a_, b_ in zip(ends, ends[1:])]
    t_prof = step_s[profiled - 1]
    # the steady steps: not the first (the loader's start), not the profiled one
    middle = [i for i in range(1, len(hist)) if i != profiled - 1]
    s_step = sorted(step_s[i] for i in middle)[len(middle) // 2]
    reader = sorted(hist[i]["reader"] for i in middle)[len(middle) // 2]
    losses = torch.stack([h["loss"] for h in hist]).float()
    gnorms = torch.stack([h["grad_norm"] for h in hist]).float()
    moved = sum(not torch.equal(a_, p.detach()) for a_, p in zip(before, params))
    tflops = 3 * flops / s_step / 1e12
    print(f"[clip train] {len(hist)} optimizer steps of {BENCH_BATCH} pairs: seconds a step "
          f"{[round(t, 4) for t in step_s]} (step {profiled} under the profiler); median of the "
          f"others but the first {s_step:.4f} s -> {BENCH_BATCH / s_step:.1f} samples/s, {tflops:.1f} model TFLOP/s "
          f"(3 x {flops:.4e} flops a step), {100 * tflops / 989:.1f}% of 989; reader: median "
          f"{1e3 * reader:.2f} ms a step, {100 * reader / s_step:.2f}% of it; profiled step "
          f"{profiled} {t_prof:.4f} s with {device_ms:.1f} ms of device time: busy "
          f"{100 * device_ms / 1e3 / t_prof:.1f}%; peak memory {peak:.2f} GiB", flush=True)
    for ms_, n_, key in by_kernel[:12]:
        print(f"[clip train]   profiled step: {ms_:8.2f} ms {100 * ms_ / device_ms:5.1f}% "
              f"{n_:5d}x {key[:100]}", flush=True)
    print(f"[clip train] losses {[round(x, 4) for x in losses.tolist()]}; grad_norm "
          f"{[round(x, 3) for x in gnorms.tolist()]}; {moved} of {len(params)} parameter "
          f"tensors moved; launches {got} (walk: {want})", flush=True)
    check(len(hist) == CLIP_TRAIN_STEPS and bool(torch.isfinite(losses).all()
                                                  and torch.isfinite(gnorms).all()),
          "clip train: a loss or grad_norm is not finite")
    check(moved == len(params), f"clip train: {len(params) - moved} parameter tensors did not "
          f"move")
    check(got == want, f"clip train: launches {got} != expected {want}")
    del trainer, model, before, params, items, pixels
    gc.collect()
    torch.cuda.empty_cache()
    train_stats = dict(step_s=s_step, samples_per_s=BENCH_BATCH / s_step, tflops=tflops,
                       reader_share=reader / s_step, busy=device_ms / 1e3 / t_prof, peak_gib=peak)
    return launches_clip, got, clip_stats, train_stats


def ln_bwd_note(norms, rows, h):
    """The LayerNorm backward kernel that a bf16 (rows, h) plan launches, with
    ptxas's registers and spills for it (printed, not gated: the held form
    spills w at the CLIP rows, PERF.md)."""
    plan = norms.layer_norm_bwd_plan(rows, h, 2)
    vector = plan.vec > 1
    regs, spills = ptxas_counts("norms", f"ln_bwd_kernelI13__nv_bfloat16Li{plan.epl}ELb{int(vector)}E")
    form = "wide" if plan.epl > norms.LN_HOLD_EPL else "held"
    return (f"ln_bwd_kernel<bf16, {plan.epl}, {str(vector).lower()}> ({form} form, {plan}); "
            f"ptxas {regs} registers, {spills}")


def ln_wide_extra_cases(torch, dev, gen, norms):
    """B10 forward and backward at LN_WIDE_EXTRA_CASES, per element (LN_SUM,
    LN_BWD_SUM, LN_DW_TOL) with the controls that must fail (the variance
    without the mean subtracted; dw and db of the first partial sum's rows
    alone); every plan against the library's."""
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for (rows, h), xd, misaligned in LN_WIDE_EXTRA_CASES:
        scale = 0.5 + 2.5 * torch.rand((rows, 1), generator=gen, device=dev)
        x = (torch.randn((rows, h), generator=gen, device=dev) * scale
             + 2 * torch.randn((rows, 1), generator=gen, device=dev)).to(dts[xd])
        g = torch.randn((rows, h), generator=gen, device=dev).to(dts[xd])
        if misaligned:
            x, g = offset_copy(torch, x), offset_copy(torch, g)
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        y = norms.layer_norm(x, w, b, 1e-5)
        dx, dw, db = norms.layer_norm_backward(x, w, g, 1e-5)
        torch.cuda.synchronize()
        ref = norms.layer_norm_ref(x.float(), w, b, 1e-5)
        excess, _ = ulp_gate(y, ref, LN_SUM)
        control, _ = ulp_gate(ln_no_mean(x.float(), w, b, 1e-5), ref, LN_SUM)
        rdx, rdw, rdb = norms.layer_norm_backward_ref(x.float(), w, g.float(), 1e-5)
        dx_excess, _ = ulp_gate(dx, rdx, LN_BWD_SUM)
        rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()  # noqa: E731
        dw_err = max(rel(dw, rdw), rel(db, rdb))
        es = x.element_size()
        aligned = not misaligned
        plan = norms.layer_norm_bwd_plan(rows, h, es, aligned)
        first = ln_first_rows(norms, rows, h, es) if aligned else min(rows, plan.warps * plan.rpw)
        cdw, cdb = norms.layer_norm_backward_ref(x[:first].float(), w, g[:first].float(), 1e-5)[1:]
        ctrl_dwdb = min(rel(cdw, rdw), rel(cdb, rdb))
        same = norms.layer_norm_bwd_plan_library(rows, h, dts[xd], aligned) == plan and \
            norms.layer_norm_plan_library(rows, h, dts[xd], aligned) == \
            norms.layer_norm_plan(rows, h, es, aligned)
        label = f"{(rows, h)} {xd}{', x and g misaligned' if misaligned else ''}"
        print(f"[clip kernels] layer_norm {label}: excess {excess:.3e}, control (the variance "
              f"without the mean subtracted) {control:.3e} (must be > 0); backward: dx excess "
              f"{dx_excess:.3e}, dw / db max err {dw_err:.3e} |ref|max (tol {LN_DW_TOL}), control "
              f"(dw / db of the first {first} rows alone) {ctrl_dwdb:.3e} (must be > tol); plans "
              f"equal the library's {same} | {norms.layer_norm_plan_of(x, w, b)} | {plan}",
              flush=True)
        check(bool(torch.isfinite(y).all() and torch.isfinite(dx).all()) and excess <= 0
              and dx_excess <= 0 and dw_err <= LN_DW_TOL and same,
              f"layer_norm {label}: {excess}, {dx_excess}, {dw_err}, plans {same}")
        check(control > 0 and ctrl_dwdb > LN_DW_TOL,
              f"layer_norm {label}: a control passes ({control}, {ctrl_dwdb})")
        del x, g, y, dx, ref, rdx


def quantizer_checks(torch, dev, gen):
    """C.9: the four quantizers that divide by a constant (`quantize_weights_int8`
    and `_int4` at a Llama width, 4096 -> 11008; `_quantize_kv` at a KV write
    of (1, 608, 32, 128); `quantize_weight_per_cout` at an SDXL conv weight,
    640 x 640 x 3 x 3) on the card must equal the same call on the CPU bit for
    bit, int8 values and scales. Control: the scalar division they had
    (PyTorch computes `t / c` on the card as t * (1 / c)), whose scales must
    differ from the CPU's somewhere."""
    from paddlemix_tpu_torch.models.llama.modeling import _quantize_kv
    from paddlemix_tpu_torch.ops import conv_int8, quant

    def int8_scalar(w):
        wf = w.float()
        a = wf.abs().amax(dim=1)
        s = torch.where(a == 0, torch.ones_like(a), a / 127.0)
        return torch.round(wf / s[:, None]).clamp_(-127, 127).to(torch.int8), s

    def int4_scalar(w):
        wf = w.float()
        a = wf.abs().amax(dim=1)
        s = torch.where(a == 0, torch.ones_like(a), a / 7.0)
        q = torch.round(wf / s[:, None]).clamp_(-7, 7).to(torch.int32)
        k = wf.shape[1]
        return ((q[:, k // 2:] << 4) | (q[:, :k // 2] & 15)).to(torch.int8), s

    def kv_scalar(x):
        xf = x.float()
        s = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
        return torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8), s

    def cout_scalar(w):
        wf = w.float()
        sw = wf.abs().amax(dim=tuple(range(1, w.ndim))).clamp(min=1e-8) / 127.0
        q = torch.round(wf * (1.0 / sw).view(-1, *(1,) * (w.ndim - 1))).clamp_(-127, 127)
        return q.to(torch.int8), sw

    w = torch.randn((11008, 4096), generator=gen, device=dev) * 4096 ** -0.5
    kv = torch.randn((1, 608, 32, 128), generator=gen, device=dev).to(torch.bfloat16)
    conv = torch.randn((640, 640, 3, 3), generator=gen, device=dev) * (640 * 9) ** -0.5
    for name, fn, scalar, t in [("quantize_weights_int8", quant.quantize_weights_int8, int8_scalar, w),
                                ("quantize_weights_int4", quant.quantize_weights_int4, int4_scalar, w),
                                ("_quantize_kv", _quantize_kv, kv_scalar, kv),
                                ("quantize_weight_per_cout", conv_int8.quantize_weight_per_cout,
                                 cout_scalar, conv)]:
        q, sc = fn(t)
        torch.cuda.synchronize()
        rq, rs = fn(t.cpu())
        q_diff, s_diff = int((q.cpu() != rq).sum()), int((sc.cpu() != rs).sum())
        cq, cs = scalar(t)
        cq_diff, cs_diff = int((cq.cpu() != rq).sum()), int((cs.cpu() != rs).sum())
        print(f"[c9] {name} {tuple(t.shape)} {t.dtype}: card vs CPU, int8 values differing "
              f"{q_diff} of {rq.numel()}, scales {s_diff} of {rs.numel()} (both must be 0); "
              f"control, the scalar division: values {cq_diff}, scales {cs_diff} (scales must "
              f"differ)", flush=True)
        check(q_diff == 0 and s_diff == 0, f"c9 {name}: the card's quantizer differs from the "
                                           f"CPU's ({q_diff} values, {s_diff} scales)")
        check(cs_diff > 0, f"c9 {name}: the scalar-division control equals the CPU's")
    del w, kv, conv


def specials_tokenizer():
    """CLIP's tokenizer over a byte-level vocab (no merges, so no vocab file)
    with CLIP's start and end ids, 49,406 and 49,407: the EVA text tower pools
    at its config's eos id."""
    from paddlemix_tpu_torch.models.clip.tokenizer import CLIPTokenizer, bytes_to_unicode

    vocab = {}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    return CLIPTokenizer(vocab, [], model_max_length=77)


def smooth_jpeg(np, Image, seed, size=(480, 640)):
    """A 640 x 480 jpeg (bytes) of a photograph's texture: a seeded 6 x 8
    grid of colours, bilinearly enlarged, with mild noise."""
    import io

    rng = np.random.default_rng(seed)
    grid = Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    arr = np.asarray(grid.resize(size[::-1], Image.BILINEAR), np.float32)
    arr = np.clip(arr + rng.normal(0, 6, arr.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def kernel_breakdown(label, what, prof, top):
    """Print the `top` kernels of a profile by device time; returns the
    profile's device ms."""
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    device_ms = sum(ms_ for ms_, _, _ in by_kernel)
    for ms_, n_, key in by_kernel[:top]:
        print(f"[{label}]   {what}: {ms_:8.2f} ms {100 * ms_ / device_ms:5.1f}% {n_:5d}x "
              f"{key[:100]}", flush=True)
    return device_ms


def eva_slice(torch, np, dev, m, counters):
    """eva agree, eva appflow, eva eval, eva train and clip main (see the
    module docstring): EVA02-CLIP-B/16 at batch 256 and the example's
    training data plane. `counters` are every kernel wrapper's, by name: each
    phase must launch B10 (and in training its backward) as the walk says,
    and nothing else. Returns the launches of each phase and its numbers."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.appflow import Appflow
    from paddlemix_tpu_torch.datasets import DataLoader
    from paddlemix_tpu_torch.metrics import build_zero_shot_classifier, zero_shot_accuracy
    from paddlemix_tpu_torch.models.clip import CLIPModel, scaled_logits
    from paddlemix_tpu_torch.models.clip.eva02_b16 import (
        expected_launches_eva_clip,
        random_eva_clip,
    )
    from paddlemix_tpu_torch.models.clip.vitb16 import BENCH_BATCH, VITB16, seeded_inputs
    from paddlemix_tpu_torch.models.layers import FusedLayerNorm, n_layer_norms
    from paddlemix_tpu_torch.processors import CLIPImageProcessor, CLIPProcessor
    from paddlemix_tpu_torch.processors.image_utils import to_numpy_rgb
    from paddlemix_tpu_torch.tools import train_clip
    from paddlemix_tpu_torch.trainer import Trainer, TrainingArguments

    bf16 = torch.bfloat16
    norms = m.norms
    phases, stats = {}, {}

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def walk(**kw):
        want = expected_launches_eva_clip(model, **kw)
        return {name: want.get(name, 0) for name in counters}

    def decode(data):
        with Image.open(io.BytesIO(data)) as im:
            return im.convert("RGB")

    t0 = time.perf_counter()
    model = random_eva_clip(dev, seed=0)
    # norms as a trained model holds them (the agree's rounding pair needs a
    # non-trivial affine), every one of the five kinds
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, FusedLayerNorm):
                mod.weight.copy_(1 + 0.1 * torch.randn(mod.weight.shape, generator=gen, device=dev))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen, device=dev))
    torch.cuda.synchronize()
    cfg = model.config
    n_vis, n_txt = n_layer_norms(model.visual), n_layer_norms(model.text_model)
    print(f"[eva] EVA02-CLIP-B/16 built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters())} fp32 parameters, bf16 compute; B10 "
          f"modules: vision {n_vis} (4 a block + norm), text {n_txt} (2 a layer + final)",
          flush=True)
    check(n_vis == 4 * cfg.vision.layers + 1 and n_txt == 2 * cfg.text.num_hidden_layers + 1,
          f"eva: B10 modules {n_vis}, {n_txt}")

    # ------------------------------------------------------------ eva agree
    plain = [(norms, "_ln_forward", norms.layer_norm_ref),
             (norms, "layer_norm_backward", norms.layer_norm_backward_ref)]
    rounded = [(norms, "_ln_forward", ln_rounded)] + plain[1:]
    px, ids = seeded_inputs(cfg, BENCH_BATCH, seed=1, device=dev)

    def logits(swaps=()):
        with torch.inference_mode(), swapped(swaps):
            out = model(px.to(bf16), ids)
            return scaled_logits(out["logit_scale"], out["image_features"], out["text_features"])

    zero()
    lk = logits()
    torch.cuda.synchronize()
    phases["eva"] = got = launches()
    lp, lr = logits(plain), logits(rounded)
    gap, floor = rel_l2(lk, lp), rel_l2(lr, lp)
    print(f"[eva agree] full-width EVA02-CLIP-B/16 forward at batch {BENCH_BATCH} (seeded pixels, "
          f"ids ending in eos), logits {tuple(lk.shape)} {lk.dtype}: relative L2 kernels vs plain "
          f"{gap:.3e}; two plain versions one rounding apart {floor:.3e} (ratio tol "
          f"{TRAIN_AGREE_RATIO}); launches {got}", flush=True)
    check(lk.shape == (BENCH_BATCH, BENCH_BATCH) and bool(torch.isfinite(lk).all()),
          f"eva agree: logits {lk.shape}")
    check(gap <= TRAIN_AGREE_RATIO * floor, f"eva agree: kernels vs plain {gap} against {floor}")
    check(got == walk(image_forwards=1, text_forwards=1), f"eva agree: launches {got}")
    del lk, lp, lr

    # ---------------------------------------------------------- eva appflow
    tok = specials_tokenizer()
    labels = [f"category {i}" for i in range(EVA_LABELS)]
    app = Appflow(app="zero_shot_classification",
                  models=[(model, CLIPProcessor(CLIPImageProcessor(), tok))])
    requests = [smooth_jpeg(np, Image, 100 + i) for i in range(EVA_REQUESTS)]
    seconds, totals = [], collections.Counter()
    torch.cuda.reset_peak_memory_stats()
    for i, data in enumerate(requests):
        zero()
        torch.cuda.synchronize()
        last = i == len(requests) - 1
        with (profile(activities=[ProfilerActivity.CUDA]) if last
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            result = app(image=to_numpy_rgb(decode(data)), candidate_labels=labels)["result"]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        got = launches()
        totals.update(got)
        scores = [r["score"] for r in result]
        check(len(result) == EVA_LABELS and sorted(r["label"] for r in result) == sorted(labels)
              and all(np.isfinite(scores)) and scores == sorted(scores, reverse=True),
              f"eva appflow: request {i} result")
        check(got == walk(image_forwards=1, text_forwards=1),
              f"eva appflow: request {i} launches {got}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    device_ms = kernel_breakdown("eva appflow", "profiled request", prof, 8)
    phases["eva_appflow"] = dict(totals)
    stats["appflow"] = dict(seconds=seconds, device_ms=device_ms, busy=device_ms / 1e3 /
                            seconds[-1], peak_gib=peak)
    print(f"[eva appflow] {EVA_REQUESTS} zero-shot requests, each one 640 x 480 jpeg decoded by "
          f"PIL against {EVA_LABELS} candidate labels: seconds {[round(t, 4) for t in seconds]}; "
          f"profiled request {device_ms:.2f} device ms, busy {100 * device_ms / 1e3 / seconds[-1]:.1f}"
          f"%; peak memory {peak:.2f} GiB; top label {result[0]['label']} {result[0]['score']:.4f}; "
          f"B10 launches a request {n_vis} + {n_txt}", flush=True)

    # ------------------------------------------------------------- eva eval
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    jpegs = [smooth_jpeg(np, Image, 1000 + i) for i in range(EVA_EVAL_IMAGES)]
    truth = torch.from_numpy(rng.integers(0, EVA_LABELS, EVA_EVAL_IMAGES))
    print(f"[eva eval] {EVA_EVAL_IMAGES} jpegs generated in {time.perf_counter() - t0:.1f} s "
          f"(set-up)", flush=True)
    zero()
    t0 = time.perf_counter()
    classifier = build_zero_shot_classifier(model.encode_text, tok, labels, device=dev)
    torch.cuda.synchronize()
    t_cls = time.perf_counter() - t0
    got_cls = launches()
    n_text = -(-EVA_LABELS // 64) * 4
    check(tuple(classifier.shape) == (EVA_LABELS, cfg.embed_dim)
          and bool(torch.isfinite(classifier).all()), "eva eval: classifier")
    check(got_cls == walk(text_forwards=n_text), f"eva eval: classifier launches {got_cls}")
    totals = collections.Counter(got_cls)
    results = {}
    native_env = os.environ.pop("PMIX_NATIVE_PREPROCESS", None)
    try:
        for path in ("default", "native"):
            if path == "native":
                os.environ["PMIX_NATIVE_PREPROCESS"] = "1"
            processor = CLIPImageProcessor()
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                pixels = list(pool.map(lambda d: processor(decode(d))["pixel_values"][0], jpegs))
            batch = torch.from_numpy(np.stack(pixels)).to(dev)
            t_pre = time.perf_counter() - t0
            with torch.inference_mode():
                feats = model.encode_image(batch)
                acc = zero_shot_accuracy(feats, classifier, truth)
                top1 = (feats.float() @ classifier.float().T).argmax(-1)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = launches()
            totals.update(got)
            check(got == walk(image_forwards=1), f"eva eval {path}: launches {got}")
            results[path] = dict(acc=acc, top1=top1, batch=batch, feats=feats.float(),
                                 images_per_s=EVA_EVAL_IMAGES / secs, seconds=secs,
                                 preprocess_s=t_pre)
    finally:
        os.environ.pop("PMIX_NATIVE_PREPROCESS", None)
        if native_env is not None:
            os.environ["PMIX_NATIVE_PREPROCESS"] = native_env
    d_, n_ = results["default"], results["native"]
    agree = float((d_["top1"] == n_["top1"]).float().mean())
    for path, r in results.items():
        print(f"[eva eval] {path} path: {EVA_EVAL_IMAGES} jpegs decoded and preprocessed "
              f"(8 threads) in {r['preprocess_s']:.3f} s, encoded and scored: {r['seconds']:.3f} s "
              f"-> {r['images_per_s']:.1f} images/s; top-1 / top-5 {r['acc']['top1']:.4f} / "
              f"{r['acc']['top5']:.4f} (seeded random labels of {EVA_LABELS} classes)", flush=True)
    print(f"[eva eval] classifier: {EVA_LABELS} classes x 4 templates in {t_cls:.3f} s "
          f"({n_text} text forwards of up to 64 prompts); the paths' pixels differ by relative "
          f"L2 {rel_l2(n_['batch'], d_['batch']):.3e} (bilinear and the long side rounded, "
          f"against bicubic and truncated), their features by {rel_l2(n_['feats'], d_['feats']):.3e}"
          f"; the same predicted class for {100 * agree:.1f}% of the images", flush=True)
    check(d_["acc"]["top1"] == n_["acc"]["top1"],
          f"eva eval: top-1 {d_['acc']['top1']} (default) != {n_['acc']['top1']} (native)")
    phases["eva_eval"] = dict(totals)
    stats["eval"] = dict(images_per_s={p: r["images_per_s"] for p, r in results.items()},
                         top1={p: r["acc"]["top1"] for p, r in results.items()},
                         top5={p: r["acc"]["top5"] for p, r in results.items()},
                         same_top1_share=agree)
    del results, d_, n_, classifier, px, ids

    # ------------------------------------------------------------ eva train
    with open(EVA_CONFIG) as f:
        recipe = json.load(f)
    args = TrainingArguments.from_dict(recipe, **EVA_TRAIN_OVERRIDES)
    check((args.learning_rate, args.lr_scheduler_type, args.weight_decay, args.layer_decay,
           args.per_device_train_batch_size) == (5e-4, "cosine", 0.05, 0.75, BENCH_BATCH),
          f"eva train: the recipe's optimizer {args}")
    size = cfg.vision.image_size
    pixels = rng.standard_normal((EVA_TRAIN_SAMPLES, size, size, 3), dtype=np.float32)
    words = [f"w{i}" for i in range(4096)]
    items = [(pixels[i], " ".join(rng.choice(words, rng.integers(3, 40))))
             for i in range(EVA_TRAIN_SAMPLES)]
    loader = DataLoader(train_clip.ImageTextDataset(items, None, train_clip._hash_tokenize),
                        batch_size=args.per_device_train_batch_size, shuffle=True, num_workers=8,
                        prefetch_batches=8)

    def loss_fn(params, batch, rng_):
        return model(batch["pixel_values"].to(bf16), batch["input_ids"])["loss"], {}

    trainer = Trainer(model=model, args=args, loss_fn=loss_fn, train_dataloader=loader).setup()
    scales = trainer.tx.layer_scales
    check(scales["visual.head.weight"] == 1.0
          and scales["visual.patch_embed.proj.weight"] == 0.75 ** 13
          and scales["visual.blocks.0.mlp.w1.weight"] == 0.75 ** 12,
          "eva train: layer-decay scales")
    params = list(trainer.params.values())
    before = [p.detach().clone() for p in params]
    profiled = EVA_TRAIN_STEPS - 1
    zero()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA], schedule=torch.profiler.schedule(
            wait=profiled - 2, warmup=1, active=1, repeat=1)) as prof:
        trainer.callbacks.append(lambda step, metrics: prof.step())
        trainer.train()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phases["eva_train"] = got = launches()
    want = walk(image_forwards=EVA_TRAIN_STEPS, text_forwards=EVA_TRAIN_STEPS,
                backwards=EVA_TRAIN_STEPS)
    device_ms = kernel_breakdown("eva train", "profiled step", prof, 10)
    hist = trainer.history
    ends = [t_start] + [h["time"] for h in hist]
    step_s = [b_ - a_ for a_, b_ in zip(ends, ends[1:])]
    middle = [i for i in range(1, len(hist)) if i != profiled - 1]
    s_step = sorted(step_s[i] for i in middle)[len(middle) // 2]
    losses = torch.stack([h["loss"] for h in hist]).float()
    moved = sum(not torch.equal(a_, p.detach()) for a_, p in zip(before, params))
    stats["train"] = dict(step_s=s_step, samples_per_s=BENCH_BATCH / s_step,
                          device_ms=device_ms, busy=device_ms / 1e3 / step_s[profiled - 1],
                          peak_gib=peak)
    print(f"[eva train] {len(hist)} optimizer steps of {BENCH_BATCH} pairs, the recipe's "
          f"optimizer (lr {args.learning_rate}, cosine, warmup {args.warmup_steps} (cut), weight "
          f"decay {args.weight_decay}, layer decay {args.layer_decay}): seconds a step "
          f"{[round(t, 4) for t in step_s]}; median of the steady ones {s_step:.4f} s -> "
          f"{BENCH_BATCH / s_step:.1f} samples/s; profiled step {profiled} {device_ms:.1f} device "
          f"ms, busy {100 * stats['train']['busy']:.1f}%; peak memory {peak:.2f} GiB; losses "
          f"{[round(x, 4) for x in losses.tolist()]}; {moved} of {len(params)} parameter tensors "
          f"moved; launches {got}", flush=True)
    check(len(hist) == EVA_TRAIN_STEPS and bool(torch.isfinite(losses).all()),
          "eva train: a loss is not finite")
    check(moved == len(params), f"eva train: {len(params) - moved} parameter tensors did not move")
    check(got == want, f"eva train: launches {got} != {want}")
    del trainer, model, before, params, items, pixels, loader
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ clip main
    with torch.device("meta"):
        n_clip = n_layer_norms(CLIPModel(VITB16))
    saved = {k: os.environ.get(k) for k in ("CLIP_STEPS", "CLIP_BATCH")}
    os.environ.update(CLIP_STEPS=str(CLIP_MAIN_STEPS), CLIP_BATCH=str(CLIP_MAIN_BATCH))
    try:
        zero()
        t0 = time.perf_counter()
        result = train_clip.main(["--synthetic"], device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    phases["clip_main"] = got = launches()
    want = {name: 0 for name in counters}
    want.update(layer_norm=n_clip * CLIP_MAIN_STEPS, layer_norm_backward=n_clip * CLIP_MAIN_STEPS)
    print(f"[clip main] tools/train_clip.main --synthetic (256 generated jpegs, PIL decode and "
          f"CLIPImageProcessor in the loader's 8 workers, CLIP_STEPS {CLIP_MAIN_STEPS}, CLIP_BATCH "
          f"{CLIP_MAIN_BATCH}): {secs:.1f} s with the set-up; result {result}; launches {got}",
          flush=True)
    check(result["final_step"] == CLIP_MAIN_STEPS and np.isfinite(result["loss"]),
          f"clip main: {result}")
    check(got == want, f"clip main: launches {got} != {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return phases, stats


# ------------------------------------------------------ decode attention
def blip2_kernels(torch, F, dev, gen, record, m):
    """blip2 kernels (see the module docstring): B10's forward at
    BLIP2_LN_SHAPES and B7 at BLIP2_DECODE_CASES, each per element with its
    control, times, bounds and library calls; the backward's refusal of
    2,560-wide rows, with a message."""
    norms, da = m.norms, m.da
    clip_kernels(torch, F, dev, gen, record, norms, shapes=[(r, h, 1) for r, h in BLIP2_LN_SHAPES],
                 backward=False, label="blip2 kernels")
    decode_kernels(torch, F, dev, gen, record, da, cases=BLIP2_DECODE_CASES, label="blip2 kernels")
    x = torch.zeros((33, 2560), dtype=torch.bfloat16, device=dev)
    try:
        norms.layer_norm_backward(x, torch.ones(2560, device=dev), x, 1e-6)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    lib = [norms.layer_norm_bwd_plan_library(33, 2560, torch.bfloat16, a) for a in (True, False)]
    print(f"[blip2 kernels] layer_norm_backward (33, 2560) refused: {refused}; the library's "
          f"plans (aligned, not): {lib}", flush=True)
    check("at most 2048 wide" in refused and lib == [None, None],
          f"layer_norm_backward at 2,560 was not refused ({refused!r}, {lib})")


def kernel_category(key):
    """A profiled kernel's category, by its name."""
    k = key.lower()
    if "layer_norm_fwd" in k:
        return "B10 layer_norm"
    if "decode_attention" in k:
        return "B7 decode_attention (+ merge)"
    if "flash_fwd" in k:
        return "B1 flash_fwd"
    if "rms_norm" in k:
        return "B11 rms_norm"
    if any(w in k for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "matmul")):
        return "GEMM (cuBLAS)"
    if "conv" in k:
        return "conv (cuDNN)"
    if "softmax" in k:
        return "softmax"
    if "reduce" in k:
        return "reductions"
    if any(w in k for w in ("copy", "cat", "index", "elementwise", "vectorized", "unrolled",
                            "fill")):
        return "elementwise / copies"
    return "other"


def blip2_slice(torch, np, dev, m, counters):
    """blip2 agree and blip2 serve (see the module docstring): BLIP-2
    OPT-2.7B at full width with seeded random bf16 weights. `counters` are
    every kernel wrapper's, by name: each request must launch B10 and B7 as
    the walk says, and nothing else. Returns the launches of the serve and
    its numbers."""
    import io

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.models.blip2 import expected_launches_blip2, random_blip2
    from paddlemix_tpu_torch.models.blip2.opt27b import BOS_ID, CAPTION_NEW_TOKENS
    from paddlemix_tpu_torch.models.layers import n_layer_norms
    from paddlemix_tpu_torch.models.llama import modeling as llama_mod
    from paddlemix_tpu_torch.processors import Blip2Processor

    norms, da = m.norms, m.da

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def walk(new_tokens):
        want = expected_launches_blip2(model, 1, new_tokens)
        return {name: want.get(name, 0) for name in counters}

    t0 = time.perf_counter()
    model = random_blip2(seed=0, device=dev)
    torch.cuda.synchronize()
    cfg = model.config
    parts = {name: sum(p.numel() for p in getattr(model, name).parameters())
             for name in ("vision_model", "qformer", "language_projection", "language_model")}
    total = sum(p.numel() for p in model.parameters())
    print(f"[blip2] BLIP-2 OPT-2.7B built on the card in {time.perf_counter() - t0:.1f} s: "
          f"{total} parameters ({parts}, query tokens {model.query_tokens.numel()}), bf16 "
          f"(LayerNorms fp32), {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; B10 "
          f"modules: tower {n_layer_norms(model.vision_model)}, Q-Former "
          f"{n_layer_norms(model.qformer)}, OPT {n_layer_norms(model.language_model)}",
          flush=True)
    check(3.7e9 < total < 3.8e9, f"blip2: {total} parameters")
    processor = Blip2Processor()
    ids = torch.tensor([[BOS_ID]], device=dev)
    jpegs = [smooth_jpeg(np, Image, 200 + i) for i in range(BLIP2_REQUESTS)]

    def pixels(data):
        with Image.open(io.BytesIO(data)) as im:
            return torch.from_numpy(processor(images=im.convert("RGB"),
                                              mode="eval")["pixel_values"])

    # ---------------------------------------------------------- blip2 agree
    px0 = pixels(jpegs[0]).to(dev)
    full = cfg.num_query_tokens + ids.shape[1]

    # the decode steps are fed seeded ids: the greedy ones of random weights
    # with a tied embedding repeat the last (BOS), so each step would see one
    toks = torch.randint(BOS_ID + 1, cfg.text.vocab_size, (BLIP2_AGREE_STEPS, 1, 1),
                         generator=torch.Generator().manual_seed(0)).to(dev)

    def steps(swaps=()):
        """Prefill logits (33, vocab) and those of the decode steps fed `toks`."""
        with torch.inference_mode(), swapped(swaps):
            cache = model.init_cache(1, full + BLIP2_AGREE_STEPS)
            logits, cache = model(px0, ids, torch.arange(full, device=dev)[None], cache=cache)
            outs = [logits[0].float()]
            for tok in toks:
                step, cache = model.language_model(tok, cache.lengths[:, None], cache=cache)
                outs.append(step[0].float())
        return outs[0], torch.cat(outs[1:])

    swaps = [(llama_mod, "decode_attention", da.decode_attention_ref),
             (norms, "_ln_forward", norms.layer_norm_ref)]
    zero()
    pre_k, dec_k = steps()
    torch.cuda.synchronize()
    got = launches()
    pre_p, dec_p = steps(swaps)
    rel_pre, rel_dec = rel_l2(pre_k, pre_p), rel_l2(dec_k, dec_p)
    print(f"[blip2 agree] full-width BLIP-2 OPT-2.7B, kernels (B7, B10) vs plain: relative L2 "
          f"of the logits, prefill ({full} tokens: 32 query features + BOS) {rel_pre:.3e}, "
          f"{BLIP2_AGREE_STEPS} decode steps {rel_dec:.3e} (tol {LLAVA_AGREE_TOL}); |logits| max "
          f"{pre_p.abs().max().item():.3f}; ids fed {toks.view(-1).tolist()}; launches of "
          f"the kernels' run {got}", flush=True)
    check(bool(torch.isfinite(pre_k).all() and torch.isfinite(dec_k).all())
          and rel_pre <= LLAVA_AGREE_TOL and rel_dec <= LLAVA_AGREE_TOL,
          f"blip2 agree: relative L2 {rel_pre} / {rel_dec}")
    check(got == walk(1 + BLIP2_AGREE_STEPS), f"blip2 agree: launches {got}")
    del pre_k, dec_k, pre_p, dec_p

    # ---------------------------------------------------------- blip2 serve
    want, want_1 = walk(CAPTION_NEW_TOKENS), walk(1)
    print(f"[blip2 serve] expected launches per request (walking the modules): {want}; TTFT run "
          f"{want_1}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    totals, stats = collections.Counter(), []

    def request(data, new_tokens):
        """(seconds, of them the decode and preprocess, tokens) of one request:
        the jpeg decoded and processed, then `generate` (eos off)."""
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        px = pixels(data)
        t_pre = time.perf_counter() - t0
        out = model.generate(px, ids, max_new_tokens=new_tokens, eos_token_id=-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, t_pre, out

    def prefill_logits(px, slots):
        """The prefill's logits over a cache of `slots` (a request's)."""
        with torch.inference_mode():
            logits, _ = model(px.to(dev), ids, torch.arange(full, device=dev)[None],
                              cache=model.init_cache(1, slots))
        return logits

    for i, data in enumerate(jpegs):
        runs = []
        for n_new, expected in ((1, want_1), (CAPTION_NEW_TOKENS, want)):
            runs.append(request(data, n_new))
            got = launches()
            totals.update(got)
            check(got == expected, f"blip2 serve: launches {got} != expected {expected}")
        (ttft, _, first), (seconds, t_pre, toks) = runs
        tps = (CAPTION_NEW_TOKENS - 1) / (seconds - ttft)
        stats.append(dict(seconds=seconds, ttft=ttft, tokens_per_s=tps, preprocess=t_pre))
        print(f"[blip2 serve] request {i} (640 x 480 jpeg): {seconds:.3f} s for "
              f"{CAPTION_NEW_TOKENS} tokens (decode + preprocess {1e3 * t_pre:.1f} ms) | TTFT "
              f"{1e3 * ttft:.1f} ms | decode {tps:.2f} tokens/s ({1e3 / tps:.2f} ms/token) | "
              f"tokens {toks[0, :8].tolist()}...", flush=True)
        check(toks.shape == (1, CAPTION_NEW_TOKENS) and toks.dtype == torch.int32,
              f"blip2 serve: tokens {tuple(toks.shape)} {toks.dtype}")
        check(bool(((toks >= 0) & (toks < cfg.text.vocab_size)).all()),
              "blip2 serve: a token outside the vocab")
        # the first token of random weights is BOS whatever the cache: the
        # prefill's logits over the TTFT run's cache and the full run's must
        # be bit-equal (no sum over the spare slots)
        px = pixels(data)
        short_l, long_l = (prefill_logits(px, full + n) for n in (1, CAPTION_NEW_TOKENS))
        spare = (short_l.float() - long_l.float()).abs().max().item()
        print(f"[blip2 serve]   request {i}: prefill logits over {full + 1} and "
              f"{full + CAPTION_NEW_TOKENS} cache slots: max difference {spare:.3e} (must be 0); "
              f"first tokens {int(first[0, 0])} / {int(toks[0, 0])}", flush=True)
        check(torch.equal(short_l, long_l) and int(toks[0, 0]) == int(first[0, 0]),
              f"blip2 serve: the prefill depends on the cache's spare slots ({spare})")
        del short_l, long_l
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        seconds, _, _ = request(jpegs[-1], CAPTION_NEW_TOKENS)
    got = launches()
    totals.update(got)
    check(got == want, f"blip2 serve: profiled request launches {got}")
    device_ms = kernel_breakdown("blip2 serve", "profiled request", prof, 10)
    by_category = collections.Counter()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            by_category[kernel_category(e.key)] += e.self_device_time_total / 1e3
    busy = device_ms / 1e3 / seconds
    med = lambda k: sorted(s_[k] for s_ in stats)[len(stats) // 2]  # noqa: E731
    print(f"[blip2 serve] profiled request: {seconds:.3f} s, {device_ms:.2f} ms of device time "
          f"(busy {100 * busy:.1f}%), by category "
          f"{ {k: round(v, 3) for k, v in by_category.most_common()} }; peak memory "
          f"{peak:.2f} GiB; medians of {BLIP2_REQUESTS}: {med('seconds'):.3f} s a request, TTFT "
          f"{1e3 * med('ttft'):.1f} ms, decode {med('tokens_per_s'):.2f} tokens/s; launches over "
          f"the phase {dict(totals)}", flush=True)
    del model
    return dict(totals), dict(requests=stats, profiled_seconds=seconds, device_ms=device_ms,
                              busy=busy, by_category=dict(by_category), peak_gib=peak)


def decode_note(da, b_, hq, kvh, d, L, int8):
    """The split plan (ops/decode_attention.py `key_splits`) of one B7 / B8
    case on this card, and ptxas's registers and spills for its
    instantiation."""
    import torch

    g = hq // kvh
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, chunk = da.key_splits(b_, kvh, L, sms)
    blocks = b_ * kvh * splits
    regs, spills = ptxas_counts("decode_attention", f"decode_attention_kernelILi{d}ELi{g}E"
                                f"{'a' if int8 else '13__nv_bfloat16'}E")
    resident = da.kernel_blocks_per_sm(d, g, int8)
    # whole waves of the SMs, but where key_splits found no whole multiple of
    # them with ranges of the least length (BLIP-2's short caches): then its
    # fallback, the most splits, within one wave
    no_multiple = sms // math.gcd(b_ * kvh, sms) > max(1, L // da._MIN_SPLIT_KEYS)
    waves_ok = (blocks <= sms * da.WAVE_BLOCKS_PER_SM and splits == max(1, L // da._MIN_SPLIT_KEYS)
                if no_multiple else blocks % sms == 0)
    check(resident * sms >= blocks and waves_ok,
          f"decode attention (D {d}, G {g}): {blocks} blocks, {resident} fit an SM: not "
          f"{'within one wave' if no_multiple else 'whole waves'}")
    return (f"{splits} key ranges of {chunk}, {blocks} blocks of 64 threads = "
            f"{blocks / (sms * da.WAVE_BLOCKS_PER_SM):.2f} waves of {da.WAVE_BLOCKS_PER_SM} an SM "
            f"on {sms} SMs, all resident at once ({resident} fit an SM); ptxas {regs} registers, "
            f"{spills}")


def decode_kernels(torch, F, dev, gen, record, da, cases=DECODE_CASES, label="llava kernels"):
    """B7 against its plain version at `cases`, per element, with the
    lengths-one-short control; times, bounds, SDPA as the library call."""
    bf16 = torch.bfloat16
    for b_, hq, kvh, d, L, lengths in cases:
        q = torch.randn((b_, 1, hq, d), generator=gen, device=dev).to(bf16)
        # k and v are slices of a layer's cache with its parking slot, as in the model
        cache = torch.randn((2, b_, L + 1, kvh, d), generator=gen, device=dev).to(bf16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = da.decode_attention(q, cache[0, :, :L], cache[1, :, :L], lens)
        torch.cuda.synchronize()
        ref = da.decode_attention_ref(q.float(), cache[0, :, :L].float(),
                                      cache[1, :, :L].float(), lens)
        err = (out.float() - ref).abs().max().item()
        limit = DECODE_ULP * ref.abs() + DECODE_SUM * ref.abs().max()
        excess = ((out.float() - ref).abs() - limit).max().item()
        short = da.decode_attention(q, cache[0, :, :L], cache[1, :, :L], lens - 1)
        ctrl = ((short.float() - ref).abs() - limit).max().item()
        shape = (b_, hq, kvh, d, L, lengths)
        print(f"[{label}] decode_attention {shape} bf16: max_abs_err {err:.3e} (limit "
              f"{DECODE_ULP:.4g}|ref| + {DECODE_SUM:g}|ref|max, excess {excess:.3e}); control "
              f"with lengths one short: excess {ctrl:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0, f"decode {shape}: err {err}")
        check(ctrl > 0, f"decode {shape}: the one-short control passes the limit ({ctrl})")
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        qh = q.transpose(1, 2)
        ms, plain_ms = timed_pair(
            torch, cold(lambda c: da.decode_attention(q, c[0, :, :L], c[1, :, :L], lens),
                        cache, nbytes(cache)),
            cold(lambda c: da.decode_attention_ref(q, c[0, :, :L], c[1, :, :L], lens),
                 cache, nbytes(cache)))
        lib_ms = library_ms(torch, cold(lambda c: F.scaled_dot_product_attention(
            qh, c[0, :, :L].transpose(1, 2), c[1, :, :L].transpose(1, 2), attn_mask=mask,
            enable_gqa=hq != kvh), cache, nbytes(cache)))
        used = sum(min(n_, L) for n_ in lengths)  # cached rows the lengths make it read
        record(label, "decode_attention", shape, err, ms, plain_ms, lib_ms,
               bound(nbytes(q, lens, out) + 2 * used * kvh * d * 2, 4 * hq * used * d, "fp32"))
        print(f"[{label}]   decode_attention {shape}: "
              f"{decode_note(da, b_, hq, kvh, d, L, False)}", flush=True)
        del q, cache, out, ref, short, limit


def int8_decode_kernels(torch, F, dev, gen, record, da, quantize_kv, launches):
    """B8 against its plain version at INT8_DECODE_CASES, per element, with the
    control without the last 64 keys; times, bounds, SDPA over the
    dequantized cache as the library call. `launches`: B8's a request."""
    bf16 = torch.bfloat16
    for b_, hq, kvh, d, L, lengths in INT8_DECODE_CASES:
        q = torch.randn((b_, 1, hq, d), generator=gen, device=dev).to(bf16)
        # k, v and their scales are slices of a layer's cache with its parking slot
        cache = quantize_kv(torch.randn((2, b_, L + 1, kvh, d), generator=gen, device=dev))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)

        def int8_args(c):
            (kv, sc) = c
            return kv[0, :, :L], kv[1, :, :L], sc[0, :, :L], sc[1, :, :L]
        out = da.decode_attention_int8(q, *int8_args(cache), lens)
        torch.cuda.synchronize()
        ref = da.decode_attention_int8_ref(q.float(), *int8_args(cache), lens)
        err = (out.float() - ref).abs().max().item()
        excess, need = ulp_gate(out, ref, INT8_DECODE_SUM)
        control, _ = ulp_gate(da.decode_attention_int8_ref(q.float(), *int8_args(cache),
                                                           lens - 64), ref, INT8_DECODE_SUM)
        shape = (b_, hq, kvh, d, L, lengths)
        print(f"[llama kernels] decode_attention_int8 {shape}: max_abs_err {err:.3e}, excess "
              f"{excess:.3e} over 2**-7|ref| + {INT8_DECODE_SUM:g}|ref|max (least c {need:.2e}); "
              f"control without the last 64 keys: excess {control:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"decode_attention_int8 {shape}: excess {excess}")
        check(control > 0, f"decode_attention_int8 {shape}: the control passes ({control})")
        cache_bytes = nbytes(*cache)
        ms, plain_ms = timed_pair(
            torch, cold(lambda c: da.decode_attention_int8(q, *int8_args(c), lens), cache,
                        cache_bytes),
            cold(lambda c: da.decode_attention_int8_ref(q, *int8_args(c), lens), cache,
                 cache_bytes))
        deq = (cache[0].float() * cache[1][..., None]).to(bf16)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        qh = q.transpose(1, 2)
        lib_ms = library_ms(torch, cold(lambda c: F.scaled_dot_product_attention(
            qh, c[0, :, :L].transpose(1, 2), c[1, :, :L].transpose(1, 2), attn_mask=mask,
            enable_gqa=hq != kvh), deq, nbytes(deq)))
        used = sum(min(n_, L) for n_ in lengths)  # cached rows the lengths make it read
        record("llama kernels", "decode_attention_int8", shape, err, ms, plain_ms, lib_ms,
               bound(nbytes(q, lens, out) + 2 * used * kvh * (d + 4), 4 * hq * used * d, "fp32"),
               f" | {launches} launches a request | library: SDPA "
               f"over the dequantized bf16 cache, dequant not included")
        print(f"[llama kernels]   decode_attention_int8 {shape}: "
              f"{decode_note(da, b_, hq, kvh, d, L, True)}", flush=True)
        del q, cache, out, ref, deq


# -------------------------------------------------- B1's int8 QK^T form
def truncating_quantize(torch):
    """`quantize_rows_int8` with truncation in place of round-half-even: the
    control of the int8 QK^T checks."""
    def quantize(x):
        xf = x.float()
        a = xf.abs().amax(-1).clamp_min(1e-9)
        return torch.trunc(xf * (torch.full_like(a, 127.0) / a)[..., None]).clamp(
            -127, 127).to(torch.int8), a
    return quantize


def int8_attention_kernels(torch, F, dev, gen, record, attn):
    """The int8 QK^T kernel against `flash_attention_int8_ref` per element at
    the SDXL and SD1.5 self-attention shapes, with the truncation control;
    times, bounds (the int8 QK^T at the int8 peak plus the bf16 P.V at the bf16
    peak, or the bytes) and, as the nearest yardstick, SDPA in bf16 (no
    PyTorch call computes int8 attention). First the wrapper's mirror of the
    width table (`flash_fwd_plan`, `flash_fwd_smem`) against the library's
    at every head of FWD_TABLE_HEADS and both forms. At each shape also the
    activation pass (`quantize_qk_int8`, which every call runs before the
    core) against `int8_qk_operands` bit for bit: q8, k8, sq and sk with 0
    mismatches, and the truncation control's q8 and k8, which must mismatch;
    its time alone and its bound (bytes). Then the int8 form with its options
    (INT8_ATTN_CASES: causal, segment ids, GQA, ragged S) per element with
    the same gate and control."""
    bf16 = torch.bfloat16
    # the wrapper's mirror of csrc/flash_fwd.cu's width table, held against
    # the library's (flash_core checks it) at every head and both forms
    for d_ in FWD_TABLE_HEADS:
        for int8 in (False, True):
            print(f"[int8 kernels] the width table at head {d_}{' int8' if int8 else ''}: "
                  f"{flash_core(d_, int8)[1]}", flush=True)
    worst, control_least = 0.0, float("inf")
    for shape in INT8_ATTN_SHAPES:
        b_, s_, h_, d_ = shape
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=bf16) for _ in range(3))
        # the activation pass, bit for bit
        scale = d_ ** -0.5
        got = attn.quantize_qk_int8(q, k, scale)
        torch.cuda.synchronize()
        want = attn.int8_qk_operands(q, k, scale)
        bad = [int((a != b).sum()) for a, b in zip(got, want)]
        with swapped([(attn, "quantize_rows_int8", truncating_quantize(torch))]):
            trunc = attn.int8_qk_operands(q, k, scale)
        ctrl_bad = sum(int((a != b).sum()) for a, b in zip(got[:2], trunc[:2]))
        pass_ms = (cuda_ms(torch, lambda: attn.quantize_qk_int8(q, k, scale))
                   + cuda_ms(torch, lambda: attn.quantize_qk_int8(q, k, scale))) / 2
        pass_bound = nbytes(q, k, *got) / HBM_BYTES_PER_S * 1e3
        note = (f"; the pass alone {pass_ms:.4f} ms (bound {pass_bound:.4f} ms, bytes), run "
                f"by the call before the core")
        print(f"[int8 kernels] quantize_qk_int8 {shape}: mismatches q8 {bad[0]}, k8 {bad[1]}, sq "
              f"{bad[2]}, sk {bad[3]} (must all be 0); control quantizing by truncation: "
              f"{ctrl_bad} q8 / k8 mismatches (must be > 0){note}", flush=True)
        check(sum(bad) == 0, f"quantize_qk_int8 {shape}: mismatches {bad}")
        check(ctrl_bad > 0, f"quantize_qk_int8 {shape}: the truncation control matches")
        del got, want, trunc
        out = attn.flash_attention_int8(q, k, v)
        torch.cuda.synchronize()
        ref = attn.flash_attention_int8_ref(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        excess, need = ulp_gate(out, ref, INT8_ATTN_SUM)
        with swapped([(attn, "quantize_rows_int8", truncating_quantize(torch))]):
            control, control_need = ulp_gate(attn.flash_attention_int8_ref(q, k, v), ref,
                                             INT8_ATTN_SUM)
        worst, control_least = max(worst, need), min(control_least, control_need)
        print(f"[int8 kernels] flash_attention_int8 {shape} bf16: max_abs_err {err:.3e}, excess "
              f"{excess:.3e} over 2**-7|ref| + {INT8_ATTN_SUM:g}|ref|max (least c {need:.2e}); "
              f"control quantizing by truncation: excess {control:.3e}, least c "
              f"{control_need:.2e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"flash_attention_int8 {shape}: excess {excess}")
        check(control > 0, f"flash_attention_int8 {shape}: the control passes ({control})")
        del ref
        ms, plain_ms = timed_pair(torch, lambda: attn.flash_attention_int8(q, k, v),
                                  lambda: attn.flash_attention_int8_ref(q, k, v))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        pv = 2 * b_ * h_ * s_ * s_ * d_
        record("int8 kernels", "flash_attention_int8", shape, err, ms, plain_ms, lib_ms,
               bound_parts(nbytes(q, k, v, out), [(pv, "int8"), (pv, "bf16")]),
               " (library: SDPA in bf16, the nearest yardstick)", flash=(d_, 2 * pv, True))
        del q, k, v, out
    for b_, s_, h_, kvh, d_, causal, segmented in INT8_ATTN_CASES:
        shape = (b_, s_, h_, kvh, d_)
        q = torch.randn((b_, s_, h_, d_), generator=gen, device=dev, dtype=bf16)
        k, v = (torch.randn((b_, s_, kvh, d_), generator=gen, device=dev, dtype=bf16)
                for _ in range(2))
        kw = dict(causal=causal)
        if segmented:
            seg = torch.ones((b_, s_), dtype=torch.int32, device=dev)
            for i in range(b_):
                for cut in TRAIN_SEGMENT_CUTS:
                    seg[i, int(cut * s_) + 11 * i:] += 1
            kw["segment_ids"] = attn.SegmentIds(seg, seg)
        out = attn.flash_attention_int8(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attn.flash_attention_int8_ref(q, k, v, **kw)
        excess, need = ulp_gate(out, ref, INT8_ATTN_SUM)
        with swapped([(attn, "quantize_rows_int8", truncating_quantize(torch))]):
            control, control_need = ulp_gate(attn.flash_attention_int8_ref(q, k, v, **kw), ref,
                                             INT8_ATTN_SUM)
        worst, control_least = max(worst, need), min(control_least, control_need)
        core, core_note = flash_core(d_, True)
        what = ", ".join(w for w, on in (("causal", causal), ("segment ids", segmented),
                                         (f"GQA {h_} on {kvh}", kvh != h_)) if on) or "no mask"
        print(f"[int8 kernels] flash_attention_int8 {shape} {what}: core {core} ({core_note}); "
              f"max_abs_err {(out.float() - ref.float()).abs().max().item():.3e}, excess "
              f"{excess:.3e} (least c {need:.2e}); truncation control: excess {control:.3e} "
              f"(must be > 0)", flush=True)
        check(core == "wgmma", f"flash_attention_int8 {shape}: core {core}, not wgmma")
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"flash_attention_int8 {shape} {what}: excess {excess}")
        check(control > 0, f"flash_attention_int8 {shape} {what}: the control passes ({control})")
        del q, k, v, out, ref
    print(f"[int8 kernels] least c over the shapes: kernel {worst:.2e}, truncation control "
          f"{control_least:.2e} (gate {INT8_ATTN_SUM:g})", flush=True)


@contextlib.contextmanager
def checked_int8_calls(torch, attn, c):
    """Inside the block, every `flash_attention_int8` call the model makes
    launches the kernel and is held per element against
    `flash_attention_int8_ref` on that call's own q / k / v (|out - ref| <=
    2**-7 |ref| + c |ref|max), with the truncation control. Yields a list
    that gets (shape, excess, least c, control excess, control least c) a
    call. The kernel's output is what the model gets."""
    rows, kernel = [], attn.flash_attention_int8

    def checked(q, k, v, **kw):
        with swapped([(attn, "flash_attention_int8", kernel)]):  # it counts by its name
            out = kernel(q, k, v, **kw)
        ref = attn.flash_attention_int8_ref(q, k, v, **kw)
        with swapped([(attn, "quantize_rows_int8", truncating_quantize(torch))]):
            control = attn.flash_attention_int8_ref(q, k, v, **kw)
        rows.append((tuple(q.shape),) + ulp_gate(out, ref, c) + ulp_gate(control, ref, c))
        return out
    with swapped([(attn, "flash_attention_int8", checked)]):
        yield rows


# ------------------------------------------------------------ SD1.5 slice
def sd15_kernels(torch, F, dev, gen, record, flash_case, gn_case, attn):
    """B1 at SD1.5's self-attention shapes and at head_dim 256 against its
    plain version, per element with B1's gate and last-tile control; B15 at
    head_dim 160 and 256 the same way; B1 and B15 at heads 80 and 160 with
    causal + segment ids + GQA at a ragged S (`masked_flash_case`); B4 at
    SD1.5's GroupNorm shapes that SDXL's lack."""
    bf16 = torch.bfloat16
    for shape, act in SD15_GN_CASES:
        gn_case("sd15 kernels", shape, act, control=True)
    for shape in SD15_FLASH_SHAPES:
        d_ = shape[3]
        flash_case("sd15 kernels", shape,
                   "flash_attention" if d_ <= 128 else f"flash_attention_d{d_}")
        if d_ <= 128:
            continue  # B15 at head dims up to 128 is held in (sd15) train kernels
        b_, s_, h_, _ = shape
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=bf16) for _ in range(3))
        qs = (q.float() * (d_ ** -0.5 * attn.LOG2E)).to(bf16)
        o, lse = attn.flash_fwd_lse(qs, k, v)
        torch.cuda.synchronize()
        ro, rlse = attn.flash_fwd_lse_ref(qs.float(), k.float(), v.float())
        excess, need = ulp_gate(o, ro, FLASH_SUM)
        lse_err = (lse - rlse).abs().max().item()
        n = s_ - 64
        control, _ = ulp_gate(attn.flash_fwd_lse_ref(qs.float(), k[:, :n].float(),
                                                     v[:, :n].float())[0], ro, FLASH_SUM)
        print(f"[sd15 kernels] flash_fwd_lse {shape}: o excess {excess:.3e} (least c "
              f"{need:.2e}, c {FLASH_SUM}), lse max err {lse_err:.3e} (tol {LSE_TOL}); control "
              f"without the last 64 keys: excess {control:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(o).all()) and excess <= 0 and lse_err <= LSE_TOL,
              f"flash_fwd_lse {shape}: excess {excess}, lse err {lse_err}")
        check(control > 0, f"flash_fwd_lse {shape}: the control passes ({control})")
        ms, plain_ms = timed_pair(torch, lambda: attn.flash_fwd_lse(qs, k, v),
                                  lambda: attn.flash_fwd_lse_ref(qs, k, v))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        record("sd15 kernels", f"flash_fwd_lse_d{d_}", shape, (o.float() - ro).abs().max().item(),
               ms, plain_ms, lib_ms,
               bound(nbytes(qs, k, v, o, lse), 4 * b_ * h_ * s_ * s_ * d_, "bf16"),
               flash=(d_, 4 * b_ * h_ * s_ * s_ * d_, False))
        del q, k, v, qs, o, lse, ro, rlse
    for case in SD15_FLASH_MASKED_CASES:
        masked_flash_case(torch, dev, gen, attn, *case)


def masked_flash_case(torch, dev, gen, attn, b_, s_, h_, kvh, d_):
    """B1 (flash_attention) and B15 (flash_fwd_lse) at (B, S, Hq on Hkv, D)
    with causal + segment ids (cut at TRAIN_SEGMENT_CUTS, 11 rows later a
    batch row) + GQA, per element against their plain versions (c FLASH_SUM;
    B15's lse within LSE_TOL), each with the control that leaves out the last
    key tile (a query whose segment lies wholly in it sees no key: 0), which
    must fail; then each written into `out`, a view of a buffer SENTINEL_COLS
    columns wider filled with SENTINEL: the head's columns must equal the
    call's own output bit for bit and the columns past it keep the
    sentinel."""
    bf16 = torch.bfloat16
    q = torch.randn((b_, s_, h_, d_), generator=gen, device=dev, dtype=bf16)
    k, v = (torch.randn((b_, s_, kvh, d_), generator=gen, device=dev, dtype=bf16)
            for _ in range(2))
    seg = torch.ones((b_, s_), dtype=torch.int32, device=dev)
    for i in range(b_):
        for cut in TRAIN_SEGMENT_CUTS:
            seg[i, int(cut * s_) + 11 * i:] += 1
    segs = attn.SegmentIds(seg, seg)
    n = s_ - (s_ % 64 or 64)  # the control's keys: all but the last tile
    kw, kw_cut = dict(causal=True, segment_ids=segs),         dict(causal=True, segment_ids=attn.SegmentIds(seg, seg[:, :n]))
    qs = (q.float() * (d_ ** -0.5 * attn.LOG2E)).to(bf16)
    width = attn.flash_fwd_plan(d_).width
    label = f"({b_}, {s_}, {h_} on {kvh}, {d_}) causal + segment ids + GQA"
    for name in ("flash_attention", "flash_fwd_lse"):
        if name == "flash_attention":
            out, lse = attn.flash_attention(q, k, v, int8_qk=False, **kw), None
            ref, rlse = attn.flash_attention_ref(q.float(), k.float(), v.float(), **kw), None
            ctrl = attn.flash_attention_ref(q.float(), k[:, :n].float(), v[:, :n].float(),
                                            **kw_cut)
            args = (q, k, v, d_ ** -0.5 * attn.LOG2E, True, segs, False)
        else:
            out, lse = attn.flash_fwd_lse(qs, k, v, **kw)
            ref, rlse = attn.flash_fwd_lse_ref(qs.float(), k.float(), v.float(), **kw)
            ctrl = attn.flash_fwd_lse_ref(qs.float(), k[:, :n].float(), v[:, :n].float(),
                                          **kw_cut)[0]
            args = (qs, k, v, 1.0, True, segs, True)
        torch.cuda.synchronize()
        excess, need = ulp_gate(out, ref, FLASH_SUM)
        control, _ = ulp_gate(ctrl.nan_to_num(0.0), ref, FLASH_SUM)
        lse_err = 0.0 if lse is None else (lse - rlse).abs().max().item()
        buf = torch.full((b_, s_, h_, width + SENTINEL_COLS), SENTINEL, device=dev, dtype=bf16)
        attn._flash_fwd_cuda(*args, out=buf[..., :width])
        torch.cuda.synchronize()
        same = torch.equal(buf[..., :d_], out)
        kept = bool((buf[..., width:] == SENTINEL).all())
        core, note = flash_core(d_)
        print(f"[sd15 kernels] {name} {label}: core {core} ({note}); excess {excess:.3e} (least "
              f"c {need:.2e}, c {FLASH_SUM}){'' if lse is None else f', lse max err {lse_err:.3e}'}"
              f"; control without the last {s_ - n} keys: excess {control:.3e} (must be > 0); "
              f"into a view of a wider buffer: the head bit-identical {same}, the "
              f"{SENTINEL_COLS} columns past it keep the sentinel {kept}", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0 and lse_err <= LSE_TOL,
              f"{name} {label}: excess {excess}, lse err {lse_err}")
        check(control > 0, f"{name} {label}: the control passes ({control})")
        check(same and kept, f"{name} {label}: written into a view: head same {same}, the "
                             f"columns past it kept {kept}")
        del out, ref, ctrl, buf


def sd15_slice(torch, np, dev, gen, m, counters):
    """sd15 agree and sd15 (see the module docstring). `counters` are every
    kernel wrapper's, by name. Returns the launches over the requests and the
    numbers."""
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers.sd15 import expected_launches_sd15, random_sd15_pipeline

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    pipe = random_sd15_pipeline(dev, bf16, seed=0)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("unet", "vae", "text_encoder")}
    print(f"[sd15] SD1.5 built on the card in {time.perf_counter() - t0:.1f} s: {n_params}, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)

    # ----------------------------------------------------------- sd15 agree
    f = pipe.vae_scale_factor
    lat = torch.randn((2, SD15_SIZE // f, SD15_SIZE // f, 4), generator=gen, device=dev)
    t = pipe.scheduler.set_timesteps(SD15_STEPS).timesteps[:1].to(dev).expand(2)
    ctx = torch.randn((2, 77, 768), generator=gen, device=dev, dtype=bf16)

    def unet(swaps=()):
        with torch.inference_mode(), swapped(swaps):
            return pipe.unet(lat.to(bf16), t, ctx).float()

    before = counters["flash_attention"].launches_by_dim.copy()
    out_k = unet()
    by_dim = dict(counters["flash_attention"].launches_by_dim - before)
    out_p = unet(plain_swaps(m, int8=False))
    rel = rel_l2(out_k, out_p)
    print(f"[sd15 agree] full-width SD1.5 UNet at {SD15_SIZE // f}x{SD15_SIZE // f} latents, "
          f"kernels (flash at head_dim 40 / 80 / 160: {by_dim} launches; GroupNorm) vs plain: "
          f"relative L2 {rel:.3e} (tol {AGREE_TOL}), |out| max {out_p.abs().max().item():.3f}",
          flush=True)
    check(bool(torch.isfinite(out_k).all()) and rel <= AGREE_TOL, f"sd15 agree: relative L2 {rel}")
    check(by_dim == {40: 5, 80: 5, 160: 5}, f"sd15 agree: flash launches by head_dim {by_dim}")
    del out_k, out_p, lat, ctx

    # ----------------------------------------------------------------- sd15
    want = expected_launches_sd15(pipe, SD15_SIZE, SD15_SIZE, SD15_STEPS, SD15_GUIDANCE)
    want_dim = want.pop("flash_attention_by_dim")
    want = {name: want.get(name, 0) for name in counters}
    print(f"[sd15] expected launches per request (walking the blocks): {want}; flash by head_dim "
          f"{want_dim}", flush=True)
    check(want_dim.get(160) == 250, f"sd15: {want_dim.get(160)} head_dim-160 launches walked")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    counters["flash_attention"].launches_by_dim.clear()
    seconds = []
    for i, (prompt, seed) in enumerate(SD15_REQUESTS):
        before = {name: fn.launches for name, fn in counters.items()}
        dim_before = counters["flash_attention"].launches_by_dim.copy()
        last = i == len(SD15_REQUESTS) - 1
        with profile(activities=[ProfilerActivity.CUDA]) if last else contextlib.nullcontext() \
                as prof:
            t0 = time.perf_counter()
            image = pipe(prompt, height=SD15_SIZE, width=SD15_SIZE,
                         num_inference_steps=SD15_STEPS, guidance_scale=SD15_GUIDANCE,
                         seed=seed, output_type="np")[0]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        got = {name: fn.launches - before[name] for name, fn in counters.items()}
        got_dim = dict(counters["flash_attention"].launches_by_dim - dim_before)
        print(f"[sd15] seed {seed}: {seconds[-1]:.3f} s{' (profiled)' if last else ''} | image "
              f"{image.shape} finite {bool(np.isfinite(image).all())} range [{image.min():.3f}, "
              f"{image.max():.3f}] mean {image.mean():.3f} std {image.std():.3f} | launches "
              f"{got}; flash by head_dim {got_dim}", flush=True)
        check(image.shape == (1, SD15_SIZE, SD15_SIZE, 3), f"sd15 image shape {image.shape}")
        check(bool(np.isfinite(image).all()), "sd15 image not finite")
        check(image.min() >= 0.0 and image.max() <= 1.0, "sd15 image outside [0, 1]")
        check(got == want and got_dim == want_dim,
              f"sd15: launches {got} / {got_dim} != expected {want} / {want_dim}")
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    device_ms = sum(ms_ for ms_, _, _ in by_kernel)
    busy = device_ms / 1e3 / seconds[-1]
    busy_unprofiled = device_ms / 1e3 / sorted(seconds[:-1])[len(seconds[:-1]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["flash_attention_d160"] = counters["flash_attention"].launches_by_dim[160]
    print(f"[sd15] seconds per request {[round(x, 3) for x in seconds]}; profiled request "
          f"{device_ms:.1f} ms of device time in {1e3 * seconds[-1]:.1f} ms: busy "
          f"{100 * busy:.1f}% ({100 * busy_unprofiled:.1f}% of the unprofiled requests' "
          f"median); {sum(n_ for _, n_, _ in by_kernel)} kernels; peak memory {peak:.2f} GiB; "
          f"launches over "
          f"{len(SD15_REQUESTS)} requests {launches}", flush=True)
    for ms_, n_, key in by_kernel[:10]:
        print(f"[sd15]   profiled request: {ms_:8.2f} ms {100 * ms_ / device_ms:5.1f}% {n_:6d}x "
              f"{key[:100]}", flush=True)
    del pipe
    return launches, dict(seconds=seconds, busy=busy, busy_unprofiled=busy_unprofiled,
                          peak_gib=peak, device_ms=device_ms)


# ------------------------------------------------- SD1.5 UNet fine-tuning
def sd15_train_kernels(torch, F, dev, gen, record, attn, cases=None,
                       tag="sd15 train kernels"):
    """B15 (the lse forward) and B14 (dkv, dq) against their plain versions
    per element at `cases` (SD15_TRAIN_FLASH_CASES: the SD1.5 training path's shapes,
    head_dim 256, heads of 32 or less, and causal + segment ids + GQA at 24,
    64, 160 and 256. B15 with the control that leaves out the last key tile;
    B14, fed B15's lse and the di of B15's o as the path feeds it, with two:
    di dropped, and the last key tile left out, and where segments are a
    third, its tiled plain version skipping one tile pair that shares a
    segment. Times, bounds and library times (SDPA; the backward of SDPA,
    graph-captured)."""
    bf16 = torch.bfloat16
    sound, controls_need = [], []
    for b_, s_, h_, kvh, d_, masked in cases or SD15_TRAIN_FLASH_CASES:
        shape = (b_, s_, h_, kvh, d_)
        q = torch.randn((b_, s_, h_, d_), generator=gen, device=dev).to(bf16)
        k, v = (torch.randn((b_, s_, kvh, d_), generator=gen, device=dev).to(bf16)
                for _ in range(2))
        do = torch.randn((b_, s_, h_, d_), generator=gen, device=dev).to(bf16)
        kw, seg, pairs = {}, None, b_ * h_ * s_ * s_
        if masked:
            seg = torch.ones((b_, s_), dtype=torch.int32, device=dev)
            for cut in TRAIN_SEGMENT_CUTS:
                seg[:, int(cut * s_):] += 1
            kw = dict(causal=True, segment_ids=attn.SegmentIds(seg, seg))
            lengths = [int(n) for n in torch.unique_consecutive(seg[0], return_counts=True)[1]]
            pairs = b_ * h_ * sum(n * (n + 1) // 2 for n in lengths)
        n = s_ - (s_ % 64 or 64)  # the controls' keys: all but the last tile
        kw_cut = dict(kw, segment_ids=attn.SegmentIds(seg, seg[:, :n])) if masked else kw
        scale = d_ ** -0.5
        qs = (q.float() * (scale * attn.LOG2E)).to(bf16)
        f32 = (qs.float(), k.float(), v.float(), do.float())
        label = f"{shape}{' causal + 4 segments' if masked else ''}"

        def named(kernel):  # the summary's name: D = 64 and 128 share the SFT entries
            return kernel if d_ in (64, 128) else f"{kernel}_d{d_}"
        # B15
        o, lse = attn.flash_fwd_lse(qs, k, v, **kw)
        torch.cuda.synchronize()
        ro, rlse = attn.flash_fwd_lse_ref(*f32[:3], **kw)
        excess, need = ulp_gate(o, ro, TRAIN_SUM)
        lse_err = (lse - rlse).abs().max().item()
        # (a query whose segment lies wholly in the last tile sees no key: 0)
        control = ulp_gate(attn.flash_fwd_lse_ref(f32[0], f32[1][:, :n], f32[2][:, :n],
                                                  **kw_cut)[0].nan_to_num(0.0), ro, TRAIN_SUM)
        sound.append(need)
        controls_need.append(control[1])
        print(f"[{tag}] flash_fwd_lse {label}: o excess {excess:.3e} (least c "
              f"{need:.2e}, c {TRAIN_SUM}), lse max err {lse_err:.3e} (tol {LSE_TOL}); control "
              f"without the last {s_ - n} keys, least c {control[1]:.2e} (must be > c)",
              flush=True)
        check(bool(torch.isfinite(o).all()) and excess <= 0 and lse_err <= LSE_TOL,
              f"flash_fwd_lse {label}: excess {excess}, lse err {lse_err}")
        check(control[0] > 0, f"flash_fwd_lse {label}: the control passes ({control})")
        ms, plain_ms = timed_pair(torch, lambda: attn.flash_fwd_lse(qs, k, v, **kw),
                                  lambda: attn.flash_fwd_lse_ref(qs, k, v, **kw))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=masked, enable_gqa=h_ != kvh))
        record(tag, named("flash_fwd_lse"), shape,
               (o.float() - ro).abs().max().item(), ms, plain_ms, lib_ms,
               bound(nbytes(qs, k, v, o, lse, seg, seg), 4 * d_ * pairs, "bf16"),
               (" causal + 4 segments" if masked else "") + " | library: SDPA"
               + (" is_causal, no segments" if masked else ""), flash=(d_, 4 * d_ * pairs, False))
        # B14, from B15's lse and o
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        del ro, rlse, qh, kh, vh, o
        dk, dv = attn.flash_bwd_dkv(qs, k, v, do, lse, di, **kw)
        dq = attn.flash_bwd_dq(qs, k, v, do, lse, di, scale=scale, **kw)
        again = (*attn.flash_bwd_dkv(qs, k, v, do, lse, di, **kw),
                 attn.flash_bwd_dq(qs, k, v, do, lse, di, scale=scale, **kw))
        torch.cuda.synchronize()
        same = all(torch.equal(a_, b_) for a_, b_ in zip((dk, dv, dq), again))
        del again
        core, note = bwd_core(d_)
        print(f"[{tag}] flash_bwd {label}: core {core} ({note}); two launches "
              f"bit-identical: {same}", flush=True)
        check(same, f"flash_bwd {label}: two launches differ")
        no_di = torch.zeros_like(di)
        cut = (f32[0], f32[1][:, :n], f32[2][:, :n], f32[3], lse, di)
        bad = wrongly_skipped(attn, s_, kw) if masked else None

        def padded(ts):  # dk, dv of the first n keys, the last tile's rows left 0
            return tuple(F.pad(t, (0, 0, 0, 0, 0, s_ - n)) for t in ts)
        for name, outs in (("flash_bwd_dkv", (dk, dv)), ("flash_bwd_dq", (dq,))):
            if name == "flash_bwd_dkv":
                refs = attn.flash_bwd_dkv_ref(*f32, lse, di, **kw)
                tiled = attn.flash_bwd_dkv_tiled_ref(*f32, lse, di, **kw)
                ctrls = (attn.flash_bwd_dkv_ref(*f32, lse, no_di, **kw),
                         padded(attn.flash_bwd_dkv_ref(*cut, **kw_cut)))
                if masked:
                    ctrls += (attn.flash_bwd_dkv_tiled_ref(*f32, lse, di, visits=bad, **kw),)
                ops = 8 * d_ * pairs
            else:
                refs = (attn.flash_bwd_dq_ref(*f32, lse, di, scale=scale, **kw),)
                tiled = (attn.flash_bwd_dq_tiled_ref(*f32, lse, di, scale=scale, **kw),)
                ctrls = ((attn.flash_bwd_dq_ref(*f32, lse, no_di, scale=scale, **kw),),
                         (attn.flash_bwd_dq_ref(*cut, scale=scale, **kw_cut),))
                if masked:
                    ctrls += ((attn.flash_bwd_dq_tiled_ref(*f32, lse, di, scale=scale,
                                                           visits=bad, **kw),),)
                ops = 6 * d_ * pairs
            # against the plain version and its tiled walk (the kernels' skips)
            gates = [ulp_gate(o_, r_, TRAIN_SUM) for o_, r_ in zip(outs, refs)] + \
                [ulp_gate(o_, r_, TRAIN_SUM) for o_, r_ in zip(outs, tiled)]
            ctrl = [max((ulp_gate(c_, r_, TRAIN_SUM) for c_, r_ in zip(c_outs, refs)),
                        key=lambda g: g[0]) for c_outs in ctrls]
            sound += [g[1] for g in gates]
            controls_need += [c_[1] for c_ in ctrl]
            err = max((o_.float() - r_).abs().max().item() for o_, r_ in zip(outs, refs))
            skipped = f", a tile pair sharing a segment skipped {ctrl[2][1]:.2e}" if masked else ""
            print(f"[{tag}] {name} {label}: excess {[f'{g[0]:.3e}' for g in gates]} "
                  f"(least c {[f'{g[1]:.2e}' for g in gates]}, c {TRAIN_SUM}; plain, then "
                  f"tiled); controls, least c (must be > c): di dropped {ctrl[0][1]:.2e}, the "
                  f"last {s_ - n} keys left out {ctrl[1][1]:.2e}{skipped}", flush=True)
            check(all(bool(torch.isfinite(o_).all()) for o_ in outs)
                  and all(g[0] <= 0 for g in gates), f"{name} {label}: excess {gates}")
            check(all(c_[0] > 0 for c_ in ctrl), f"{name} {label}: a control passes {ctrl}")
            del refs, tiled, ctrls
            if name == "flash_bwd_dkv":
                ms, plain_ms = timed_pair(
                    torch, lambda: attn.flash_bwd_dkv(qs, k, v, do, lse, di, **kw),
                    lambda: attn.flash_bwd_dkv_ref(qs, k, v, do, lse, di, **kw))
            else:
                ms, plain_ms = timed_pair(
                    torch, lambda: attn.flash_bwd_dq(qs, k, v, do, lse, di, scale=scale, **kw),
                    lambda: attn.flash_bwd_dq_ref(qs, k, v, do, lse, di, scale=scale, **kw))
            lib = sum(backward_ms(torch, lambda *t: F.scaled_dot_product_attention(
                *t, is_causal=masked, enable_gqa=h_ != kvh),
                tuple(t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)),
                do.transpose(1, 2)) for _ in range(2)) / 2
            record(tag, named(name), shape, err, ms, plain_ms, lib,
                   bound(nbytes(qs, k, v, do, lse, di, seg, seg, *outs), ops, "bf16"),
                   (" causal + 4 segments" if masked else "") + " | library: the backward of "
                   "SDPA (dq, dk, dv together)" + (" is_causal, no segments" if masked else ""),
                   bwd=(d_, ops))
        del q, k, v, do, qs, f32, lse, di, no_di, cut, dk, dv, dq
        torch.cuda.empty_cache()
    print(f"[{tag}] B15 / B14 gate c {TRAIN_SUM}: the kernels' least c at most "
          f"{max(sound):.2e}, the controls' at least {min(controls_need):.2e}", flush=True)


def sd15_train_slice(torch, np, dev, m, counters):
    """sd15 train agree and sd15 train (see the module docstring): the SD1.5
    UNet (fp32 masters, bf16 compute) fine-tuned by the recipe of
    examples/train_text_to_image.py. `counters` are every kernel wrapper's,
    by name: the path must launch B15, B14 and B4 as the walk says, and
    nothing else. Returns (launches, launches by head_dim of B15 / B14, the
    numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers import DDPMScheduler
    from paddlemix_tpu_torch.diffusers import training_utils
    from paddlemix_tpu_torch.diffusers.sd15 import (
        SD15_SCHEDULER,
        expected_launches_sd15_train,
        random_sd15_unet,
        unet_train_flops,
    )
    from paddlemix_tpu_torch.tools import train_text_to_image as t2i

    attn = m.attn
    by_dim = [attn.flash_fwd_lse, attn.flash_bwd_dkv, attn.flash_bwd_dq]

    def zero():
        for fn in counters.values():
            fn.launches = 0
        for fn in by_dim:
            fn.launches_by_dim.clear()

    def launches():
        got = {name: fn.launches for name, fn in counters.items()}
        got_dim = {fn.__name__: dict(fn.launches_by_dim) for fn in by_dim}
        return got, got_dim

    def walk(batch, steps):
        want = expected_launches_sd15_train(unet, batch, 64, steps)
        dims = want.pop("flash_by_dim")
        return ({name: want.get(name, 0) for name in counters},
                {fn.__name__: dims for fn in by_dim})

    t0 = time.perf_counter()
    unet = random_sd15_unet(dev, seed=0)
    sched = DDPMScheduler.from_config(SD15_SCHEDULER)
    torch.cuda.synchronize()
    params = [p for p in unet.parameters() if p.requires_grad]
    names = [n for n, p in unet.named_parameters() if p.requires_grad]
    print(f"[sd15 train] SD1.5 UNet built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in params)} fp32 parameters in {len(params)} tensors, "
          f"{unet.dtype} compute; scheduler DDPM from the checkpoint's config {SD15_SCHEDULER}",
          flush=True)

    # ------------------------------------------------------ sd15 train agree
    gen = torch.Generator(device=dev).manual_seed(3)
    b = SD15_AGREE_BATCH
    batch = {"latents": torch.randn((b, 64, 64, 4), generator=gen, device=dev),
             "encoder_hidden_states": torch.randn((b, 77, 768), generator=gen, device=dev)}
    t = torch.tensor(SD15_AGREE_T, device=dev)
    noise = torch.randn((b, 64, 64, 4), generator=gen, device=dev)
    plain_all, rounded_all = train_plain_swaps(torch, m)
    gn = (m.resnet, "group_norm", m.norms.group_norm_ref)
    plain, rounded = plain_all[:3] + [gn], rounded_all[:3] + [gn]
    no_di = [(attn, "flash_bwd_dkv", lambda qs, k, v, do, lse, di, **kw: attn.flash_bwd_dkv_ref(
        qs, k, v, do, lse, torch.zeros_like(di), **kw))] + [plain[0], plain[2], gn]

    def loss_and_grads(swaps=()):
        with swapped(swaps):
            loss = training_utils.sd_loss(unet, sched, batch, t, noise, snr_gamma=5.0)
            grads = torch.autograd.grad(loss, params)
        return loss.detach().float(), grads

    zero()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    got = launches()
    loss_p, grads_p = loss_and_grads(plain)
    gaps = {"kernels": [rel_l2(a.float(), b_.float()) for a, b_ in zip(grads_k, grads_p)]}
    del grads_k
    losses = {"kernels": loss_k}
    for key, swaps in (("pair", rounded), ("control", no_di)):
        losses[key], grads = loss_and_grads(swaps)
        gaps[key] = [rel_l2(a.float(), b_.float()) for a, b_ in zip(grads, grads_p)]
        del grads
    del grads_p
    signal = [i for i, gap_ in enumerate(gaps["pair"]) if gap_ <= CLIP_SIGNAL_GAP]

    def median_max(key):
        return sorted(gaps[key])[len(names) // 2], max(gaps[key][i] for i in signal)

    (k_med, k_max), (r_med, r_max), (c_med, c_max) = map(median_max, ("kernels", "pair", "control"))
    rel_loss = {key: abs(v - loss_p).item() / abs(loss_p).item() for key, v in losses.items()}
    noise_only = sorted((gaps["pair"][i], names[i]) for i in range(len(names)) if i not in signal)
    worst = max(signal, key=lambda i: gaps["kernels"][i])
    print(f"[sd15 train agree] full-width SD1.5 UNet, one micro-batch of {b} at 64x64 latents, "
          f"t {SD15_AGREE_T}, min-SNR 5, fixed noise; kernels vs plain: loss {loss_k.item():.6f} "
          f"vs {loss_p.item():.6f} (relative {rel_loss['kernels']:.3e}; the plain versions one "
          f"rounding apart, P rounded to bf16 before P.V, {rel_loss['pair']:.3e}, ratio tol "
          f"{CLIP_LOSS_RATIO}); relative L2 of the gradients, median of all {len(names)} / max of "
          f"the {len(signal)} with signal: kernels {k_med:.3e} / {k_max:.3e}, the pair "
          f"{r_med:.3e} / {r_max:.3e} (ratio tol {TRAIN_AGREE_RATIO}); control, B14's dK/dV "
          f"without di: {c_med:.3e} / {c_max:.3e} (must fail); left out as rounding noise alone "
          f"{[f'{n_} {g_:.3f}' for g_, n_ in noise_only]}; the kernels' largest gap "
          f"{names[worst]} {gaps['kernels'][worst]:.3e} (the pair {gaps['pair'][worst]:.3e}); "
          f"launches {got[0]}, by head_dim {got[1]}", flush=True)
    check(bool(torch.isfinite(loss_k)) and rel_loss["kernels"] <= CLIP_LOSS_RATIO * rel_loss["pair"]
          and k_med <= TRAIN_AGREE_RATIO * r_med and k_max <= TRAIN_AGREE_RATIO * r_max,
          f"sd15 train agree: loss {rel_loss}, grads {k_med} / {k_max} against {r_med} / {r_max}")
    check(c_med > TRAIN_AGREE_RATIO * r_med or c_max > TRAIN_AGREE_RATIO * r_max,
          f"sd15 train agree: the control passes ({c_med} / {c_max})")
    check(got == walk(b, 1), f"sd15 train agree: launches {got} != {walk(b, 1)}")
    del batch, noise

    # ------------------------------------------------------------ sd15 train
    t0 = time.perf_counter()
    samples = t2i.sd_samples(SD15_TRAIN_SAMPLES)
    trainer = t2i.build_trainer(unet, sched, samples, batch_size=SD15_TRAIN_BATCH)
    a = trainer.args
    print(f"[sd15 train] the example's {len(samples)} samples drawn in "
          f"{time.perf_counter() - t0:.1f} s; build_trainer: "
          f"{len(trainer.train_dataloader)} batches of {SD15_TRAIN_BATCH} an epoch, lr "
          f"{a.learning_rate}, {a.lr_scheduler_type} over max_steps {a.max_steps}, clip "
          f"{a.max_grad_norm}, seed {a.seed}; {SD15_TRAIN_STEPS} steps", flush=True)
    before = [p.detach().clone() for p in params]
    # the callbacks run every step (the recipe logs every 10th): one of them
    # steps the profiler, whose one active window is the last step. A step's
    # host time holds the callbacks of the step before it, so the step
    # before the last pays the profiler's start (seconds)
    a.logging_steps = 1
    profiled = SD15_TRAIN_STEPS
    zero()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA], schedule=torch.profiler.schedule(
            wait=profiled - 2, warmup=1, active=1, repeat=1)) as prof:
        trainer.callbacks.append(lambda step, metrics: prof.step())
        trainer.train(SD15_TRAIN_STEPS)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = launches()
    want = walk(SD15_TRAIN_BATCH, SD15_TRAIN_STEPS)
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    device_ms = sum(ms_ for ms_, _, _ in by_kernel)
    hist = trainer.history
    ends = [t_start] + [h["time"] for h in hist]
    step_s = [b_ - a_ for a_, b_ in zip(ends, ends[1:])]
    t_prof = step_s[profiled - 1]
    # the steady steps: not the first (the loader's start), not the
    # profiler's start or the profiled one
    middle = [i for i in range(1, len(hist)) if i not in (profiled - 2, profiled - 1)]
    s_step = sorted(step_s[i] for i in middle)[len(middle) // 2]
    reader = sorted(hist[i]["reader"] for i in middle)[len(middle) // 2]
    losses_ = torch.stack([h["loss"] for h in hist]).float()
    gnorms = torch.stack([h["grad_norm"] for h in hist]).float()
    moved = sum(not torch.equal(b_, p.detach()) for b_, p in zip(before, params))
    del before
    flops = unet_train_flops(unet, SD15_TRAIN_BATCH, 64)
    tflops = flops / s_step / 1e12
    print(f"[sd15 train] {len(hist)} optimizer steps of {SD15_TRAIN_BATCH} samples: seconds a "
          f"step {[round(x, 4) for x in step_s]} (step {profiled} under the profiler, step "
          f"{profiled - 1} starting it); median of steps 2-{profiled - 2} {s_step:.4f} s -> "
          f"{SD15_TRAIN_BATCH / s_step:.2f} samples/s, "
          f"{tflops:.1f} model TFLOP/s ({flops:.4e} flops a step), {100 * tflops / 989:.1f}% of "
          f"989; reader: median {1e3 * reader:.2f} ms a step; profiled step {profiled} "
          f"{t_prof:.4f} s with {device_ms:.1f} ms of device time: busy "
          f"{100 * device_ms / 1e3 / t_prof:.1f}%; peak memory {peak:.2f} GiB", flush=True)
    for ms_, n_, key in by_kernel[:15]:
        print(f"[sd15 train]   profiled step: {ms_:8.2f} ms {100 * ms_ / device_ms:5.1f}% "
              f"{n_:5d}x {key[:100]}", flush=True)
    b14_ms = bwd_share("[sd15 train]", by_kernel, device_ms)
    print(f"[sd15 train] losses {[round(x, 4) for x in losses_.tolist()]}; grad_norm "
          f"{[round(x, 4) for x in gnorms.tolist()]}; {moved} of {len(params)} parameter "
          f"tensors moved; launches {got[0]}, by head_dim {got[1]} (walk: {want})", flush=True)
    check(len(hist) == SD15_TRAIN_STEPS and bool(torch.isfinite(losses_).all()
                                                  and torch.isfinite(gnorms).all()),
          "sd15 train: a loss or grad_norm is not finite")
    check(moved == len(params), f"sd15 train: {len(params) - moved} parameter tensors did not "
          f"move")
    check(got == want, f"sd15 train: launches {got} != expected {want}")
    del trainer, unet, params, samples
    gc.collect()
    torch.cuda.empty_cache()
    stats = dict(step_s=s_step, samples_per_s=SD15_TRAIN_BATCH / s_step, tflops=tflops,
                 reader_share=reader / s_step, busy=device_ms / 1e3 / t_prof, peak_gib=peak,
                 b14_ms=b14_ms, b14_share=b14_ms / device_ms)
    return got[0], got[1], stats


# ------------------------------------------- diffusers directories (41a-41e)
def write_diffusers_dir(torch, pipe, path, scheduler_config):
    """`pipe` (an SD pipeline of the port) as diffusers publishes it: each
    model's state_dict under its HF names and layouts ((out, in) Linears,
    OIHW convs, fp32) in `diffusion_pytorch_model.safetensors` (UNet, VAE)
    or `model.safetensors` (the text tower), diffusers' and transformers'
    config.json, the tokenizer's vocab.json and merges.txt, `scheduler_config`
    and model_index.json with null optional components. Returns the bytes of
    the weights written."""
    from paddlemix_tpu_torch.core import safetensors as st

    index = {"_class_name": type(pipe).__name__, "_diffusers_version": "0.6.0",
             "feature_extractor": [None, None], "safety_checker": [None, None],
             "requires_safety_checker": False}
    written = 0
    for name, lib, fname in (("unet", "diffusers", "diffusion_pytorch_model.safetensors"),
                             ("vae", "diffusers", "diffusion_pytorch_model.safetensors"),
                             ("text_encoder", "transformers", "model.safetensors")):
        comp = getattr(pipe, name)
        sub = os.path.join(path, name)
        os.makedirs(sub)
        cfg = {k: v for k, v in comp.config.to_dict().items()
               if k not in ("model_type", "_class_name")}
        if lib == "diffusers":
            cfg.update(_class_name=type(comp).__name__, _diffusers_version="0.6.0")
        else:
            cfg.update(architectures=[type(comp).__name__], model_type="clip_text_model")
        with open(os.path.join(sub, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        written += st.save_file(dict(comp.state_dict()), os.path.join(sub, fname))
        index[name] = [lib, type(comp).__name__]
    pipe.tokenizer.save_pretrained(os.path.join(path, "tokenizer"))
    os.makedirs(os.path.join(path, "scheduler"))
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(scheduler_config, f, indent=2)
    index.update(tokenizer=["transformers", "CLIPTokenizer"],
                 scheduler=["diffusers", scheduler_config["_class_name"]])
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return written


def unequal_tensors(torch, a, b):
    """The SD pipelines' models' state_dict keys whose tensors differ in dtype
    or bits."""
    out = []
    for name in ("unet", "vae", "text_encoder"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        if sa.keys() != sb.keys():
            out.append(f"{name}: keys differ")
            continue
        out += [f"{name}.{k}" for k, v in sa.items()
                if not (v.dtype == sb[k].dtype and torch.equal(v, sb[k]))]
    return out


def profiled_steps(torch, trainer):
    """Two more optimizer steps of `trainer`, the second under the profiler
    (the first starts it): (its host seconds, its device ms)."""
    from torch.profiler import ProfilerActivity, profile

    trainer.args.logging_steps = 1
    with profile(activities=[ProfilerActivity.CUDA], schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        trainer.callbacks.append(lambda step, metrics: prof.step())
        trainer.train(trainer.state.step + 2)
        torch.cuda.synchronize()
    trainer.callbacks.pop()
    hist = trainer.history
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return hist[-1]["time"] - hist[-2]["time"], device_ms


def step_seconds(trainer):
    """The median host seconds of a step of the run, its first left out."""
    times = [h["time"] for h in trainer.history]
    steps = sorted(b_ - a_ for a_, b_ in zip(times, times[1:]))
    return steps[len(steps) // 2]


def sd15_dir_slice(torch, F, np, dev, gen, m, counters, record, gn_case, card):
    """Phases 41a-41d (see the module docstring): the SD1.5 diffusers
    directory written and read back, text_to_image on it, the VAE encoder,
    and the three training mains. Everything is written under one temporary
    directory, removed in a `finally`. Returns ({phase: launches}, {phase:
    {wrapper: launches by head_dim}}, the numbers)."""
    import shutil
    import tempfile

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers import AutoencoderKL, DiffusionPipeline, \
        UNet2DConditionConfig, UNet2DConditionModel
    from paddlemix_tpu_torch.diffusers.models.resnet import n_group_norms
    from paddlemix_tpu_torch.diffusers.sd15 import SD15_UNET, expected_launches_sd15, \
        expected_launches_sd15_train, random_sd15_pipeline
    from paddlemix_tpu_torch.models.layers import n_layer_norms
    from paddlemix_tpu_torch.peft import attach_lora, load_lora, merge_lora_into_model
    from paddlemix_tpu_torch.tools import text_to_image
    from paddlemix_tpu_torch.tools import train_dreambooth as db
    from paddlemix_tpu_torch.tools import train_dreambooth_lora as dbl
    from paddlemix_tpu_torch.tools import train_text_to_image as t2i

    bf16 = torch.bfloat16
    attn = m.attn
    by_dim_fns = [attn.flash_attention, attn.flash_fwd_lse, attn.flash_bwd_dkv,
                  attn.flash_bwd_dq]
    phases, dims, stats = {}, {}, {}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        for fn in by_dim_fns:
            fn.launches_by_dim.clear()

    def launches():
        return ({name: fn.launches for name, fn in counters.items()},
                {fn.__name__: dict(fn.launches_by_dim) for fn in by_dim_fns})

    def walk(*parts):
        total = collections.Counter()
        for part in parts:
            total.update({k: v for k, v in part.items() if k in counters})
        return {name: total.get(name, 0) for name in counters}

    tmp = tempfile.mkdtemp(prefix="pmix_smoke_sd15_dir_")
    try:
        # ---------------------------------------------- 41a the SD1.5 directory
        t0 = time.perf_counter()
        pipe = random_sd15_pipeline(dev, torch.float32, seed=0, tokenizer=specials_tokenizer())
        torch.cuda.synchronize()
        comps = {n: getattr(pipe, n) for n in ("unet", "vae", "text_encoder")}
        nbytes_ = {n: sum(t.numel() * t.element_size() for t in c.state_dict().values())
                   for n, c in comps.items()}
        total = sum(nbytes_.values())
        # the diffusers directory, the port's, and the full DreamBooth's unet/
        need = 2 * total + nbytes_["unet"] + 2 ** 30
        free = shutil.disk_usage(tmp).free
        print(f"[sd15 dir] SD1.5 built in fp32 in {time.perf_counter() - t0:.1f} s "
              f"({', '.join(f'{n} {b_ / 1e9:.3f} GB' for n, b_ in nbytes_.items())}); {tmp}: "
              f"{free / 1e9:.1f} GB free, this phase needs up to {need / 1e9:.1f} GB", flush=True)
        check(free >= need, f"sd15 dir: {free / 1e9:.1f} GB free under {tmp}, "
              f"{need / 1e9:.1f} GB needed (set TMPDIR to a larger disk)")
        hf_dir, port_dir = os.path.join(tmp, "sd15"), os.path.join(tmp, "port")
        t0 = time.perf_counter()
        hf_bytes = write_diffusers_dir(torch, pipe, hf_dir, SD15_DIR_SCHEDULER)
        t_hf = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipe.save_pretrained(port_dir)
        t_port = time.perf_counter() - t0
        reads = {}
        for label, path in (("diffusers layout", hf_dir), ("port's save_pretrained", port_dir)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = DiffusionPipeline.from_pretrained(path, dtype=torch.float32, device=dev)
            torch.cuda.synchronize()
            reads[label] = time.perf_counter() - t0
            unequal = unequal_tensors(torch, pipe, back)
            print(f"[sd15 dir] {label}: DiffusionPipeline.from_pretrained back to the card in "
                  f"fp32 {reads[label]:.2f} s ({total / 1e9 / reads[label]:.2f} GB/s), "
                  f"{type(back).__name__} with {type(back.scheduler).__name__}; tensors not "
                  f"bit-equal to the pipeline that wrote it: {len(unequal)} {unequal[:3]}",
                  flush=True)
            check(type(back).__name__ == "StableDiffusionPipeline" and not unequal,
                  f"sd15 dir: {label}: {len(unequal)} tensors differ")
            del back
        print(f"[sd15 dir] written: diffusers layout {hf_bytes / 1e9:.3f} GB of fp32 weights in "
              f"{t_hf:.2f} s ({hf_bytes / 1e9 / t_hf:.2f} GB/s), {sorted(os.listdir(hf_dir))}; "
              f"the port's save_pretrained in {t_port:.2f} s ({total / 1e9 / t_port:.2f} GB/s) "
              f"({card})", flush=True)
        stats["io"] = dict(gb=total / 1e9, write_hf_s=t_hf, write_port_s=t_port,
                           read_hf_s=reads["diffusers layout"],
                           read_port_s=reads["port's save_pretrained"])
        shutil.rmtree(port_dir)
        del pipe, comps
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------------ 41b serving
        t0 = time.perf_counter()
        pipe = DiffusionPipeline.from_pretrained(hf_dir, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        want = expected_launches_sd15(pipe, SD15_SIZE, SD15_SIZE, 25, SD15_GUIDANCE)
        want_dim = want.pop("flash_attention_by_dim")
        want = walk(want)
        enc_gn, te_ln = n_group_norms(pipe.vae.encoder), n_layer_norms(pipe.text_encoder)
        enc_flash = pipe.vae.encode_flash_launches(SD15_SIZE, SD15_SIZE)
        te_flash = pipe.text_encoder.text_model.flash_launches(pipe.tokenizer.model_max_length)
        png = os.path.join(tmp, "out.png")
        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        text_to_image.main([hf_dir, SD15_DIR_PROMPT, png], device=dev)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, got_dim = launches()
        with Image.open(png) as im:
            image = np.asarray(im.convert("RGB"), np.float32) / 255.0
        print(f"[sd15 serve] text_to_image.main on the directory (read in bf16, 25 PNDM steps, "
              f"{SD15_SIZE} px, guidance {SD15_GUIDANCE}): {t_main:.3f} s with the read; PNG "
              f"{image.shape} finite {bool(np.isfinite(image).all())} range [{image.min():.3f}, "
              f"{image.max():.3f}] std {image.std():.3f}; peak memory {peak:.2f} GiB; launches "
              f"{got}, flash by head_dim {got_dim['flash_attention']} (walk {want}, "
              f"{want_dim})", flush=True)
        check(image.shape == (SD15_SIZE, SD15_SIZE, 3) and bool(np.isfinite(image).all())
              and image.min() >= 0.0 and image.max() <= 1.0 and image.std() > 0.01,
              f"sd15 serve: image {image.shape} range [{image.min()}, {image.max()}]")
        check(got == want and got_dim["flash_attention"] == want_dim,
              f"sd15 serve: launches {got} / {got_dim} != the walk {want} / {want_dim}")
        phases["sd15_dir"], dims["sd15_dir"] = got, got_dim
        seconds = []
        for profiled in (False, True):
            with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                    contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                pipe(SD15_DIR_PROMPT, height=SD15_SIZE, width=SD15_SIZE, num_inference_steps=25,
                     guidance_scale=SD15_GUIDANCE, seed=1, output_type="np")
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        print(f"[sd15 serve] a request on the pipeline read by DiffusionPipeline.from_pretrained "
              f"({t_load:.2f} s to read in bf16): {seconds[0]:.3f} s; profiled {seconds[1]:.3f} "
              f"s with {device_ms:.1f} ms of device time: busy {100 * device_ms / 1e3 / seconds[1]:.1f}% "
              f"({100 * device_ms / 1e3 / seconds[0]:.1f}% of the unprofiled one) ({card})",
              flush=True)
        stats["serve"] = dict(main_s=t_main, request_s=seconds[0], device_ms=device_ms,
                              busy=device_ms / 1e3 / seconds[1], peak_gib=peak, load_s=t_load)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------------------------------- 41c the VAE encoder
        for shape, act in VAE_ENCODE_GN_CASES:
            gn_case("vae encoder kernels", shape, act, control=True)
        vae = AutoencoderKL.from_pretrained(hf_dir, subfolder="vae", device=dev, dtype=bf16)
        x = torch.rand((1, SD15_SIZE, SD15_SIZE, 3), generator=gen, device=dev) * 2 - 1
        zero()
        with torch.inference_mode():
            post_k = vae.encode(x)
            torch.cuda.synchronize()
            got, got_dim = launches()
            with swapped(plain_swaps(m, int8=False)):
                post_p = vae.encode(x)
            enc_ms = cuda_ms(torch, lambda: vae.encode(x), iters=5, warmup=1)
        rel_mean = rel_l2(post_k.mean.float(), post_p.mean.float())
        rel_logvar = rel_l2(post_k.logvar.float(), post_p.logvar.float())
        print(f"[vae encode] the SD1.5 VAE encoder at {SD15_SIZE} px in bf16, kernels vs plain: "
              f"relative L2 of the mean {rel_mean:.3e}, of the log-variance {rel_logvar:.3e} (tol "
              f"{AGREE_TOL}); launches {got['group_norm']} B4, {got['flash_attention']} B1 (the "
              f"walk: {enc_gn} and {enc_flash}); an encode {enc_ms:.2f} ms ({card})", flush=True)
        check(bool(torch.isfinite(post_k.mean).all()) and rel_mean <= AGREE_TOL
              and rel_logvar <= AGREE_TOL, f"vae encode: relative L2 {rel_mean} / {rel_logvar}")
        check(got == walk({"group_norm": enc_gn, "flash_attention": enc_flash}) and enc_gn == 22,
              f"vae encode: launches {got}, the walk {enc_gn} B4")
        phases["vae_encode"] = got
        stats["encode_ms"] = enc_ms
        del vae, x, post_k, post_p

        # ------------------------------------------------------- 41d training
        sd15_train_kernels(torch, F, dev, gen, record, attn, cases=DREAMBOOTH_FLASH_CASES,
                           tag="dreambooth kernels")
        with torch.device("meta"):
            walk_unet = UNet2DConditionModel(UNet2DConditionConfig(**SD15_UNET))

        def train_walk(batch, steps):
            want_ = expected_launches_sd15_train(walk_unet, batch, 64, steps)
            return want_, want_.pop("flash_by_dim")

        images = {}
        for sub, seeds in (("instance", range(DREAMBOOTH_IMAGES)),
                           ("class", range(100, 100 + DREAMBOOTH_IMAGES))):
            os.makedirs(os.path.join(tmp, sub))
            for i in seeds:
                with open(os.path.join(tmp, sub, f"{i:03d}.jpg"), "wb") as f:
                    f.write(smooth_jpeg(np, Image, i))
            images[sub] = os.path.join(tmp, sub)
        runs = (
            ("t2i_dir", "train_text_to_image.main", DIR_T2I_STEPS, 8, 0, 0,
             lambda out: t2i.main([hf_dir], device=dev, max_steps=DIR_T2I_STEPS,
                                  output_dir=out)),
            ("db_lora", "train_dreambooth_lora.main", DREAMBOOTH_STEPS, 1, DREAMBOOTH_IMAGES, 1,
             lambda out: dbl.main([hf_dir, images["instance"], DREAMBOOTH_PROMPTS[0]],
                                  device=dev, max_steps=DREAMBOOTH_STEPS, output_dir=out)),
            ("db_full", "train_dreambooth.main", DREAMBOOTH_STEPS, 2, 2 * DREAMBOOTH_IMAGES, 2,
             lambda out: db.main([hf_dir, images["instance"], DREAMBOOTH_PROMPTS[0],
                                  images["class"], DREAMBOOTH_PROMPTS[1], "1.0"], device=dev,
                                 max_steps=DREAMBOOTH_STEPS, output_dir=out)))
        for phase, what, steps, batch, n_images, n_prompts, run in runs:
            gc.collect()
            torch.cuda.empty_cache()
            want_tr, want_dim = train_walk(batch, steps)
            want = walk(want_tr, {"group_norm": enc_gn * n_images,
                                  "flash_attention": enc_flash * n_images + te_flash * n_prompts,
                                  "layer_norm": te_ln * n_prompts})
            out_dir = os.path.join(tmp, phase)
            zero()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = run(out_dir)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got, got_dim = launches()
            trainer = result[0]
            losses_ = torch.stack([h["loss"] for h in trainer.history]).float()
            s_step = step_seconds(trainer)
            print(f"[{phase}] {what} on the directory, {steps} steps at batch {batch}"
                  f"{f' over {n_images} jpegs' if n_images else ''}: {t_run:.2f} s with the "
                  f"reads, the encoding and the save; {s_step:.4f} s a step (median); losses "
                  f"{[round(x_, 4) for x_ in losses_.tolist()]}; peak memory {peak:.2f} GiB; "
                  f"launches {got}, B15 / B14 by head_dim {got_dim['flash_fwd_lse']} (walk "
                  f"{want}, {want_dim})", flush=True)
            check(len(trainer.history) == steps and bool(torch.isfinite(losses_).all()),
                  f"{phase}: {len(trainer.history)} steps, losses {losses_.tolist()}")
            check(got == want and all(got_dim[fn.__name__] == want_dim for fn in by_dim_fns[1:]),
                  f"{phase}: launches {got} / {got_dim} != the walk {want} / {want_dim}")
            phases[phase], dims[phase] = got, got_dim
            if phase == "db_lora":
                factors, lcfg = load_lora(result[2])
                moved = sum(float(ab["b"].abs().max()) > 0 for ab in factors.values())
                attached = t2i.training_unet(hf_dir, dev)
                attach_lora(attached, factors, lcfg)
                merged = merge_lora_into_model(t2i.training_unet(hf_dir, dev), factors, lcfg)
                lat = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
                ctx = torch.randn((1, 77, 768), generator=gen, device=dev)
                tt = torch.tensor([500], device=dev)
                with torch.inference_mode():
                    out_a = attached(lat, tt, ctx).float()
                    out_m = merged(lat, tt, ctx).float()
                rel = rel_l2(out_m, out_a)
                print(f"[db_lora] the adapter ({len(factors)} pairs, {moved} with b moved off 0) "
                      f"read by load_lora: merge_lora_into_model's UNet against the attached "
                      f"one at 64x64 latents: relative L2 {rel:.3e} (tol {AGREE_TOL})",
                      flush=True)
                check(len(factors) == 128 and moved == len(factors) and rel <= AGREE_TOL,
                      f"db_lora: {len(factors)} pairs, {moved} moved, merged vs attached {rel}")
                del attached, merged, lat, ctx, out_a, out_m
            if phase == "db_full":
                back = UNet2DConditionModel.from_pretrained(result[2], device=dev)
                mine, theirs = trainer.model.state_dict(), back.state_dict()
                unequal = [k for k, v in mine.items() if not torch.equal(v, theirs[k])]
                print(f"[db_full] the saved unet/ read back: {len(unequal)} of {len(mine)} "
                      f"tensors not bit-equal to the trained model", flush=True)
                check(not unequal and mine.keys() == theirs.keys(),
                      f"db_full: {len(unequal)} tensors differ")
                del back, mine, theirs
            t_prof, dev_ms = profiled_steps(torch, trainer)
            print(f"[{phase}] a profiled step: {t_prof:.4f} s with {dev_ms:.1f} ms of device "
                  f"time: busy {100 * dev_ms / 1e3 / t_prof:.1f}% ({card})", flush=True)
            stats[phase] = dict(step_s=s_step, run_s=t_run, peak_gib=peak, device_ms=dev_ms,
                                busy=dev_ms / 1e3 / t_prof)
            del trainer, result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return phases, dims, stats


def sdxl_dir_slice(torch, np, dev, gen, counters, card):
    """Phase 41e (see the module docstring). Returns the directory request's
    launches and the numbers."""
    import shutil
    import tempfile

    from paddlemix_tpu_torch.diffusers import DiffusionPipeline
    from paddlemix_tpu_torch.diffusers.sdxl import expected_launches, random_sdxl_pipeline

    bf16 = torch.bfloat16
    tmp = tempfile.mkdtemp(prefix="pmix_smoke_sdxl_dir_")
    try:
        t0 = time.perf_counter()
        pipe = random_sdxl_pipeline(dev, torch.float32, seed=SDXL_DIR_SEED,
                                    tokenizer=specials_tokenizer())
        torch.cuda.synchronize()
        names = ("unet", "vae", "text_encoder", "text_encoder_2")
        total = sum(t.numel() * t.element_size() for n in names
                    for t in getattr(pipe, n).state_dict().values())
        free = shutil.disk_usage(tmp).free
        print(f"[sdxl dir] SDXL base built in fp32 in {time.perf_counter() - t0:.1f} s "
              f"({total / 1e9:.3f} GB); {tmp}: {free / 1e9:.1f} GB free, this phase needs "
              f"{(total + 2 ** 30) / 1e9:.1f} GB", flush=True)
        check(free >= total + 2 ** 30, f"sdxl dir: {free / 1e9:.1f} GB free under {tmp}")
        path = os.path.join(tmp, "sdxl")
        t0 = time.perf_counter()
        pipe.save_pretrained(path)
        t_save = time.perf_counter() - t0
        for n in names:
            getattr(pipe, n).to(bf16)
        lat = torch.randn((1, HEIGHT // 8, WIDTH // 8, 4), generator=gen, device=dev)
        call = dict(height=HEIGHT, width=WIDTH, num_inference_steps=STEPS,
                    guidance_scale=GUIDANCE, latents=lat, output_type="np")
        want = expected_launches(pipe, HEIGHT, WIDTH, STEPS, GUIDANCE)
        want = {name: want.get(name, 0) for name in counters}
        t0 = time.perf_counter()
        ref = pipe(REQUESTS[0][0], **call)[0]
        torch.cuda.synchronize()
        t_mem = time.perf_counter() - t0
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = DiffusionPipeline.from_pretrained(path, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        image = loaded(REQUESTS[0][0], **call)[0]
        torch.cuda.synchronize()
        t_dir = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in counters.items()}
        same = bool(np.array_equal(ref, image))
        files = sorted(os.listdir(os.path.join(path, "unet")))
        print(f"[sdxl dir] save_pretrained of the fp32 pipeline {t_save:.2f} s "
              f"({total / 1e9 / t_save:.2f} GB/s; unet/ {files}); "
              f"DiffusionPipeline.from_pretrained in bf16 {t_load:.2f} s "
              f"({total / 1e9 / t_load:.2f} GB/s of the file), {type(loaded).__name__} with "
              f"{type(loaded.scheduler).__name__}; one request {HEIGHT} px, {STEPS} steps, CFG "
              f"{GUIDANCE}: the in-memory pipeline {t_mem:.3f} s, the directory's {t_dir:.3f} s; "
              f"images bit-equal {same}, finite {bool(np.isfinite(image).all())}, range "
              f"[{image.min():.3f}, {image.max():.3f}]; launches {got} (walk {want}) ({card})",
              flush=True)
        check(type(loaded).__name__ == "StableDiffusionXLPipeline" and same,
              "sdxl dir: the directory's image differs from the in-memory pipeline's")
        check(bool(np.isfinite(image).all()) and image.min() >= 0 and image.max() <= 1,
              "sdxl dir: image not finite in [0, 1]")
        check(got == want, f"sdxl dir: launches {got} != the walk {want}")
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return got, dict(gb=total / 1e9, save_s=t_save, load_s=t_load, request_s=t_dir)


def segment_flash_case(torch, F, dev, gen, record, attn, s_, lengths, label):
    """B1 non-causal with segment ids at (1, s_, 16, 80), the tower's packed
    layout: segments of `lengths` (1, 2, ...) and pad rows in segment 0 to
    s_, per element against the plain version (c FLASH_SUM; the pad rows
    attend among themselves in both), with the control that moves every
    segment boundary one row later, which must fail; times, the bound over
    the visible pairs, SDPA with the same bool mask."""
    bf16, h_, d_ = torch.bfloat16, 16, 80
    q, k, v = (torch.randn((1, s_, h_, d_), generator=gen, device=dev, dtype=bf16)
               for _ in range(3))
    seg = torch.zeros((1, s_), dtype=torch.int32, device=dev)
    late = torch.zeros_like(seg)
    start = 0
    for i, n in enumerate(lengths):
        seg[0, start:start + n] = i + 1
        late[0, start + 1:start + n + 1] = i + 1
        start += n
    late[0, 0] = 1 if lengths else 0
    segs, segs_late = attn.SegmentIds(seg, seg), attn.SegmentIds(late, late)
    out = attn.flash_attention(q, k, v, segment_ids=segs, int8_qk=False)
    torch.cuda.synchronize()
    ref = attn.flash_attention_ref(q.float(), k.float(), v.float(), segment_ids=segs)
    err = (out.float() - ref).abs().max().item()
    excess, need = ulp_gate(out, ref, FLASH_SUM)
    control, _ = ulp_gate(attn.flash_attention_ref(q.float(), k.float(), v.float(),
                                                   segment_ids=segs_late), ref, FLASH_SUM)
    pads = s_ - sum(lengths)
    shape = (1, s_, h_, d_)
    print(f"[{label}] flash {shape} bf16, segments {tuple(lengths)} + {pads} pad rows "
          f"(segment 0): max_abs_err {err:.3e}, excess {excess:.3e} (least c {need:.2e}, c "
          f"{FLASH_SUM}); control with every boundary one row late: excess {control:.3e} (must "
          f"be > 0)", flush=True)
    check(bool(torch.isfinite(out).all()) and excess <= 0, f"flash {shape} segments: {excess}")
    check(control > 0, f"flash {shape} segments: the control passes ({control})")
    del ref
    kw = dict(segment_ids=segs)
    ms, plain_ms = timed_pair(torch, lambda: attn.flash_attention(q, k, v, int8_qk=False, **kw),
                              lambda: attn.flash_attention_ref(q, k, v, **kw))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    mask = (seg[0, :, None] == seg[0, None, :])[None, None]
    lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                       attn_mask=mask))
    pairs = sum(n * n for n in lengths) + pads * pads  # the visible (query, key) pairs
    ops = 4 * h_ * d_ * pairs
    record(label, "flash_attention", shape + (tuple(lengths),), err, ms, plain_ms, lib_ms,
           bound(nbytes(q, k, v, out, seg), ops, "bf16"), flash=(d_, ops, False))
    del q, k, v, out, mask


def qwen2vl_kernels(torch, F, dev, gen, record, m):
    """Phase 42a (see the module docstring)."""
    label = "qwen2vl kernels"
    norms, da = m.norms, m.da
    decode_kernels(torch, F, dev, gen, record, da, cases=QWEN2VL_DECODE_CASES, label=label)
    rms_kernels(torch, F, dev, gen, record, norms, shapes=QWEN2VL_RMS_SHAPES, extra=(),
                label=label)
    for rows, h in QWEN2VL_RMS_SHAPES + [(2426, 3584)]:
        plan, lib = norms.rms_norm_plan(rows, h, 2), norms.rms_norm_plan_library(
            rows, h, torch.bfloat16)
        print(f"[{label}] rms_norm plan ({rows}, {h}) bf16: mirror {plan}, library {lib}",
              flush=True)
        check(plan == lib, f"rms_norm plan ({rows}, {h}): mirror {plan} != library {lib}")
    clip_kernels(torch, F, dev, gen, record, norms, shapes=QWEN2VL_LN_SHAPES, backward=False,
                 label=label)
    for s_, lengths in QWEN2VL_FLASH_LAYOUTS:
        segment_flash_case(torch, F, dev, gen, record, m.attn, s_, lengths, label)
    torch.cuda.empty_cache()


def qwen2vl_video(np, Image, proc, jpegs):
    """The video request's inputs from its frames (jpeg bytes), assembled from
    the processor's functions as the JAX package's tests assemble them (its
    processor has no video entry, ROADMAP C.19): each frame decoded, resized
    by smart_resize and normalized; the frames patched in temporal pairs; one
    segment for the whole video (C.18); padded to the processor's bucket
    with segment 0."""
    import io

    from paddlemix_tpu_torch.processors import image_utils
    from paddlemix_tpu_torch.processors import qwen2_vl_processing as qp

    frames = []
    for data in jpegs:
        with Image.open(io.BytesIO(data)) as im:
            arr = np.asarray(im.convert("RGB"))
        size = qp.smart_resize(*arr.shape[:2], proc.patch_size * proc.merge_size,
                               proc.min_pixels, proc.max_pixels)
        arr = image_utils.resize(arr, size).astype(np.float32) / 255.0
        frames.append(image_utils.normalize(arr, proc.image_mean, proc.image_std))
    patches, grid = qp.extract_patches(np.stack(frames), proc.patch_size, proc.merge_size,
                                       proc.temporal_patch_size)
    pos_hw = qp.vision_patch_positions([grid], proc.merge_size)
    n = len(patches)
    pad = -(-n // proc.pad_to_multiple) * proc.pad_to_multiple - n
    return {"pixel_patches": np.pad(patches, ((0, pad), (0, 0)))[None],
            "patch_pos_hw": np.pad(pos_hw, ((0, pad), (0, 0)))[None].astype(np.int32),
            "patch_segments": np.pad(np.ones(n, np.int32), (0, pad))[None],
            "image_grid_thw": np.asarray([grid], np.int64), "num_patches": n}


def qwen2vl_slice(torch, np, dev, m, counters, card):
    """Phases 42b-42d (see the module docstring): Qwen2-VL-7B at full width
    with seeded random bf16 weights, written and read back, then served from
    the HF-layout read. `counters` are every kernel wrapper's, by name: each
    forward must launch B1, B10, B11 and B7 as the walk says, and nothing
    else. Returns the launches of the serve and its numbers."""
    import io
    import shutil
    import tempfile

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.models.llama import modeling as llama_mod
    from paddlemix_tpu_torch.models.qwen2_vl import (
        Qwen2VLForConditionalGeneration,
        expected_launches_qwen2_vl,
        get_rope_index,
        prompt_ids,
        random_qwen2_vl,
        save_published,
    )
    from paddlemix_tpu_torch.models.qwen2_vl.qwen2vl7b import NEW_TOKENS
    from paddlemix_tpu_torch.processors import Qwen2VLImageProcessor
    from paddlemix_tpu_torch.processors.qwen2_vl_processing import smart_nframes

    norms, da, attn = m.norms, m.da, m.attn
    bf16 = torch.bfloat16

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    # ------------------------------------------------------------ qwen2vl dir
    t0 = time.perf_counter()
    model = random_qwen2_vl(device=dev, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    cfg = model.config
    total = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[qwen2vl] Qwen2-VL-7B built on the card in {t_build:.1f} s: {n_params} parameters "
          f"(tower {sum(p.numel() for p in model.visual.parameters())}), {total / 1e9:.3f} GB "
          f"in bf16 (norms fp32), {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    check(8.2e9 < n_params < 8.4e9, f"qwen2vl: {n_params} parameters")
    io_stats = {}
    tmp = tempfile.mkdtemp(prefix="pmix_smoke_qwen2vl_dir_")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"[qwen2vl dir] {tmp}: {free / 1e9:.1f} GB free, this phase needs "
              f"{(total + 2 ** 30) / 1e9:.1f} GB at a time", flush=True)
        check(free >= total + 2 ** 30, f"qwen2vl dir: {free / 1e9:.1f} GB free under {tmp}")
        served = None
        for form in ("flax", "hf"):
            path = os.path.join(tmp, form)
            t0 = time.perf_counter()
            if form == "hf":  # the published layout: config.json with no text_config
                files = save_published(model, path)
            else:
                files = model.save_pretrained(path)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = Qwen2VLForConditionalGeneration.from_pretrained(path, device=dev, dtype=bf16)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
            mine = model.state_dict()
            differ = [k for k, t in back.state_dict().items()
                      if t.dtype != mine[k].dtype or not torch.equal(t, mine[k])]
            same_cfg = (back.config.text, back.config.vision, back.config.mrope_section,
                        back.config.rope_theta) == (cfg.text, cfg.vision, cfg.mrope_section,
                                                    cfg.rope_theta)
            if form == "hf":
                with open(os.path.join(path, "config.json")) as f:
                    layout = json.load(f)
                print(f"[qwen2vl dir] published config.json: no text_config "
                      f"{'text_config' not in layout}, top-level hidden_size "
                      f"{layout.get('hidden_size')}, rope_scaling {layout.get('rope_scaling')}, "
                      f"vision in_chans {layout['vision_config'].get('in_chans')}; read back to "
                      f"the same config {same_cfg}", flush=True)
                check("text_config" not in layout, "qwen2vl dir: config.json has a text_config")
            check(same_cfg, f"qwen2vl dir ({form}): the config read back differs")
            io_stats[form] = dict(write_s=t_write, read_s=t_read, files=len(files))
            print(f"[qwen2vl dir] {form} keys: {len(files)} files {sorted(files)[:2]}..., "
                  f"written in {t_write:.2f} s ({total / 1e9 / t_write:.2f} GB/s), read back in "
                  f"bf16 in {t_read:.2f} s ({total / 1e9 / t_read:.2f} GB/s); tensors differing "
                  f"{len(differ)} of {len(mine)} {differ[:3]} ({card})", flush=True)
            check(not differ, f"qwen2vl dir ({form}): {len(differ)} tensors differ: {differ[:3]}")
            shutil.rmtree(path)
            if form == "hf":
                served = back
            del back, mine
        del model
        model = served
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------- the requests
    proc = Qwen2VLImageProcessor()

    def jpeg(seed, hw):
        return smooth_jpeg(np, Image, seed, size=hw)

    n_frames = smart_nframes(int(QWEN2VL_CLIP_SECONDS * QWEN2VL_CLIP_FPS),
                             video_fps=QWEN2VL_CLIP_FPS)
    kinds = {
        "image": lambda i: [jpeg(300 + i, QWEN2VL_IMAGE)],
        "two images": lambda i: [jpeg(310 + 2 * i, QWEN2VL_PAIR), jpeg(311 + 2 * i, QWEN2VL_PAIR)],
        "video": lambda i: [jpeg(400 + 20 * i + f, QWEN2VL_FRAME) for f in range(n_frames)],
    }

    def process(kind, jpegs, seed):
        """The processor's outputs, the prompt (vision start / pad ids / end
        around each image or the video, 32 seeded text ids) and its M-RoPE
        streams."""
        if kind == "video":
            enc = qwen2vl_video(np, Image, proc, jpegs)
        else:
            images = []
            for data in jpegs:
                with Image.open(io.BytesIO(data)) as im:
                    images.append(im.convert("RGB"))
            enc = proc(images)
        spans = [("video" if kind == "video" else "image", int(np.prod(g)) // 4)
                 for g in enc["image_grid_thw"]]
        ids = prompt_ids(cfg, spans, seed=seed)
        pos = get_rope_index(ids.numpy(), enc["image_grid_thw"], cfg.image_token_id,
                             cfg.video_token_id, 2)
        return enc, ids, pos

    def vis(enc):
        return enc["pixel_patches"], enc["patch_pos_hw"], enc["patch_segments"]

    def walk(prompt_len, new_tokens, rows):
        want = expected_launches_qwen2_vl(model, prompt_len, new_tokens, rows)
        return {name: want.get(name, 0) for name in counters}

    # --------------------------------------------------------- qwen2vl agree
    enc, ids, pos = process("image", kinds["image"](0), 0)
    s_, rows = ids.shape[1], enc["pixel_patches"].shape[1]
    check((s_, rows, enc["num_patches"]) == (1230, 4864, 4784),
          f"qwen2vl: the image request has {s_} ids, {rows} rows, {enc['num_patches']} patches")
    toks = torch.randint(0, 151643, (QWEN2VL_AGREE_STEPS, 1, 1),
                         generator=torch.Generator().manual_seed(0)).to(dev)

    def steps(swaps=()):
        """Prefill logits (S, vocab) and those of the decode steps fed `toks`
        at M-RoPE positions max + 1 on."""
        with torch.inference_mode(), swapped(swaps):
            cache = model.init_cache(1, s_ + QWEN2VL_AGREE_STEPS)
            logits, cache = model(ids, pos, *vis(enc), cache=cache,
                                  positions=torch.arange(s_, device=dev)[None])
            outs = [logits[0].float()]
            for i, tok in enumerate(toks):
                p3 = np.full((3, 1, 1), int(pos.max()) + 1 + i)
                step, cache = model(tok, p3, cache=cache, positions=cache.lengths[:, None])
                outs.append(step[0].float())
        return outs[0], torch.cat(outs[1:])

    def flash_plain(q, k, v, *, causal=False, scale=None, segment_ids=None, int8_qk=None):
        return attn.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                        segment_ids=segment_ids)

    swaps = [(attn, "flash_attention", flash_plain),
             (llama_mod, "decode_attention", da.decode_attention_ref),
             (llama_mod, "rms_norm", norms.rms_norm_ref),
             (norms, "_ln_forward", norms.layer_norm_ref)]
    zero()
    pre_k, dec_k = steps()
    torch.cuda.synchronize()
    got = launches()
    pre_p, dec_p = steps(swaps)
    rel_pre, rel_dec = rel_l2(pre_k, pre_p), rel_l2(dec_k, dec_p)
    want = walk(s_, 1 + QWEN2VL_AGREE_STEPS, rows)
    print(f"[qwen2vl agree] full-width Qwen2-VL-7B, kernels (B1, B10, B11, B7) vs plain: "
          f"relative L2 of the logits, prefill ({s_} tokens: a 1280 x 720 jpeg's 1,196 "
          f"placeholders, {rows} packed rows) {rel_pre:.3e}, {QWEN2VL_AGREE_STEPS} decode steps "
          f"{rel_dec:.3e} (tol {LLAVA_AGREE_TOL}); |logits| max {pre_p.abs().max().item():.3f}; "
          f"ids fed {toks.view(-1).tolist()}; launches {got} (walk {want})", flush=True)
    check(bool(torch.isfinite(pre_k).all() and torch.isfinite(dec_k).all())
          and rel_pre <= LLAVA_AGREE_TOL and rel_dec <= LLAVA_AGREE_TOL,
          f"qwen2vl agree: relative L2 {rel_pre} / {rel_dec}")
    check(got == want, f"qwen2vl agree: launches {got} != the walk {want}")
    del pre_k, dec_k, pre_p, dec_p
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------- qwen2vl serve
    torch.cuda.reset_peak_memory_stats()
    totals, stats = collections.Counter(), collections.defaultdict(list)

    def request(kind, jpegs, seed, new_tokens):
        """(seconds, processor seconds, tokens, inputs) of one request: the
        jpegs decoded and processed, then `generate` (eos off)."""
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, ids, pos = process(kind, jpegs, seed)
        t_proc = time.perf_counter() - t0
        out = model.generate(ids, pos, *vis(enc), max_new_tokens=new_tokens, eos_token_id=-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, t_proc, out, (enc, ids, pos)

    def prefill_logits(enc, ids, pos, slots):
        with torch.inference_mode():
            logits, _ = model(ids, pos, *vis(enc), cache=model.init_cache(1, slots),
                              positions=torch.arange(ids.shape[1], device=dev)[None])
        return logits

    for kind, make in kinds.items():
        for i in range(QWEN2VL_REQUESTS):
            jpegs = make(i)
            runs = []
            for n_new in (1, NEW_TOKENS):
                runs.append(request(kind, jpegs, i, n_new))
                enc, ids, pos = runs[-1][3]
                got = launches()
                want = walk(ids.shape[1], n_new, enc["pixel_patches"].shape[1])
                totals.update(got)
                check(got == want, f"qwen2vl serve ({kind}): launches {got} != the walk {want}")
            (ttft, _, first, _), (seconds, t_proc, out, (enc, ids, pos)) = runs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                model.encode_images(*vis(enc))
            torch.cuda.synchronize()
            t_vis = time.perf_counter() - t0
            tps = (NEW_TOKENS - 1) / (seconds - ttft)
            row = dict(seconds=seconds, processor=t_proc, vision=t_vis,
                       prefill=ttft - t_proc - t_vis, decode=seconds - ttft, ttft=ttft,
                       tokens_per_s=tps, prompt=ids.shape[1], rows=enc["pixel_patches"].shape[1])
            stats[kind].append(row)
            print(f"[qwen2vl serve] {kind} request {i} ({ids.shape[1]} prompt ids, "
                  f"{enc['num_patches']} patches in {row['rows']} rows, grids "
                  f"{enc['image_grid_thw'].tolist()}): {seconds:.3f} s for {NEW_TOKENS} tokens = "
                  f"processor {1e3 * t_proc:.1f} + vision tower {1e3 * t_vis:.1f} + prefill "
                  f"{1e3 * row['prefill']:.1f} + decode {1e3 * row['decode']:.1f} ms | TTFT "
                  f"{1e3 * ttft:.1f} ms | decode {tps:.2f} tokens/s | tokens "
                  f"{out[0, :8].tolist()}...", flush=True)
            check(out.shape == (1, NEW_TOKENS) and out.dtype == torch.int32,
                  f"qwen2vl serve: tokens {tuple(out.shape)} {out.dtype}")
            check(bool(((out >= 0) & (out < cfg.text.vocab_size)).all()),
                  "qwen2vl serve: a token outside the vocab")
            short_l, long_l = (prefill_logits(enc, ids, pos, ids.shape[1] + n)
                               for n in (1, NEW_TOKENS))
            spare = (short_l.float() - long_l.float()).abs().max().item()
            print(f"[qwen2vl serve]   {kind} request {i}: prefill logits over {ids.shape[1] + 1} "
                  f"and {ids.shape[1] + NEW_TOKENS} cache slots: max difference {spare:.3e} (must "
                  f"be 0); first tokens {int(first[0, 0])} / {int(out[0, 0])}", flush=True)
            check(torch.equal(short_l, long_l) and int(out[0, 0]) == int(first[0, 0]),
                  f"qwen2vl serve: the prefill depends on the cache's spare slots ({spare})")
            del short_l, long_l
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    jpegs = kinds["image"](0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        seconds, _, _, (enc, ids, _) = request("image", jpegs, 0, NEW_TOKENS)
    got = launches()
    totals.update(got)
    check(got == walk(ids.shape[1], NEW_TOKENS, enc["pixel_patches"].shape[1]),
          f"qwen2vl serve: profiled request launches {got}")
    device_ms = kernel_breakdown("qwen2vl serve", "profiled image request", prof, 12)
    by_category = collections.Counter()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            by_category[kernel_category(e.key)] += e.self_device_time_total / 1e3
    busy = device_ms / 1e3 / seconds

    def med(kind, key):
        return sorted(r[key] for r in stats[kind])[len(stats[kind]) // 2]

    medians = {kind: {key: med(kind, key) for key in ("seconds", "processor", "vision",
                                                      "prefill", "decode", "ttft",
                                                      "tokens_per_s")} for kind in stats}
    print(f"[qwen2vl serve] profiled image request: {seconds:.3f} s, {device_ms:.2f} ms of "
          f"device time (busy {100 * busy:.1f}%), by category "
          f"{ {k: round(v, 3) for k, v in by_category.most_common()} }; peak memory "
          f"{peak:.2f} GiB; medians of {QWEN2VL_REQUESTS} a kind: "
          f"{ {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in medians.items()} }; "
          f"launches over the phase {dict(totals)} ({card})", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(totals), dict(build_s=t_build, io=io_stats, requests=dict(stats),
                              medians=medians, profiled_seconds=seconds, device_ms=device_ms,
                              busy=busy, by_category=dict(by_category), peak_gib=peak)


# ------------------------------------------ SD3-medium directory (43a-43e)
def sd3_adaln_grad_checks(torch, dev, gen, norms):
    """B12 and B13 under autograd at SD3's training rows (ADALN_SHAPES): the
    forward kernel gated per element (ADALN_SUM) and launched once, and the
    gradients of x, the residual and the modulation rows bit-equal to
    autograd of the plain version, which is what `with_plain_backward`
    recomputes (JAX's custom_vjp recomputes through XLA alike); the control,
    the plain version without the shift, must fail the gate."""
    bf16 = torch.bfloat16
    for shape in ADALN_SHAPES:
        b_, s_, h_ = shape
        x, res = (torch.randn(shape, generator=gen, device=dev).to(bf16).requires_grad_()
                  for _ in range(2))
        mod = torch.randn((b_, 3, h_), generator=gen, device=dev).to(bf16).requires_grad_()
        g = torch.randn(shape, generator=gen, device=dev).to(bf16)
        for name, fn, ref_fn, args in (
                ("adaptive_layer_norm", norms.adaptive_layer_norm, norms.adaptive_layer_norm_ref,
                 lambda shift: (x, mod[:, 0], shift)),
                ("fused_adaln_scale_residual", norms.fused_adaln_scale_residual,
                 norms.fused_adaln_scale_residual_ref,
                 lambda shift: (res, x, mod[:, 2], mod[:, 0], shift))):
            before = fn.launches
            out = fn(*args(mod[:, 1]))
            torch.cuda.synchronize()
            launched = fn.launches - before
            ref = ref_fn(*args(mod[:, 1]))
            out_y, ref_y = (o[0] if isinstance(o, tuple) else o for o in (out, ref))
            excess, need = ulp_gate(out_y, ref_y, ADALN_SUM)
            control = ulp_gate(ref_fn(*args(0 * mod[:, 1]))[0] if isinstance(ref, tuple)
                               else ref_fn(*args(0 * mod[:, 1])), ref_y, ADALN_SUM)[0]
            wrt = (x, mod) if name == "adaptive_layer_norm" else (res, x, mod)
            got = torch.autograd.grad(out_y, wrt, g)
            want = torch.autograd.grad(ref_y, wrt, g)
            differ = [i for i, (a_, b_) in enumerate(zip(got, want)) if not torch.equal(a_, b_)]
            print(f"[sd3 train kernels] {name} {shape} under autograd: forward excess "
                  f"{excess:.3e} (least c {need:.2e}, c {ADALN_SUM:g}), {launched} launch; "
                  f"control without the shift {control:.3e} (must be > 0); gradients of "
                  f"{len(wrt)} inputs against autograd of the plain version: "
                  f"{len(differ)} differ (max |grad| {max(t.abs().max().item() for t in got):.3e})",
                  flush=True)
            check(excess <= 0 and control > 0 and launched == 1 and not differ
                  and all(bool(torch.isfinite(t).all()) for t in got),
                  f"sd3 train kernels: {name} {shape}: excess {excess}, control {control}, "
                  f"{launched} launches, gradients differing {differ}")
        del x, res, mod, g, out, ref, got, want


def sd3_dir_slice(torch, F, np, dev, gen, m, counters, record, card):
    """Phases 43a-43e (see the module docstring): SD3-medium's directory in
    the published layout, written, read back and served through
    tools.text_to_image.main, then fine-tuned by the flow-match loss through
    the Trainer. Everything is written under one temporary directory, removed
    in a `finally`. `counters` are every kernel wrapper's, by name. Returns
    ({phase: launches}, the numbers)."""
    import io
    import shutil
    import tempfile

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers import (
        DiffusionPipeline,
        FlowMatchEulerDiscreteScheduler,
        SD3Transformer2DModel,
    )
    from paddlemix_tpu_torch.diffusers import training_utils
    from paddlemix_tpu_torch.diffusers.models import transformer_sd3 as sd3_mod
    from paddlemix_tpu_torch.diffusers.models.resnet import n_group_norms
    from paddlemix_tpu_torch.diffusers.sd3 import (
        expected_launches_sd3,
        expected_launches_sd3_train,
        image_latents,
        random_sd3_pipeline,
        save_published_sd3,
        sd3_trainer,
        seeded_t5_tokenizer,
    )
    from paddlemix_tpu_torch.models.layers import n_layer_norms, set_compute_dtype
    from paddlemix_tpu_torch.models.t5 import T5LayerNorm
    from paddlemix_tpu_torch.tools import text_to_image
    from paddlemix_tpu_torch.trainer.train_state import train_state_dict

    bf16 = torch.bfloat16
    attn, norms = m.attn, m.norms
    models = ("transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3")
    phases, stats = {}, {}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def walk(*parts):
        total = collections.Counter()
        for part in parts:
            total.update({k: v for k, v in part.items() if k in counters})
        return {name: total.get(name, 0) for name in counters}

    tmp = tempfile.mkdtemp(prefix="pmix_smoke_sd3_dir_")
    try:
        # ------------------------------------------------- 43a the directory
        t0 = time.perf_counter()
        pipe = random_sd3_pipeline(dev, bf16, seed=0, tokenizer=specials_tokenizer(),
                                   tokenizer_3=seeded_t5_tokenizer(SD3_T5_SEED))
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        nbytes_ = {n: sum(t.numel() * t.element_size() for t in getattr(pipe, n).state_dict()
                          .values()) for n in models}
        total = sum(nbytes_.values())
        need = total + 2 ** 30  # and diffusers' stored position table
        free = shutil.disk_usage(tmp).free
        print(f"[sd3 dir] SD3-medium built in bf16 in {t_build:.1f} s "
              f"({', '.join(f'{n} {b_ / 1e9:.3f} GB' for n, b_ in nbytes_.items())}); {tmp}: "
              f"{free / 1e9:.1f} GB free, this phase needs {need / 1e9:.1f} GB", flush=True)
        check(free >= need, f"sd3 dir: {free / 1e9:.1f} GB free under {tmp}, "
              f"{need / 1e9:.1f} GB needed (set TMPDIR to a larger disk)")
        path = os.path.join(tmp, "sd3-medium")
        t0 = time.perf_counter()
        files = save_published_sd3(pipe, path)
        t_write = time.perf_counter() - t0
        written = sum(files.values())
        tok3 = seeded_t5_tokenizer(SD3_T5_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = DiffusionPipeline.from_pretrained(path, dtype=bf16, device=dev, tokenizer_3=tok3)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        unequal = []
        for name in models:
            mine, theirs = getattr(pipe, name).state_dict(), getattr(back, name).state_dict()
            unequal += [f"{name}: keys differ"] if mine.keys() != theirs.keys() else [
                f"{name}.{k}" for k, v in mine.items()
                if not (v.dtype == theirs[k].dtype and torch.equal(v, theirs[k]))]
        fp32_norms = all(mod_.weight.dtype == torch.float32 for mod_ in back.text_encoder_3.modules()
                         if isinstance(mod_, T5LayerNorm))
        print(f"[sd3 dir] save_published_sd3: {written / 1e9:.3f} GB in {len(files)} weight files "
              f"({sorted(files)}) in {t_write:.2f} s ({written / 1e9 / t_write:.2f} GB/s); "
              f"DiffusionPipeline.from_pretrained (tokenizer_3 the seeded stand-in) back to the "
              f"card in bf16 in {t_read:.2f} s ({total / 1e9 / t_read:.2f} GB/s): "
              f"{type(back).__name__} with {type(back.scheduler).__name__} (shift "
              f"{back.scheduler.config.shift}), T5 norms fp32 {fp32_norms}; tensors not "
              f"bit-equal to the pipeline that wrote it: {len(unequal)} {unequal[:3]} "
              f"(warm page cache; {card})", flush=True)
        check(type(back).__name__ == "StableDiffusion3Pipeline" and not unequal and fp32_norms,
              f"sd3 dir: {len(unequal)} tensors differ {unequal[:3]}")
        stats["io"] = dict(gb=total / 1e9, write_s=t_write, read_s=t_read, build_s=t_build)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------------------------------------- 43b serving
        want = walk(expected_launches_sd3(back, HEIGHT, WIDTH, text_to_image.STEPS,
                                          SD3_GUIDANCE))
        png = os.path.join(tmp, "out.png")
        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        text_to_image.main([path, SD3_REQUESTS[0][0], png], device=dev,
                           components={"tokenizer_3": tok3}, height=HEIGHT, width=WIDTH)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        got = launches()
        with Image.open(png) as im:
            image = np.asarray(im.convert("RGB"), np.float32) / 255.0
        print(f"[sd3 serve] text_to_image.main on the directory (read in bf16, 25 FlowMatch "
              f"steps, {HEIGHT} px, guidance {SD3_GUIDANCE}): {t_main:.3f} s with the read; PNG "
              f"{image.shape} finite {bool(np.isfinite(image).all())} range [{image.min():.3f}, "
              f"{image.max():.3f}] std {image.std():.3f}; launches {got} (walk {want})",
              flush=True)
        check(image.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(image).all())
              and image.std() > 0.01, f"sd3 serve: image {image.shape} std {image.std()}")
        check(got == want, f"sd3 serve: launches {got} != the walk {want}")
        phases["sd3_dir"] = got
        seconds = []
        for profiled in (False, True):
            with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                    contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                back(SD3_REQUESTS[1][0], height=HEIGHT, width=WIDTH,
                     num_inference_steps=text_to_image.STEPS, seed=SD3_REQUESTS[1][1],
                     output_type="np")
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        device_ms = kernel_breakdown("sd3 serve", "profiled request", prof, 8)
        print(f"[sd3 serve] a 25-step request on the pipeline read by from_pretrained: "
              f"{seconds[0]:.3f} s; profiled {seconds[1]:.3f} s with {device_ms:.1f} ms of device "
              f"time: busy {100 * device_ms / 1e3 / seconds[1]:.1f}%; peak memory {peak:.2f} GiB "
              f"({card})", flush=True)
        stats["serve"] = dict(main_s=t_main, request_s=seconds[0], device_ms=device_ms,
                              busy=device_ms / 1e3 / seconds[1], peak_gib=peak)

        # ------------------------------------------- the training batch's inputs
        zero()
        t0 = time.perf_counter()
        latents = []
        for i in range(SD3_TRAIN_IMAGES):
            with Image.open(io.BytesIO(smooth_jpeg(np, Image, 500 + i, (HEIGHT, WIDTH)))) as im:
                px = np.asarray(im.convert("RGB"), np.float32) / 127.5 - 1.0
            latents.append(image_latents(back.vae, torch.from_numpy(px)[None].to(dev))[0])
        with torch.inference_mode():
            cond, _, pooled, _ = back.encode_prompt(list(SD3_TRAIN_PROMPTS))
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        got = launches()
        te_ln = sum(n_layer_norms(e) for e in (back.text_encoder, back.text_encoder_2))
        t5_rms = sum(isinstance(mod_, T5LayerNorm) for mod_ in back.text_encoder_3.modules())
        enc_gn = n_group_norms(back.vae.encoder)
        want = walk({"group_norm": enc_gn * SD3_TRAIN_IMAGES, "layer_norm": 2 * te_ln,
                     "rms_norm": 2 * t5_rms,
                     "flash_attention": back.vae.encode_flash_launches(HEIGHT, WIDTH)
                     * SD3_TRAIN_IMAGES})
        samples = [{"latents": lat.float().cpu().numpy(),
                    "encoder_hidden_states": c.float().cpu().numpy(),
                    "pooled_projections": p.float().cpu().numpy()}
                   for lat, c, p in zip(latents, cond, pooled)]
        lat_std = float(torch.stack(latents).float().std())
        print(f"[sd3 train] {SD3_TRAIN_IMAGES} seeded {HEIGHT} px jpegs through SD3's VAE encoder "
              f"((mode - {back.vae.config.shift_factor}) * {back.vae.config.scaling_factor}: "
              f"latents {tuple(latents[0].shape)}, std {lat_std:.3f}) and {len(SD3_TRAIN_PROMPTS)} "
              f"prompts through encode_prompt (context {tuple(cond.shape)}, pooled "
              f"{tuple(pooled.shape)}) in {t_enc:.2f} s; launches {got} (walk {want})",
              flush=True)
        check(got == want and all(bool(np.isfinite(s_[k]).all()) for s_ in samples for k in s_),
              f"sd3 train: the encodes' launches {got} != {want}, or a sample not finite")
        phases["sd3_encode"] = got
        del back, latents, cond, pooled
        gc.collect()
        torch.cuda.empty_cache()

        # -------------------------------------------------- 43c train kernels
        sd15_train_kernels(torch, F, dev, gen, record, attn, cases=SD3_TRAIN_FLASH_CASES,
                           tag="sd3 train kernels")
        sd3_adaln_grad_checks(torch, dev, gen, norms)
        gc.collect()
        torch.cuda.empty_cache()

        # --------------------------------------------------- 43d train agree
        t0 = time.perf_counter()
        tr = SD3Transformer2DModel.from_pretrained(path, subfolder="transformer", device=dev,
                                                   dtype=torch.float32)
        set_compute_dtype(tr, bf16)
        tr.config.gradient_checkpointing = True
        torch.cuda.synchronize()
        params = [p for p in tr.parameters() if p.requires_grad]
        names = [n for n, p in tr.named_parameters() if p.requires_grad]
        print(f"[sd3 train] the transformer read from the directory in fp32 masters in "
              f"{time.perf_counter() - t0:.2f} s: {sum(p.numel() for p in params)} parameters in "
              f"{len(params)} tensors, bf16 compute, gradient checkpointing per block", flush=True)
        b = SD3_TRAIN_BATCH
        batch = {k: torch.from_numpy(np.stack([s_[k] for s_ in samples[:b]])).to(dev)
                 for k in samples[0]}
        u = torch.tensor(SD3_AGREE_U, device=dev)
        noise = torch.randn(batch["latents"].shape, generator=gen, device=dev)
        plain_all, rounded_all = train_plain_swaps(torch, m)
        adaln = [(sd3_mod, "adaptive_layer_norm", norms.adaptive_layer_norm_ref),
                 (sd3_mod, "fused_adaln_scale_residual", norms.fused_adaln_scale_residual_ref)]
        plain, rounded = plain_all[:3] + adaln, rounded_all[:3] + adaln
        no_di = [(attn, "flash_bwd_dkv", lambda qs, k, v, do, lse, di, **kw:
                  attn.flash_bwd_dkv_ref(qs, k, v, do, lse, torch.zeros_like(di), **kw))] + \
            [plain[0], plain[2]] + adaln

        def loss_and_grads(swaps=()):
            with swapped(swaps):
                loss = training_utils.flow_match_loss(tr, batch, u, noise, shift=3.0)
                grads = torch.autograd.grad(loss, params)
            return loss.detach().float(), grads

        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_k, grads_k = loss_and_grads()
        torch.cuda.synchronize()
        t_kernels = time.perf_counter() - t0
        peak_agree = torch.cuda.max_memory_allocated() / 2 ** 30
        got = launches()
        want = walk(expected_launches_sd3_train(tr, b, latent_side(samples), cond_len(samples),
                                                1))
        t0 = time.perf_counter()
        loss_p, grads_p = loss_and_grads(plain)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        gaps = {"kernels": [rel_l2(a.float(), b_.float()) for a, b_ in zip(grads_k, grads_p)]}
        del grads_k
        losses = {"kernels": loss_k}
        for key, swaps in (("pair", rounded), ("control", no_di)):
            losses[key], grads = loss_and_grads(swaps)
            gaps[key] = [rel_l2(a.float(), b_.float()) for a, b_ in zip(grads, grads_p)]
            del grads
        del grads_p
        signal = [i for i, gap_ in enumerate(gaps["pair"]) if gap_ <= CLIP_SIGNAL_GAP]

        def median_max(key):
            return sorted(gaps[key])[len(names) // 2], max(gaps[key][i] for i in signal)

        (k_med, k_max), (r_med, r_max), (c_med, c_max) = map(median_max,
                                                             ("kernels", "pair", "control"))
        rel_loss = {key: abs(v - loss_p).item() / abs(loss_p).item() for key, v in losses.items()}
        worst = max(signal, key=lambda i: gaps["kernels"][i])
        print(f"[sd3 train agree] full-width SD3 transformer, checkpointing on, one micro-batch "
              f"of {b} at {latent_side(samples)}^2 latents + {cond_len(samples)} context tokens, u "
              f"{SD3_AGREE_U}, fixed noise; kernels vs plain: loss {loss_k.item():.6f} vs "
              f"{loss_p.item():.6f} (relative {rel_loss['kernels']:.3e}; the plain versions one "
              f"rounding apart {rel_loss['pair']:.3e}, ratio tol {CLIP_LOSS_RATIO}); relative L2 "
              f"of the gradients, median of all {len(names)} / max of the {len(signal)} with "
              f"signal: kernels {k_med:.3e} / {k_max:.3e}, the pair {r_med:.3e} / {r_max:.3e} "
              f"(ratio tol {TRAIN_AGREE_RATIO}); control, B14's dK/dV without di: {c_med:.3e} / "
              f"{c_max:.3e} (must fail); the kernels' largest gap {names[worst]} "
              f"{gaps['kernels'][worst]:.3e}; a step's loss and gradients {t_kernels:.2f} s with "
              f"the kernels, {t_plain:.2f} s plain; peak memory {peak_agree:.2f} GiB; launches "
              f"{got} (walk {want})", flush=True)
        check(bool(torch.isfinite(loss_k)) and rel_loss["kernels"] <= CLIP_LOSS_RATIO *
              rel_loss["pair"] and k_med <= TRAIN_AGREE_RATIO * r_med
              and k_max <= TRAIN_AGREE_RATIO * r_max,
              f"sd3 train agree: loss {rel_loss}, grads {k_med} / {k_max} against {r_med} / "
              f"{r_max}")
        check(c_med > TRAIN_AGREE_RATIO * r_med or c_max > TRAIN_AGREE_RATIO * r_max,
              f"sd3 train agree: the control passes ({c_med} / {c_max})")
        check(got == want, f"sd3 train agree: launches {got} != {want}")
        stats["agree"] = dict(loss_rel=rel_loss, grads=dict(kernels=(k_med, k_max),
                                                            pair=(r_med, r_max)),
                              peak_gib=peak_agree)
        del batch, noise
        gc.collect()
        torch.cuda.empty_cache()

        # -------------------------------------------------------- 43e train
        sched = FlowMatchEulerDiscreteScheduler.from_pretrained(path, subfolder="scheduler")
        trainer = sd3_trainer(tr, sched, samples, batch_size=SD3_TRAIN_BATCH)
        a = trainer.args
        a.logging_steps = 1
        before = [p.detach().clone() for p in params]
        profiled = SD3_TRAIN_STEPS
        zero()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA], schedule=torch.profiler.schedule(
                wait=profiled - 2, warmup=1, active=1, repeat=1)) as prof:
            trainer.callbacks.append(lambda step, metrics: prof.step())
            trainer.train(SD3_TRAIN_STEPS)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = launches()
        want = walk(expected_launches_sd3_train(tr, SD3_TRAIN_BATCH, latent_side(samples),
                                                cond_len(samples), SD3_TRAIN_STEPS))
        by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                            for e in prof.key_averages() if e.self_device_time_total > 0),
                           reverse=True)
        device_ms = sum(ms_ for ms_, _, _ in by_kernel)
        hist = trainer.history
        ends = [t_start] + [h["time"] for h in hist]
        step_s = [b_ - a_ for a_, b_ in zip(ends, ends[1:])]
        t_prof = step_s[profiled - 1]
        middle = [i for i in range(1, len(hist)) if i not in (profiled - 2, profiled - 1)]
        s_step = sorted(step_s[i] for i in middle)[len(middle) // 2]
        losses_ = torch.stack([h["loss"] for h in hist]).float()
        gnorms = torch.stack([h["grad_norm"] for h in hist]).float()
        moved = sum(not torch.equal(b_, p.detach()) for b_, p in zip(before, params))
        del before
        state_gb = sum(t.numel() * t.element_size() for t in
                       train_state_dict(trainer.state, trainer.tx).values()) / 1e9
        print(f"[sd3 train] {len(hist)} optimizer steps of {SD3_TRAIN_BATCH} (AdamW, lr "
              f"{a.learning_rate}, {a.lr_scheduler_type}, clip {a.max_grad_norm}): seconds a step "
              f"{[round(x, 4) for x in step_s]} (step {profiled} under the profiler, step "
              f"{profiled - 1} starting it); median of steps 2-{profiled - 2} {s_step:.4f} s; "
              f"profiled step {t_prof:.4f} s with {device_ms:.1f} ms of device time: busy "
              f"{100 * device_ms / 1e3 / t_prof:.1f}%; peak memory {peak:.2f} GiB; masters and "
              f"AdamW state {state_gb:.3f} GB ({card})", flush=True)
        for ms_, n_, key in by_kernel[:12]:
            print(f"[sd3 train]   profiled step: {ms_:8.2f} ms {100 * ms_ / device_ms:5.1f}% "
                  f"{n_:5d}x {key[:100]}", flush=True)
        b14_ms = bwd_share("[sd3 train]", by_kernel, device_ms)
        print(f"[sd3 train] losses {[round(x, 4) for x in losses_.tolist()]}; grad_norm "
              f"{[round(x, 4) for x in gnorms.tolist()]}; {moved} of {len(params)} parameter "
              f"tensors moved; launches {got} (walk {want})", flush=True)
        check(len(hist) == SD3_TRAIN_STEPS and bool(torch.isfinite(losses_).all()
                                                     and torch.isfinite(gnorms).all()),
              "sd3 train: a loss or grad_norm is not finite")
        check(moved == len(params), f"sd3 train: {len(params) - moved} parameter tensors did "
              f"not move")
        check(got == want, f"sd3 train: launches {got} != the walk {want}")
        phases["sd3_train"] = got
        stats["train"] = dict(step_s=s_step, busy=device_ms / 1e3 / t_prof, peak_gib=peak,
                              b14_ms=b14_ms, device_ms=device_ms, state_gb=state_gb,
                              losses=losses_.tolist())
        del trainer, tr, params, samples
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return phases, stats



# --------------------------------------- ControlNet and T2I-Adapter (44a-44f)
def edge_map(np, Image, seed, size=SD15_SIZE):
    """A size x size canny-like edge map (uint8, 0 / 255, 3 channels) that
    numpy makes from a smooth jpeg: the gradient magnitude of its luma
    (central differences), over its 90th percentile."""
    import io

    with Image.open(io.BytesIO(smooth_jpeg(np, Image, seed, size=(size, size)))) as im:
        y = np.asarray(im.convert("L"), np.float32)
    gy, gx = np.gradient(y)
    mag = np.hypot(gx, gy)
    return np.repeat(((mag > np.percentile(mag, 90)) * 255).astype(np.uint8)[..., None], 3, -1)


def conditioner_of(pipe):
    return pipe.controlnet if hasattr(pipe, "controlnet") else pipe.adapter


def inference_plain(attn):
    """B1's inference form swapped for its plain version, the calls under
    autograd left to `_FlashAttention` (whose B15 / B14 the training swaps
    replace): the frozen UNet's down blocks run B1 inside a training step."""
    from paddlemix_tpu_torch.ops.autograd import grad_needed

    real = attn.flash_attention

    def run(q, k, v, **kw):
        if grad_needed(q, k, v):
            return real(q, k, v, **kw)
        return attn.flash_attention_ref(q, k, v, scale=kw.get("scale"))
    return (attn, "flash_attention", run)


def grad_agree(torch, m, label, loss_and_grads, names, card, extra=None):
    """The training agree of the SD1.5 and DiT paths (CLIP's rule):
    `loss_and_grads(swaps)` with the kernels, with their plain versions (B15,
    B14 and `extra`: by default B4 and B1's inference form), with the plain
    versions one rounding apart (P rounded to bf16 before P.V) and with the
    control (B14's dK/dV without di); the loss within CLIP_LOSS_RATIO and the
    gradients' median over all parameters and largest gap over those above
    the rounding noise within TRAIN_AGREE_RATIO of the pair's; the control
    must fail. Returns the numbers."""
    attn = m.attn
    plain_all, rounded_all = train_plain_swaps(torch, m)
    if extra is None:
        extra = [(m.resnet, "group_norm", m.norms.group_norm_ref), inference_plain(attn)]
    plain, rounded = plain_all[:3] + extra, rounded_all[:3] + extra
    no_di = [(attn, "flash_bwd_dkv", lambda qs, k, v, do, lse, di, **kw: attn.flash_bwd_dkv_ref(
        qs, k, v, do, lse, torch.zeros_like(di), **kw))] + [plain[0], plain[2]] + extra
    loss_k, grads_k = loss_and_grads(())
    loss_p, grads_p = loss_and_grads(plain)
    gaps = {"kernels": [rel_l2(a.float(), b_.float()) for a, b_ in zip(grads_k, grads_p)]}
    del grads_k
    losses = {"kernels": loss_k}
    for key, swaps in (("pair", rounded), ("control", no_di)):
        losses[key], grads = loss_and_grads(swaps)
        gaps[key] = [rel_l2(a.float(), b_.float()) for a, b_ in zip(grads, grads_p)]
        del grads
    del grads_p
    signal = [i for i, gap_ in enumerate(gaps["pair"]) if gap_ <= CLIP_SIGNAL_GAP]

    def median_max(key):
        return sorted(gaps[key])[len(names) // 2], max(gaps[key][i] for i in signal)

    (k_med, k_max), (r_med, r_max), (c_med, c_max) = map(median_max, ("kernels", "pair", "control"))
    rel_loss = {key: abs(v - loss_p).item() / abs(loss_p).item() for key, v in losses.items()}
    worst = max(signal, key=lambda i: gaps["kernels"][i])
    print(f"[{label}] kernels vs plain: loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
          f"(relative {rel_loss['kernels']:.3e}; the plain versions one rounding apart "
          f"{rel_loss['pair']:.3e}, ratio tol {CLIP_LOSS_RATIO}); relative L2 of the gradients, "
          f"median of all {len(names)} / max of the {len(signal)} with signal: kernels "
          f"{k_med:.3e} / {k_max:.3e}, the pair {r_med:.3e} / {r_max:.3e} (ratio tol "
          f"{TRAIN_AGREE_RATIO}); control, B14's dK/dV without di: {c_med:.3e} / {c_max:.3e} "
          f"(must fail); the kernels' largest gap {names[worst]} {gaps['kernels'][worst]:.3e} "
          f"({card})", flush=True)
    check(bool(torch.isfinite(loss_k)) and rel_loss["kernels"] <= CLIP_LOSS_RATIO * rel_loss["pair"]
          and k_med <= TRAIN_AGREE_RATIO * r_med and k_max <= TRAIN_AGREE_RATIO * r_max,
          f"{label}: loss {rel_loss}, grads {k_med} / {k_max} against {r_med} / {r_max}")
    check(c_med > TRAIN_AGREE_RATIO * r_med or c_max > TRAIN_AGREE_RATIO * r_max,
          f"{label}: the control passes ({c_med} / {c_max})")
    return dict(loss_rel=rel_loss, grads=dict(kernels=(k_med, k_max), pair=(r_med, r_max),
                                              control=(c_med, c_max)))


def control_slice(torch, F, np, dev, gen, m, counters, record, card):
    """Phases 44a-44f (see the module docstring): SD1.5 under a ControlNet
    and under a T2I-Adapter, written into pipeline directories and read back,
    served, held against the plain versions, both trainers run, and the SD1.5
    UNet trainer with gradient checkpointing on and off. Everything is
    written under one temporary directory, removed in a `finally`.
    `counters` are every kernel wrapper's, by name. Returns ({phase:
    launches}, {phase: {wrapper: launches by head_dim}}, the numbers)."""
    import shutil
    import tempfile

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers import (
        ControlNetModel,
        DDIMScheduler,
        DDPMScheduler,
        DiffusionPipeline,
        StableDiffusionAdapterPipeline,
        StableDiffusionControlNetPipeline,
        UniPCMultistepScheduler,
        training_utils,
    )
    from paddlemix_tpu_torch.diffusers.models.resnet import n_group_norms
    from paddlemix_tpu_torch.diffusers.sd15 import (
        SD15_SCHEDULER,
        expected_launches_sd15,
        keyed,
        random_sd15_pipeline,
        random_sd15_unet,
        train_walk,
    )
    from paddlemix_tpu_torch.diffusers.sd15_control import (
        expected_launches_adapter_train,
        expected_launches_controlnet,
        expected_launches_controlnet_train,
        random_controlnet,
        random_t2i_adapter,
    )
    from paddlemix_tpu_torch.models.layers import set_compute_dtype
    from paddlemix_tpu_torch.tools import train_controlnet as tcn
    from paddlemix_tpu_torch.tools import train_t2i_adapter as tta
    from paddlemix_tpu_torch.tools import train_text_to_image as t2i

    bf16 = torch.bfloat16
    attn = m.attn
    by_dim_fns = [attn.flash_attention, attn.flash_fwd_lse, attn.flash_bwd_dkv,
                  attn.flash_bwd_dq]
    phases, dims, stats = {}, {}, {}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        for fn in by_dim_fns:
            fn.launches_by_dim.clear()

    def launches():
        return ({name: fn.launches for name, fn in counters.items()},
                {fn.__name__: dict(fn.launches_by_dim) for fn in by_dim_fns})

    def walk(want):
        return {name: want.get(name, 0) for name in counters}

    def train_dims(want):
        return {fn.__name__: want["by_dim"].get(fn.__name__, {}) for fn in by_dim_fns}


    def device_ms(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3

    edges = {seed: edge_map(np, Image, seed) for _, seed in CONTROL_REQUESTS}
    tmp = tempfile.mkdtemp(prefix="pmix_smoke_control_")
    try:
        # ----------------------------------------------- 44a the directories
        t0 = time.perf_counter()
        base = random_sd15_pipeline(dev, torch.float32, seed=0, tokenizer=specials_tokenizer())
        shared = {n: getattr(base, n) for n in ("vae", "text_encoder", "tokenizer", "unet")}
        pipes = {"controlnet": StableDiffusionControlNetPipeline(
            **shared, controlnet=random_controlnet(dev, torch.float32, seed=1),
            scheduler=UniPCMultistepScheduler.from_config(SD15_SCHEDULER)),
            "adapter": StableDiffusionAdapterPipeline(
                **shared, adapter=random_t2i_adapter(dev, torch.float32, seed=2),
                scheduler=DDIMScheduler.from_config(SD15_SCHEDULER))}
        torch.cuda.synchronize()
        size = {n: sum(t.numel() * t.element_size() for t in getattr(base, n).state_dict()
                       .values()) for n in ("unet", "vae", "text_encoder")}
        size.update({n: sum(t.numel() * t.element_size() for t in conditioner_of(p).state_dict()
                            .values()) for n, p in pipes.items()})
        n_params = {n: sum(t.numel() for t in conditioner_of(p).parameters())
                    for n, p in pipes.items()}
        base_bytes = size["unet"] + size["vae"] + size["text_encoder"]
        need = 2 * base_bytes + size["controlnet"] + 2 * size["adapter"] + 2 ** 30
        free = shutil.disk_usage(tmp).free
        print(f"[control dir] SD1.5 in fp32 with a ControlNet ({n_params['controlnet']} "
              f"parameters, lllyasviel/sd-controlnet-canny's config) and a full T2I-Adapter "
              f"({n_params['adapter']}, TencentARC/t2iadapter_canny_sd15v2's widths, 3 input "
              f"channels), zero convs filled, built in {time.perf_counter() - t0:.1f} s; {tmp}: "
              f"{free / 1e9:.1f} GB free, this phase needs up to {need / 1e9:.1f} GB", flush=True)
        check(free >= need, f"control dir: {free / 1e9:.1f} GB free under {tmp}, "
              f"{need / 1e9:.1f} GB needed (set TMPDIR to a larger disk)")
        dirs, io_stats = {}, {}
        for name, pipe in pipes.items():
            path = dirs[name] = os.path.join(tmp, name)
            total = base_bytes + size[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.save_pretrained(path)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = DiffusionPipeline.from_pretrained(path, dtype=torch.float32, device=dev)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
            mine, theirs = conditioner_of(pipe).state_dict(), conditioner_of(back).state_dict()
            unequal = unequal_tensors(torch, pipe, back) + [
                f"{name}.{k}" for k, v in mine.items()
                if not (k in theirs and v.dtype == theirs[k].dtype and torch.equal(v, theirs[k]))]
            with open(os.path.join(path, "model_index.json")) as f:
                index = json.load(f)
            print(f"[control dir] {type(pipe).__name__}.save_pretrained: {total / 1e9:.3f} GB "
                  f"in {t_write:.2f} s ({total / 1e9 / t_write:.2f} GB/s), model_index "
                  f"{ {k: v for k, v in index.items() if k != '_class_name'} }; "
                  f"DiffusionPipeline.from_pretrained back to the card in fp32 {t_read:.2f} s "
                  f"({total / 1e9 / t_read:.2f} GB/s, warm page cache), {type(back).__name__} "
                  f"with {type(back.scheduler).__name__}; tensors not bit-equal: "
                  f"{len(unequal)} {unequal[:3]} ({card})", flush=True)
            check(type(back) is type(pipe) and type(back.scheduler) is type(pipe.scheduler)
                  and not unequal and len(theirs) == len(mine),
                  f"control dir: {name}: {len(unequal)} tensors differ")
            io_stats[name] = dict(gb=total / 1e9, write_s=t_write, read_s=t_read)
            del back
        stats["io"] = io_stats
        del pipes, base, shared
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------- 44b the ControlNet: agree and serve
        t0 = time.perf_counter()
        pipe = DiffusionPipeline.from_pretrained(dirs["controlnet"], dtype=bf16, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        cn, unet = pipe.controlnet, pipe.unet
        lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
        t = pipe.scheduler.set_timesteps(CONTROL_STEPS).timesteps[:1].to(dev).expand(2)
        ctx = torch.randn((2, 77, 768), generator=gen, device=dev, dtype=bf16)
        ctl = torch.from_numpy(edges[CONTROL_REQUESTS[0][1]] / 255.0).to(dev, bf16)[None]
        ctl = ctl.expand(2, *ctl.shape[1:])

        def cn_forward(swaps=(), residuals=True):
            with torch.inference_mode(), swapped(swaps):
                kw = {}
                if residuals:
                    down, mid = cn(lat.to(bf16), t, ctx, ctl)
                    kw = dict(down_block_additional_residuals=down,
                              mid_block_additional_residual=mid)
                return unet(lat.to(bf16), t, ctx, **kw).float()

        plain = plain_swaps(m, int8=False)
        zero()
        out_k = cn_forward()
        torch.cuda.synchronize()
        got, got_dim = launches()
        out_p = cn_forward(plain)
        out_c = cn_forward(plain, residuals=False)
        rel, rel_c = rel_l2(out_k, out_p), rel_l2(out_c, out_p)
        n_gn = n_group_norms(cn) + n_group_norms(unet)
        print(f"[control agree] full-width ControlNet + SD1.5 UNet at 64x64 latents, batch 2, "
              f"bf16: kernels (B1 at head_dim 40 / 80 / 160: {got_dim['flash_attention']}; B4 "
              f"{got['group_norm']}) vs plain: relative L2 {rel:.3e} (tol {AGREE_TOL}); control, "
              f"the UNet without the ControlNet's residuals: {rel_c:.3e} (must fail); |out| max "
              f"{out_p.abs().max().item():.3f} ({card})", flush=True)
        check(bool(torch.isfinite(out_k).all()) and rel <= AGREE_TOL,
              f"control agree: relative L2 {rel}")
        check(rel_c > AGREE_TOL, f"control agree: the control passes ({rel_c})")
        check(got_dim["flash_attention"] == {40: 7, 80: 7, 160: 7} and got["group_norm"] == n_gn,
              f"control agree: launches {got_dim} / {got['group_norm']} (21 B1, {n_gn} B4)")
        with torch.inference_mode():
            ms_cn = device_ms(lambda: cn(lat.to(bf16), t, ctx, ctl))
            down, mid = cn(lat.to(bf16), t, ctx, ctl)
            ms_unet = device_ms(lambda: unet(lat.to(bf16), t, ctx,
                                             down_block_additional_residuals=down,
                                             mid_block_additional_residual=mid))
        del out_k, out_p, out_c, down, mid
        want = expected_launches_controlnet(pipe, SD15_SIZE, SD15_SIZE, CONTROL_STEPS,
                                            SD15_GUIDANCE)
        want_dim = want.pop("flash_attention_by_dim")
        want = walk(want)
        want_train = expected_launches_controlnet_train(unet, cn, CONTROL_TRAIN_BATCH, 64,
                                                        CONTROL_TRAIN_STEPS)
        want_agree_train = expected_launches_controlnet_train(unet, cn, 2, 64)
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for i, (prompt, seed) in enumerate(CONTROL_REQUESTS + CONTROL_REQUESTS[-1:]):
            profiled = i == len(CONTROL_REQUESTS)
            zero()
            with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                    contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                image = pipe(prompt, image=edges[seed], height=SD15_SIZE, width=SD15_SIZE,
                             num_inference_steps=CONTROL_STEPS, guidance_scale=SD15_GUIDANCE,
                             seed=seed, output_type="np")[0]
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            got, got_dim = launches()
            print(f"[control serve] seed {seed}: {seconds[-1]:.3f} s"
                  f"{' (profiled)' if profiled else ''}"
                  f" | image {image.shape} finite {bool(np.isfinite(image).all())} range "
                  f"[{image.min():.3f}, {image.max():.3f}] std {image.std():.3f} | launches "
                  f"{got}; B1 by head_dim {got_dim['flash_attention']}", flush=True)
            check(image.shape == (1, SD15_SIZE, SD15_SIZE, 3) and bool(np.isfinite(image).all())
                  and image.min() >= 0.0 and image.max() <= 1.0 and image.std() > 0.01,
                  f"control serve: image {image.shape} [{image.min()}, {image.max()}]")
            check(got == want and got_dim["flash_attention"] == want_dim,
                  f"control serve: launches {got} / {got_dim} != the walk {want} / {want_dim}")
        phases["cn_serve"], dims["cn_serve"] = got, got_dim
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        s_req = sorted(seconds[:-1])[len(seconds[:-1]) // 2]
        cn_share = ms_cn / max(ms_cn + ms_unet, 1e-9)
        print(f"[control serve] {len(CONTROL_REQUESTS)} requests, {SD15_SIZE} px edge maps, "
              f"{CONTROL_STEPS} UniPC steps, CFG {SD15_GUIDANCE}, read in bf16 in {t_load:.2f} s: "
              f"seconds {[round(x, 3) for x in seconds]} (the last profiled), median "
              f"{s_req:.3f} s a request; profiled {dev_ms:.1f} ms of device time: busy "
              f"{100 * dev_ms / 1e3 / seconds[-1]:.1f}% ({100 * dev_ms / 1e3 / s_req:.1f}% of the "
              f"median); a step's device time at batch 2: ControlNet {ms_cn:.2f} ms, UNet "
              f"{ms_unet:.2f} ms, the ControlNet's share {100 * cn_share:.1f}%; "
              f"peak memory {peak:.2f} GiB ({card})", flush=True)
        stats["cn_serve"] = dict(request_s=s_req, seconds=seconds, device_ms=dev_ms,
                                 busy=dev_ms / 1e3 / seconds[-1], peak_gib=peak,
                                 cn_step_ms=ms_cn, unet_step_ms=ms_unet, cn_share=cn_share,
                                 rel=rel, control_rel=rel_c)
        del pipe, cn, unet, lat, ctx, ctl
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------------------- 44c the T2I-Adapter: agree and serve
        t0 = time.perf_counter()
        pipe = DiffusionPipeline.from_pretrained(dirs["adapter"], dtype=bf16, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        ad, unet = pipe.adapter, pipe.unet
        lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
        t = pipe.scheduler.set_timesteps(ADAPTER_STEPS).timesteps[:1].to(dev).expand(2)
        ctx = torch.randn((2, 77, 768), generator=gen, device=dev, dtype=bf16)
        ctl = torch.from_numpy(edges[CONTROL_REQUESTS[0][1]] / 255.0).to(dev, torch.float32)[None]

        def ad_forward(swaps=(), features=True):
            with torch.inference_mode(), swapped(swaps):
                kw = {}
                if features:
                    feats = [f.float() for f in ad(ctl)]
                    kw = dict(down_intrablock_additional_residuals=[torch.cat([f, f])
                                                                    for f in feats])
                return unet(lat.to(bf16), t, ctx, **kw).float()

        zero()
        out_k = ad_forward()
        torch.cuda.synchronize()
        got, got_dim = launches()
        out_p = ad_forward(plain)
        out_c = ad_forward(plain, features=False)
        rel, rel_c = rel_l2(out_k, out_p), rel_l2(out_c, out_p)
        print(f"[adapter agree] full-width T2I-Adapter + SD1.5 UNet at 64x64 latents, batch 2, "
              f"bf16: kernels (B1 {got_dim['flash_attention']}; B4 {got['group_norm']}) vs plain: "
              f"relative L2 {rel:.3e} (tol {AGREE_TOL}); control, the UNet without the adapter's "
              f"features: {rel_c:.3e} (must fail) ({card})", flush=True)
        check(bool(torch.isfinite(out_k).all()) and rel <= AGREE_TOL,
              f"adapter agree: relative L2 {rel}")
        check(rel_c > AGREE_TOL, f"adapter agree: the control passes ({rel_c})")
        check(got_dim["flash_attention"] == {40: 5, 80: 5, 160: 5}
              and got["group_norm"] == n_group_norms(unet),
              f"adapter agree: launches {got_dim} / {got['group_norm']}")
        del out_k, out_p, out_c
        # the adapter launches none of the kernels: SD1.5's request
        want = walk(expected_launches_sd15(pipe, SD15_SIZE, SD15_SIZE, ADAPTER_STEPS,
                                           SD15_GUIDANCE))
        want_ad_train = expected_launches_adapter_train(pipe, ADAPTER_TRAIN_BATCH, SD15_SIZE,
                                                        ADAPTER_TRAIN_STEPS)
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for i, (prompt, seed) in enumerate(CONTROL_REQUESTS + CONTROL_REQUESTS[-1:]):
            profiled = i == len(CONTROL_REQUESTS)
            zero()
            with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                    contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                image = pipe(prompt, image=edges[seed], height=SD15_SIZE, width=SD15_SIZE,
                             num_inference_steps=ADAPTER_STEPS, guidance_scale=SD15_GUIDANCE,
                             seed=seed, output_type="np")[0]
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            got, got_dim = launches()
            print(f"[adapter serve] seed {seed}: {seconds[-1]:.3f} s"
                  f"{' (profiled)' if profiled else ''} | image {image.shape} finite "
                  f"{bool(np.isfinite(image).all())} range [{image.min():.3f}, {image.max():.3f}] "
                  f"std {image.std():.3f} | launches {got}", flush=True)
            check(image.shape == (1, SD15_SIZE, SD15_SIZE, 3) and bool(np.isfinite(image).all())
                  and image.min() >= 0.0 and image.max() <= 1.0 and image.std() > 0.01,
                  f"adapter serve: image {image.shape} [{image.min()}, {image.max()}]")
            check(got == want, f"adapter serve: launches {got} != the walk {want}")
        phases["adapter_serve"], dims["adapter_serve"] = got, got_dim
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        s_req = sorted(seconds[:-1])[len(seconds[:-1]) // 2]
        print(f"[adapter serve] {len(CONTROL_REQUESTS)} requests, {SD15_SIZE} px edge maps, "
              f"{ADAPTER_STEPS} DDIM steps, CFG {SD15_GUIDANCE}, read in bf16 in {t_load:.2f} s: "
              f"seconds {[round(x, 3) for x in seconds]} (the last profiled), median "
              f"{s_req:.3f} s a request; profiled {dev_ms:.1f} ms of device time: busy "
              f"{100 * dev_ms / 1e3 / seconds[-1]:.1f}% ({100 * dev_ms / 1e3 / s_req:.1f}% of the "
              f"median); peak memory {peak:.2f} GiB ({card})", flush=True)
        stats["adapter_serve"] = dict(request_s=s_req, seconds=seconds, device_ms=dev_ms,
                                      busy=dev_ms / 1e3 / seconds[-1], peak_gib=peak, rel=rel,
                                      control_rel=rel_c)
        del pipe, ad, unet, lat, ctx, ctl
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------ 44d train kernels
        sd15_train_kernels(torch, F, dev, gen, record, attn, cases=CONTROL_TRAIN_FLASH_CASES,
                           tag="control train kernels")
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------- 44e the trainers
        unet = t2i.training_unet(dirs["controlnet"], dev)
        cn = set_compute_dtype(ControlNetModel.from_pretrained(
            dirs["controlnet"], subfolder="controlnet", device=dev), bf16)
        unet.requires_grad_(False)
        sched = DDPMScheduler.from_config(SD15_SCHEDULER)
        g2 = torch.Generator(device=dev).manual_seed(4)
        batch = {"latents": torch.randn((2, 64, 64, 4), generator=g2, device=dev),
                 "encoder_hidden_states": torch.randn((2, 77, 768), generator=g2, device=dev),
                 "conditioning": torch.rand((2, SD15_SIZE, SD15_SIZE, 3), generator=g2,
                                            device=dev)}
        tt = torch.tensor(SD15_AGREE_T, device=dev)
        noise = torch.randn((2, 64, 64, 4), generator=g2, device=dev)
        names, params = zip(*cn.named_parameters())

        def cn_loss_and_grads(swaps):
            with swapped(swaps):
                loss = tcn.controlnet_loss(unet, cn, sched, batch, tt, noise)
                return loss.detach().float(), torch.autograd.grad(loss, params)

        zero()
        cn_loss_and_grads(())
        torch.cuda.synchronize()
        got, got_dim = launches()
        print(f"[control train agree] the ControlNet trainer's loss (tools.train_controlnet."
              f"controlnet_loss) at full width: the ControlNet (fp32 masters, bf16 compute) over "
              f"the frozen UNet, one micro-batch of 2 at 64x64 latents and 512 px conditioning, t "
              f"{SD15_AGREE_T}, fixed noise; launches {got}, by head_dim {got_dim}", flush=True)
        check(got == walk(want_agree_train) and got_dim == train_dims(want_agree_train),
              f"control train agree: launches {got} / {got_dim} != {want_agree_train}")
        stats["cn_agree"] = grad_agree(torch, m, "control train agree", cn_loss_and_grads, names,
                                       card)
        del unet, cn, batch, noise, params
        gc.collect()
        torch.cuda.empty_cache()

        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, result = tcn.main([dirs["controlnet"]], device=dev,
                                   max_steps=CONTROL_TRAIN_STEPS,
                                   output_dir=os.path.join(tmp, "cn_out"), save_steps=0)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, got_dim = launches()
        losses_ = torch.stack([h["loss"] for h in trainer.history]).float()
        s_step = step_seconds(trainer)
        print(f"[control train] train_controlnet.main on the directory, {CONTROL_TRAIN_STEPS} "
              f"steps at batch {CONTROL_TRAIN_BATCH} over the example's 256 samples: {t_run:.2f} s "
              f"with the reads and the samples; {s_step:.4f} s a step (median); losses "
              f"{[round(x_, 4) for x_ in losses_.tolist()]}; peak memory {peak:.2f} GiB; the "
              f"Trainer's parameters {len(trainer.params)} (the ControlNet's); launches {got}, by "
              f"head_dim {got_dim} (walk {want_train}) ({card})", flush=True)
        check(len(trainer.history) == CONTROL_TRAIN_STEPS and bool(torch.isfinite(losses_).all()),
              f"control train: losses {losses_.tolist()}")
        check(got == walk(want_train) and got_dim == train_dims(want_train),
              f"control train: launches {got} / {got_dim} != the walk {want_train}")
        phases["cn_train"], dims["cn_train"] = got, got_dim
        t_prof, dev_ms = profiled_steps(torch, trainer)
        print(f"[control train] a profiled step: {t_prof:.4f} s with {dev_ms:.1f} ms of device "
              f"time: busy {100 * dev_ms / 1e3 / t_prof:.1f}% ({card})", flush=True)
        stats["cn_train"] = dict(step_s=s_step, run_s=t_run, peak_gib=peak, device_ms=dev_ms,
                                 busy=dev_ms / 1e3 / t_prof)
        del trainer, result
        gc.collect()
        torch.cuda.empty_cache()

        # the adapter trainer's step, agree: the directory's models as main uses them
        pipe = tta.freeze(DiffusionPipeline.from_pretrained(dirs["adapter"], device=dev), bf16)
        pipe.scheduler = DDIMScheduler.from_config(SD15_SCHEDULER)
        ad = set_compute_dtype(tta.adapter_for(pipe.unet, 0, dev), bf16)
        img, ctlr = tta.synthetic_pair(np.random.default_rng(0), ADAPTER_TRAIN_BATCH, SD15_SIZE)
        images, controls = torch.from_numpy(img).to(dev), torch.from_numpy(ctlr).to(dev)
        ids = torch.as_tensor(pipe.tokenizer(["a square"])["input_ids"], device=dev)
        with torch.no_grad():
            context = pipe.text_encoder(ids)[0]
        shape = (ADAPTER_TRAIN_BATCH, 64, 64, 4)
        z, noise = (torch.randn(shape, generator=g2, device=dev) for _ in range(2))
        tt = torch.tensor(SD15_AGREE_T, device=dev)
        names, params = zip(*ad.named_parameters())

        def ad_loss_and_grads(swaps):
            with swapped(swaps):
                loss = tta.adapter_loss(pipe, ad, images, controls, context, z, tt, noise)
                return loss.detach().float(), torch.autograd.grad(loss, params)

        zero()
        ad_loss_and_grads(())
        torch.cuda.synchronize()
        got, got_dim = launches()
        want_step = expected_launches_adapter_train(pipe, ADAPTER_TRAIN_BATCH, SD15_SIZE, 1,
                                                    prompts=0)
        print(f"[adapter train agree] the adapter trainer's step (tools.train_t2i_adapter."
              f"adapter_loss) at full width: a fresh adapter (fp32 masters, bf16 compute) over "
              f"the frozen VAE encoder and UNet, {ADAPTER_TRAIN_BATCH} synthetic pairs at "
              f"{SD15_SIZE} px, t {SD15_AGREE_T}, fixed draws; launches {got}, by head_dim "
              f"{got_dim}", flush=True)
        check(got == walk(want_step) and got_dim == train_dims(want_step),
              f"adapter train agree: launches {got} / {got_dim} != {want_step}")
        stats["adapter_agree"] = grad_agree(torch, m, "adapter train agree", ad_loss_and_grads,
                                            names, card)
        del pipe, ad, images, controls, z, noise, params
        gc.collect()
        torch.cuda.empty_cache()

        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ad, losses_, times = tta.main(["--pretrained", dirs["adapter"], "--resolution",
                                       str(SD15_SIZE), "--steps", str(ADAPTER_TRAIN_STEPS),
                                       "--batch", str(ADAPTER_TRAIN_BATCH), "--output",
                                       os.path.join(tmp, "adapter_out")], device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, got_dim = launches()
        losses_ = torch.stack(losses_).float()
        steps_s = sorted(b_ - a_ for a_, b_ in zip(times, times[1:]))
        s_step = steps_s[len(steps_s) // 2]
        back = type(ad).from_pretrained(os.path.join(tmp, "adapter_out"), device=dev)
        unequal = [k for k, v in ad.state_dict().items()
                   if not torch.equal(v, back.state_dict()[k])]
        print(f"[adapter train] train_t2i_adapter.main --pretrained DIR --resolution {SD15_SIZE}: "
              f"{ADAPTER_TRAIN_STEPS} steps at batch {ADAPTER_TRAIN_BATCH}, {t_run:.2f} s with the "
              f"read and the save; {s_step:.4f} s a step (median of the later steps); losses "
              f"{[round(x_, 4) for x_ in losses_.tolist()]}; peak memory {peak:.2f} GiB; the saved "
              f"adapter read back: {len(unequal)} tensors differ; launches {got}, by head_dim "
              f"{got_dim} (walk {want_ad_train}) ({card})", flush=True)
        check(len(losses_) == ADAPTER_TRAIN_STEPS and bool(torch.isfinite(losses_).all())
              and not unequal, f"adapter train: losses {losses_.tolist()}, {len(unequal)} differ")
        check(got == walk(want_ad_train) and got_dim == train_dims(want_ad_train),
              f"adapter train: launches {got} / {got_dim} != the walk {want_ad_train}")
        phases["adapter_train"], dims["adapter_train"] = got, got_dim
        stats["adapter_train"] = dict(step_s=s_step, run_s=t_run, peak_gib=peak)
        del ad, back
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------ 44f gradient checkpointing on / off
        unet = random_sd15_unet(dev, seed=0)
        sched = DDPMScheduler.from_config(SD15_SCHEDULER)
        b = SD15_TRAIN_BATCH
        batch = {"latents": torch.randn((b, 64, 64, 4), generator=g2, device=dev),
                 "encoder_hidden_states": torch.randn((b, 77, 768), generator=g2, device=dev)}
        tt = torch.randint(0, 1000, (b,), generator=g2, device=dev)
        noise = torch.randn((b, 64, 64, 4), generator=g2, device=dev)
        names, params = zip(*unet.named_parameters())

        def sd_loss_and_grads(swaps=()):
            with swapped(swaps):
                loss = training_utils.sd_loss(unet, sched, batch, tt, noise, snr_gamma=5.0)
                return loss.detach().float(), torch.autograd.grad(loss, params)

        sd_loss_and_grads()  # a warm-up pass: cuDNN's algorithm choice, the allocator's pool
        runs = {}
        for recompute in (False, True):
            unet.config.gradient_checkpointing = recompute
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            zero()
            t0 = time.perf_counter()
            loss, grads = sd_loss_and_grads()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
            got, got_dim = launches()
            want_ = keyed(train_walk(unet, b, 64))
            check(got == walk(want_) and got_dim == train_dims(want_),
                  f"sd15 checkpointing {recompute}: launches {got} / {got_dim} != {want_}")
            runs[recompute] = dict(loss=loss, grads=grads, peak=peak, s=secs, launches=got)
        unet.config.gradient_checkpointing = False
        plain_all, rounded_all = train_plain_swaps(torch, m)
        gn = (m.resnet, "group_norm", m.norms.group_norm_ref)
        _, grads_p = sd_loss_and_grads(plain_all[:3] + [gn])
        _, grads_r = sd_loss_and_grads(rounded_all[:3] + [gn])
        pair = [rel_l2(a.float(), b_.float()) for a, b_ in zip(grads_r, grads_p)]
        del grads_p, grads_r
        on_off = [rel_l2(a.float(), b_.float()) for a, b_ in zip(runs[True]["grads"],
                                                                  runs[False]["grads"])]
        signal = [i for i, gap_ in enumerate(pair) if gap_ <= CLIP_SIGNAL_GAP]
        med = lambda gaps: sorted(gaps)[len(gaps) // 2]  # noqa: E731
        bit_equal = sum(torch.equal(a, b_) for a, b_ in zip(runs[True]["grads"],
                                                            runs[False]["grads"]))
        print(f"[sd15 checkpointing] the SD1.5 UNet trainer's micro-batch of {b} (fp32 masters, "
              f"bf16 compute, fixed t and noise), gradient_checkpointing off / on: loss "
              f"{runs[False]['loss'].item():.6f} / {runs[True]['loss'].item():.6f} (bit-equal "
              f"{bool(torch.equal(runs[False]['loss'], runs[True]['loss']))}); gradients on vs off "
              f"median / max over signal {med(on_off):.3e} / {max(on_off[i] for i in signal):.3e} "
              f"({bit_equal} of {len(names)} tensors bit-equal; the plain pair one rounding apart "
              f"{med(pair):.3e} / {max(pair[i] for i in signal):.3e}, ratio tol "
              f"{TRAIN_AGREE_RATIO}); peak memory above the model {runs[False]['peak']:.2f} / "
              f"{runs[True]['peak']:.2f} GiB; seconds {runs[False]['s']:.3f} / "
              f"{runs[True]['s']:.3f}; launches off {runs[False]['launches']}, on "
              f"{runs[True]['launches']} ({card})", flush=True)
        check(torch.equal(runs[False]["loss"], runs[True]["loss"]),
              "sd15 checkpointing: the first loss differs")
        on_off_max, pair_max = (max(g[i] for i in signal) for g in (on_off, pair))
        check(med(on_off) <= TRAIN_AGREE_RATIO * med(pair)
              and on_off_max <= TRAIN_AGREE_RATIO * pair_max,
              "sd15 checkpointing: the gradients on and off part beyond the gate")
        check(runs[True]["peak"] < runs[False]["peak"],
              f"sd15 checkpointing: peak memory {runs[True]['peak']} >= {runs[False]['peak']}")
        stats["checkpointing"] = dict(peak_off_gib=runs[False]["peak"],
                                      peak_on_gib=runs[True]["peak"], s_off=runs[False]["s"],
                                      s_on=runs[True]["s"], bit_equal=bit_equal)
        del runs, batch, noise
        gc.collect()
        torch.cuda.empty_cache()

        unet.config.gradient_checkpointing = True
        trainer = t2i.build_trainer(unet, sched, t2i.sd_samples(SD15_TRAIN_SAMPLES),
                                    batch_size=b)
        zero()
        torch.cuda.reset_peak_memory_stats()
        trainer.train(GC_TRAIN_STEPS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, got_dim = launches()
        want_ = keyed(train_walk(unet, b, 64, GC_TRAIN_STEPS))
        losses_ = torch.stack([h["loss"] for h in trainer.history]).float()
        s_step = step_seconds(trainer)
        print(f"[sd15 checkpointing] build_trainer + Trainer.train with gradient_checkpointing, "
              f"{GC_TRAIN_STEPS} steps at batch {b}: {s_step:.4f} s a step (median of the "
              f"later), losses {[round(x_, 4) for x_ in losses_.tolist()]}, peak memory "
              f"{peak:.2f} GiB; launches {got}, by head_dim {got_dim} (walk: each block's B15 and "
              f"B4 twice) ({card})", flush=True)
        check(bool(torch.isfinite(losses_).all()) and got == walk(want_)
              and got_dim == train_dims(want_),
              f"sd15 checkpointing train: launches {got} / {got_dim} != {want_}")
        phases["sd15_gc"], dims["sd15_gc"] = got, got_dim
        stats["checkpointing"].update(trainer_step_s=s_step, trainer_peak_gib=peak)
        del trainer, unet, params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return phases, dims, stats


# --------------------------------------------------- DiT and PixArt (45a-45e)
def strided_flash_case(torch, F, dev, gen, record, attn, shape, label):
    """B1 at `shape` = (B, S, H, D) on q, k and v that are strided views of
    one (B, S, 3H, D) projection, as DiT's fused qkv hands them to the kernel
    (read in place): `views_flash_case`."""
    b_, s_, h_, d_ = shape
    qkv = torch.randn((b_, s_, 3 * h_, d_), generator=gen, device=dev, dtype=torch.bfloat16)
    views_flash_case(torch, F, dev, gen, record, attn, *qkv.split(h_, dim=2), label,
                     f"q / k / v strided views of a (B, S, {3 * h_}, {d_}) projection")


def dit_kernels(torch, F, dev, gen, record, m, gn_case):
    """Phase 45c: the DiT and PixArt paths' new kernel shapes (see the
    module docstring), each per element with its control, times, bounds and
    library calls."""
    attn, norms = m.attn, m.norms
    label = "dit kernels"
    for shape in DIT_FLASH_SHAPES:
        strided_flash_case(torch, F, dev, gen, record, attn, shape, label)
    sd15_train_kernels(torch, F, dev, gen, record, attn, cases=DIT_TRAIN_FLASH_CASES, tag=label)
    # B12 at DiT's rows: the modulation rows are chunks of one (B, 6H) projection
    b_, s_, h_ = DIT_ADALN_SHAPE
    x = (2 * torch.randn(DIT_ADALN_SHAPE, generator=gen, device=dev)).to(torch.bfloat16)
    mod = torch.randn((b_, 6 * h_), generator=gen, device=dev).to(torch.bfloat16)
    shift, scale = mod.chunk(6, dim=-1)[:2]
    out = norms.adaptive_layer_norm(x, scale, shift)
    torch.cuda.synchronize()
    ref = norms.adaptive_layer_norm_ref(x, scale, shift)
    err = (out.float() - ref.float()).abs().max().item()
    excess, need = ulp_gate(out, ref, ADALN_SUM)
    control, _ = ulp_gate(norms.adaptive_layer_norm_ref(x, scale, 0 * shift), ref, ADALN_SUM)
    plan = norms.adaln_plan_of(x, scale, shift)
    print(f"[{label}] adaptive_layer_norm {DIT_ADALN_SHAPE} bf16: max_abs_err {err:.3e}, excess "
          f"{excess:.3e} (least c {need:.2e}); control without the shift: excess {control:.3e} "
          f"(must be > 0) | {plan}", flush=True)
    check(bool(torch.isfinite(out).all()) and excess <= 0, f"{label} adaLN: excess {excess}")
    check(control > 0, f"{label} adaLN: the control passes ({control})")
    kernel = cold(lambda t: norms.adaptive_layer_norm(t, scale, shift), x, nbytes(x))
    ms, plain_ms = timed_pair(
        torch, kernel, cold(lambda t: norms.adaptive_layer_norm_ref(t, scale, shift), x, nbytes(x)))
    lib_ms = library_ms(torch, cold(lambda t: F.layer_norm(t, (h_,), eps=1e-5) * (
        1 + scale[:, None]) + shift[:, None], x, nbytes(x)))
    floor = floor_ms(torch, norms, b_ * plan.nb, plan.threads, kernel.copies)
    record(label, "adaptive_layer_norm", DIT_ADALN_SHAPE, err, ms, plain_ms, lib_ms,
           bound(nbytes(x, scale, shift, out), 8 * x.numel(), "fp32"),
           " (library: F.layer_norm, then the modulation)", floor=floor)
    del x, mod, out, ref
    rms_kernels(torch, F, dev, gen, record, norms, shapes=PIXART_RMS_SHAPES, extra=[],
                label=label)
    for shape, act in DIT_GN_CASES:
        gn_case(label, shape, act, control=True)
    gc.collect()
    torch.cuda.empty_cache()


class part_timer:
    """Wraps a bound method of `owner` so that each call's host seconds, ended
    by a sync, add up under `key` in `seconds`."""

    def __init__(self, torch, owner, name, seconds, key):
        self.torch, self.fn, self.seconds, self.key = torch, getattr(owner, name), seconds, key

    def __call__(self, *a, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        self.torch.cuda.synchronize()
        self.seconds[self.key] = self.seconds.get(self.key, 0.0) + time.perf_counter() - t0
        return out


def dit_slice(torch, F, np, dev, gen, m, counters, record, gn_case, card):
    """Phases 45a-45e (see the module docstring): DiT-XL/2-256's directory
    written and read back, its requests, the new kernel shapes, its trainer,
    and PixArt-XL-2-512x512's request. Everything is written under one
    temporary directory, removed in a `finally`. `counters` are every kernel
    wrapper's, by name. Returns ({phase: launches}, the numbers)."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers import (
        DDIMScheduler,
        DiffusionPipeline,
        DiTConfig,
        DiTPipeline,
        DPMSolverMultistepScheduler,
    )
    from paddlemix_tpu_torch.diffusers.dit import (
        DIT_SCHEDULER,
        dit_forward_launches,
        expected_launches_dit,
        expected_launches_dit_train,
        random_dit,
        random_dit_pipeline,
    )
    from paddlemix_tpu_torch.diffusers.models import dit as dit_mod
    from paddlemix_tpu_torch.diffusers.pixart import (
        expected_launches_pixart,
        random_pixart_pipeline,
    )
    from paddlemix_tpu_torch.diffusers.schedulers import DDPMScheduler
    from paddlemix_tpu_torch.models.t5.modeling import T5Attention
    from paddlemix_tpu_torch.tools import train_dit

    bf16 = torch.bfloat16
    attn, norms = m.attn, m.norms
    phases, stats = {}, {}
    b1_plain = (attn, "flash_attention", lambda q, k, v, **kw: attn.flash_attention_ref(
        q, k, v, scale=kw.get("scale")))
    adaln_plain = (dit_mod, "adaptive_layer_norm", norms.adaptive_layer_norm_ref)

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def walk(want):
        return {name: want.get(name, 0) for name in counters}

    def unequal(a, b):
        out = []
        for name in ("transformer", "vae"):
            sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
            out += [f"{name}: keys differ"] if sa.keys() != sb.keys() else [
                f"{name}.{k}" for k, v in sa.items()
                if not (v.dtype == sb[k].dtype and torch.equal(v, sb[k]))]
        return out

    def images_ok(image, side):
        return image.shape[1:] == (side, side, 3) and bool(np.isfinite(image).all()) \
            and 0.0 <= image.min() and image.max() <= 1.0 and image.std() > 0.01

    tmp = tempfile.mkdtemp(prefix="pmix_smoke_dit_")
    try:
        # ---------------------------------------------------- 45a the directory
        t0 = time.perf_counter()
        pipe = random_dit_pipeline(dev, bf16, seed=0)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        total = sum(t.numel() * t.element_size() for name in ("transformer", "vae")
                    for t in getattr(pipe, name).state_dict().values())
        free = shutil.disk_usage(tmp).free
        check(free >= 2 * total + 2 ** 30, f"dit dir: {free / 1e9:.1f} GB free under {tmp}")
        n_params = sum(p.numel() for p in pipe.transformer.parameters())
        gates = max(blk.adaLN_modulation.weight.abs().max().item()
                    for blk in pipe.transformer.blocks)
        paths, backs, t_write, t_read = {}, {}, {}, {}
        for kind, sched_cls in (("ddim", DDIMScheduler),
                                ("dpmsolver", DPMSolverMultistepScheduler)):
            pipe.scheduler = pipe._components["scheduler"] = sched_cls(**DIT_SCHEDULER)
            paths[kind] = os.path.join(tmp, f"dit-xl-2-256-{kind}")
            t0 = time.perf_counter()
            pipe.save_pretrained(paths[kind])
            t_write[kind] = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            backs[kind] = DiffusionPipeline.from_pretrained(paths[kind], dtype=bf16, device=dev)
            torch.cuda.synchronize()
            t_read[kind] = time.perf_counter() - t0
        differ = {kind: unequal(pipe, back) for kind, back in backs.items()}
        kinds = {kind: type(back.scheduler).__name__ for kind, back in backs.items()}
        print(f"[dit dir] DiT-XL/2-256 ({n_params} parameters, adaLN gates drawn: max |w| "
              f"{gates:.3f}) and the SD VAE built in bf16 in {t_build:.1f} s; written by "
              f"save_pretrained with DDIM's and with DPM-Solver++'s scheduler config, "
              f"{total / 1e9:.3f} GB each, in {t_write['ddim']:.2f} / {t_write['dpmsolver']:.2f} "
              f"s; read by DiffusionPipeline.from_pretrained in bf16 in {t_read['ddim']:.2f} / "
              f"{t_read['dpmsolver']:.2f} s ({total / 1e9 / t_read['ddim']:.2f} GB/s, warm page "
              f"cache): {kinds}; tensors not bit-equal: "
              f"{ {k: len(v) for k, v in differ.items()} } ({card})", flush=True)
        check(gates > 0 and all(isinstance(b_, DiTPipeline) for b_ in backs.values())
              and kinds == {"ddim": "DDIMScheduler", "dpmsolver": "DPMSolverMultistepScheduler"}
              and not any(differ.values()), f"dit dir: {kinds}, {differ}")
        stats["io"] = dict(gb=total / 1e9, write_s=t_write, read_s=t_read, build_s=t_build)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------------------------------------------- 45b serving
        back = backs["ddim"]
        tf = back.transformer
        rows = 2 * len(DIT_LABELS)
        labels = torch.tensor(DIT_LABELS + (tf.config.num_classes,) * len(DIT_LABELS),
                              device=dev)
        lat = torch.randn((rows, 32, 32, 4), generator=gen, device=dev).to(bf16)
        t_in = back.scheduler.set_timesteps(DIT_STEPS).timesteps[5].to(dev).expand(rows)

        def forward(swaps=()):
            with swapped(swaps), torch.inference_mode():
                return tf(lat, t_in, labels).float()

        zero()
        out_k = forward()
        got = launches()
        out_p = forward([b1_plain, adaln_plain])
        agree = rel_l2(out_k, out_p)
        no_shift = (dit_mod, "adaptive_layer_norm", lambda x, sc, sh: norms.adaptive_layer_norm_ref(
            x, sc, 0 * sh))
        short = (attn, "flash_attention", lambda q, k, v, **kw: attn.flash_attention_ref(
            q, k[:, :128], v[:, :128]))
        ctrl = {name: rel_l2(forward(swaps), out_p) for name, swaps in (
            ("adaLN without the shift", [b1_plain, no_shift]),
            ("attention without the last 128 keys", [short, adaln_plain]))}
        want = walk(dit_forward_launches(tf, rows))
        print(f"[dit agree] full-width DiT-XL/2 forward at the CFG batch of {rows} (8 labels and "
              f"the null class), kernels (B1, B12) vs plain: relative L2 {agree:.3e} (tol "
              f"{AGREE_TOL}); controls (must fail): {ctrl}; launches {got} (walk {want})",
              flush=True)
        check(agree <= AGREE_TOL and all(c_ > AGREE_TOL for c_ in ctrl.values()),
              f"dit agree: {agree}, controls {ctrl}")
        check(got == want, f"dit agree: launches {got} != {want}")
        del out_k, out_p

        want = walk(expected_launches_dit(back, len(DIT_LABELS), DIT_STEPS, DIT_GUIDANCE))
        seconds = []
        zero()
        torch.cuda.reset_peak_memory_stats()
        for profiled in (False, True):
            with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                    contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                image = back(list(DIT_LABELS), DIT_GUIDANCE, DIT_STEPS, seed=DIT_SEED,
                             output_type="np")[0]
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            check(images_ok(image, 256), f"dit serve: image {image.shape} not finite in [0, 1]")
        got = launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        device_ms = kernel_breakdown("dit serve", "profiled request", prof, 10)
        print(f"[dit serve] {len(DIT_LABELS)} labels, CFG {DIT_GUIDANCE}, {DIT_STEPS} DDIM steps, "
              f"256 px: {seconds[0]:.3f} s; profiled {seconds[1]:.3f} s with {device_ms:.1f} ms of "
              f"device time: busy {100 * device_ms / 1e3 / seconds[1]:.1f}%; peak memory "
              f"{peak:.2f} GiB; images {image.shape} std {image.std():.3f}; launches of the two "
              f"{got} (walk {want}, each) ({card})", flush=True)
        check(got == {k: 2 * v for k, v in want.items()},
              f"dit serve: launches {got} != 2 x {want}")
        phases["dit"] = {k: v // 2 for k, v in got.items()}
        stats["serve"] = dict(request_s=seconds[0], device_ms=device_ms,
                              busy=device_ms / 1e3 / seconds[1], peak_gib=peak)
        zero()
        t0 = time.perf_counter()
        image = backs["dpmsolver"](list(DIT_LABELS), DIT_GUIDANCE, DIT_STEPS, seed=DIT_SEED,
                                   output_type="np")[0]
        torch.cuda.synchronize()
        t_dpm = time.perf_counter() - t0
        got = launches()
        print(f"[dit serve] the same request under DPM-Solver++: {t_dpm:.3f} s, images finite "
              f"{bool(np.isfinite(image).all())}, launches {got}", flush=True)
        check(images_ok(image, 256) and got == want, f"dit serve dpmsolver: {got} != {want}")
        stats["serve"]["dpmsolver_s"] = t_dpm
        del backs, back, tf, lat
        gc.collect()
        torch.cuda.empty_cache()

        # ----------------------------------------------------- 45c kernel shapes
        dit_kernels(torch, F, dev, gen, record, m, gn_case)

        # ----------------------------------------------------------- 45d training
        model = random_dit(dev, torch.float32, seed=1, compute_dtype=bf16)
        model.config.gradient_checkpointing = True
        params = [p for p in model.parameters() if p.requires_grad]
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        samples = train_dit.dit_samples()[:DIT_TRAIN_BATCH]
        batch = {k: torch.from_numpy(np.stack([s_[k] for s_ in samples])).to(dev)
                 for k in samples[0]}
        t_fix = torch.arange(DIT_TRAIN_BATCH, device=dev) * 61 % 1000
        noise = torch.randn(batch["latents"].shape, generator=gen, device=dev)
        sched = DDPMScheduler(num_train_timesteps=1000)

        def loss_and_grads(swaps=()):
            with swapped(swaps):
                loss = train_dit.dit_loss(model, sched, batch, t_fix, noise)
                grads = torch.autograd.grad(loss, params)
            return loss.detach().float(), grads

        zero()
        torch.cuda.reset_peak_memory_stats()
        stats["train_agree"] = grad_agree(torch, m, "dit train agree", loss_and_grads, names,
                                          card, extra=[adaln_plain])
        peak_agree = torch.cuda.max_memory_allocated() / 2 ** 30
        zero()
        loss_and_grads()
        got = launches()
        want = walk(expected_launches_dit_train(model, DIT_TRAIN_BATCH))
        print(f"[dit train agree] full-width DiT-XL/2 (fp32 masters, bf16 compute, gradient "
              f"checkpointing per block), a micro-batch of {DIT_TRAIN_BATCH} at fixed t and "
              f"noise; peak memory {peak_agree:.2f} GiB; launches of one loss and its gradients "
              f"{got} (walk {want})", flush=True)
        check(got == want, f"dit train agree: launches {got} != {want}")
        del model, params, batch, noise
        gc.collect()
        torch.cuda.empty_cache()

        cfg_dir = os.path.join(tmp, "dit-gc")
        DiTConfig(gradient_checkpointing=True).save_pretrained(cfg_dir)
        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, res = train_dit.main([cfg_dir], device=dev, max_steps=DIT_TRAIN_STEPS,
                                      logging_steps=1, save_steps=0,
                                      output_dir=os.path.join(tmp, "out"))
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        got = launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tm = trainer.model
        want = walk(expected_launches_dit_train(tm, DIT_TRAIN_BATCH, DIT_TRAIN_STEPS))
        losses_ = [float(h["loss"]) for h in trainer.history]
        s_step = step_seconds(trainer)
        t_prof, dev_ms = profiled_steps(torch, trainer)
        moved = sum(bool(p.abs().sum() > 0) for blk in tm.blocks
                    for p in (blk.adaLN_modulation.weight,))
        print(f"[dit train] tools.train_dit.main (DiT-XL/2-256, gradient checkpointing, batch "
              f"{DIT_TRAIN_BATCH}, lr {trainer.args.learning_rate}, max_steps {DIT_TRAIN_STEPS}) "
              f"in {t_main:.2f} s with the build: losses {[round(x, 4) for x in losses_]}; "
              f"median step {s_step:.4f} s; a profiled step {t_prof:.4f} s with {dev_ms:.1f} ms of "
              f"device time: busy {100 * dev_ms / 1e3 / t_prof:.1f}%; peak memory {peak:.2f} GiB; "
              f"adaLN-zero moved off zero in {moved} of {len(tm.blocks)} blocks; launches {got} "
              f"(walk {want}) ({card})", flush=True)
        check(res["final_step"] == DIT_TRAIN_STEPS and all(np.isfinite(losses_)) and
              moved == len(tm.blocks), f"dit train: {res}, losses {losses_}, moved {moved}")
        check(got == want, f"dit train: launches {got} != {want}")
        phases["dit_train"] = got
        stats["train"] = dict(step_s=s_step, busy=dev_ms / 1e3 / t_prof, peak_gib=peak,
                              device_ms=dev_ms, losses=losses_)
        del trainer, tm
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ 45e PixArt
        t0 = time.perf_counter()
        px = random_pixart_pipeline(dev, bf16, seed=0)
        torch.cuda.synchronize()
        n_params = {name: sum(p.numel() for p in getattr(px, name).parameters())
                    for name in ("transformer", "text_encoder", "vae")}
        print(f"[pixart] PixArt-XL-2-512x512, T5 v1.1-XXL and the SD VAE built in bf16 on the "
              f"card in {time.perf_counter() - t0:.1f} s: {n_params}, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)
        # agree. T5 over the negative prompt and the prompt, B11 vs plain, with its
        # control; the pair (the plain version summing in fp64) is the rounding floor
        def rms_mean_abs(x, w, eps):
            xf = x.float()
            return (xf / (xf.abs().mean(-1, keepdim=True) + eps) * w.float()).to(x.dtype)

        def rms_fp64(x, w, eps):
            xd = x.double()
            return (xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + eps)
                    * w.double()).to(x.dtype)

        def encode(rms=None):
            with swapped([(norms, "_rms_forward", rms)] if rms else []):
                return torch.cat([px.encode_prompt([""]),
                                  px.encode_prompt([PIXART_PROMPTS[0]])]).float()

        def t5_gaps():
            zero()
            ctx_k = encode()
            calls = launches()["rms_norm"]
            ctx_p = encode(norms.rms_norm_ref)
            return ctx_k, calls, {
                "kernels": rel_l2(ctx_k, ctx_p), "pair": rel_l2(encode(rms_fp64), ctx_p),
                "control": rel_l2(encode(rms_mean_abs), ctx_p)}

        ctx, t5_calls, t5_gap = t5_gaps()
        print(f"[pixart agree] T5-XXL over the negative prompt and the prompt (2 x 120 tokens, "
              f"{t5_calls} B11 calls), relative L2 of the hidden states to the plain version's: "
              f"kernels {t5_gap['kernels']:.3e} (tol {AGREE_TOL}); the plain version summing in "
              f"fp64 {t5_gap['pair']:.3e}; control, the mean |x| for the root mean square "
              f"{t5_gap['control']:.3e} (must fail)", flush=True)
        check(t5_gap["kernels"] <= AGREE_TOL < t5_gap["control"] and t5_calls == 98,
              f"pixart t5 agree: {t5_gap}, {t5_calls} calls")

        # the transformer on that context: each B1 call per element against its
        # plain version on its own inputs (control: the last 128 keys left out),
        # then the output, kernels vs plain, with its controls
        real_b1, b1_gates = attn.flash_attention, []

        def b1_checked(q, k, v, **kw):
            out = real_b1(q, k, v, **kw)
            f32 = (q.float(), k.float(), v.float())
            ref = attn.flash_attention_ref(*f32, scale=kw.get("scale"))
            short_ = attn.flash_attention_ref(f32[0], f32[1][:, :-128], f32[2][:, :-128],
                                              scale=kw.get("scale"))
            b1_gates.append((ulp_gate(out, ref, FLASH_SUM)[0],
                             ulp_gate(short_, ref, FLASH_SUM)[0]))
            return out
        # the wrapper counts its launches under the name it is called by: here this one's
        b1_checked.launches, b1_checked.launches_by_dim = 0, collections.Counter()

        tfp = px.transformer
        lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev).to(bf16)
        t_in = px.scheduler.set_timesteps(PIXART_STEPS).timesteps[3].to(dev).expand(2)

        def pforward(swaps=()):
            with swapped(swaps), torch.inference_mode():
                return tfp(lat, t_in, ctx.to(bf16)).float()

        def b1_plain_with(fn):
            return (attn, "flash_attention", lambda q, k, v, **kw: fn(
                q.float(), k.float(), v.float(), kw.get("scale")).to(q.dtype))

        out_k = pforward([(attn, "flash_attention", b1_checked)])
        out_p = pforward([b1_plain])
        agree = rel_l2(out_k, out_p)
        worst = (max(g[0] for g in b1_gates), min(g[1] for g in b1_gates), len(b1_gates))
        ref_ = attn.flash_attention_ref

        def output_gaps(cases):
            return {name: rel_l2(pforward([b1_plain_with(fn)]), out_p) for name, fn in cases}
        # two faults the output shows (must fail) and two it is too coarse to see
        # (printed; the per-call gate above holds every call per element)
        ctrl = output_gaps([
            ("v of the next head", lambda q, k, v, sc: ref_(q, k, v.roll(1, dims=2), scale=sc)),
            ("k and v of the other CFG row", lambda q, k, v, sc: ref_(q, k.flip(0), v.flip(0),
                                                                      scale=sc))])
        unseen = output_gaps([
            ("the last 128 keys left out", lambda q, k, v, sc: ref_(q, k[:, :-128], v[:, :-128],
                                                                    scale=sc)),
            ("the softmax scale of D 128", lambda q, k, v, sc: ref_(q, k, v, scale=128 ** -0.5))])
        print(f"[pixart agree] the transformer's B1 at (2, 1024, 16, 72), each call per element "
              f"against its plain version on its own inputs (largest excess, least control "
              f"excess (must be > 0), calls): {worst} (control: the last 128 keys left out); "
              f"the full-width transformer's output at the CFG batch of 2, kernels vs plain on "
              f"that context: relative L2 {agree:.3e} (tol {AGREE_TOL}); controls (must fail): "
              f"{ {k: f'{v:.3e}' for k, v in ctrl.items()} }; faults too small to show in the "
              f"output: { {k: f'{v:.3e}' for k, v in unseen.items()} }", flush=True)
        check(worst[0] <= 0 < worst[1] and worst[2] == 28 and agree <= AGREE_TOL
              and all(c_ > AGREE_TOL for c_ in ctrl.values()),
              f"pixart agree: {worst}, {agree}, controls {ctrl}")
        del out_k, out_p, ctx, lat

        want = walk(expected_launches_pixart(px, 1, PIXART_STEPS, PIXART_GUIDANCE))
        parts, seconds = {}, []
        px.encode_prompt = part_timer(torch, px, "encode_prompt", parts, "t5 encode")
        px.vae.decode = part_timer(torch, px.vae, "decode", parts, "decode")
        zero()
        torch.cuda.reset_peak_memory_stats()
        for i, profiled in enumerate((False, True)):
            with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                    contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                image = px(PIXART_PROMPTS[i], num_inference_steps=PIXART_STEPS,
                           guidance_scale=PIXART_GUIDANCE, seed=PIXART_SEED + i)[0]
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            check(images_ok(image, 512), f"pixart: image {image.shape} not finite in [0, 1]")
            if i == 0:
                split = dict(parts, denoise=seconds[0] - sum(parts.values()))
        got = launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        device_ms = kernel_breakdown("pixart serve", "profiled request", prof, 10)
        print(f"[pixart serve] a {PIXART_STEPS}-step DPM-Solver++ request at CFG "
              f"{PIXART_GUIDANCE}, 512 px: {seconds[0]:.3f} s ("
              f"{', '.join(f'{k} {v:.3f} s' for k, v in split.items())}); profiled "
              f"{seconds[1]:.3f} s with {device_ms:.1f} ms of device time: busy "
              f"{100 * device_ms / 1e3 / seconds[1]:.1f}%; peak memory {peak:.2f} GiB; image "
              f"std {image.std():.3f}; launches of the two {got} (walk {want}, each) ({card})",
              flush=True)
        check(got == {k: 2 * v for k, v in want.items()},
              f"pixart serve: launches {got} != 2 x {want}")
        phases["pixart"] = {k: v // 2 for k, v in got.items()}
        # the witness of the seeded T5's init: the same encoder with its q and
        # relative-position tables redrawn at the fan-in rule (std d_model ** -0.5, 1)
        with torch.no_grad():
            for mod_ in px.text_encoder.modules():
                if isinstance(mod_, T5Attention):
                    mod_.q.weight.normal_(0.0, mod_.q.weight.shape[1] ** -0.5, generator=gen)
                    if mod_.relative_attention_bias is not None:
                        mod_.relative_attention_bias.weight.normal_(0.0, 1.0, generator=gen)
        fan_gap = t5_gaps()[2]
        print(f"[pixart t5 init] the same T5 with q and the relative-position tables redrawn "
              f"at the fan-in rule, relative L2 to the plain version's: kernels "
              f"{fan_gap['kernels']:.3e}, the plain version summing in fp64 {fan_gap['pair']:.3e}, "
              f"the control {fan_gap['control']:.3e}; at T5's own init (above) "
              f"{t5_gap['kernels']:.3e} / {t5_gap['pair']:.3e} / {t5_gap['control']:.3e}",
              flush=True)
        stats["pixart"] = dict(request_s=seconds[0], split=split, device_ms=device_ms,
                               busy=device_ms / 1e3 / seconds[1], peak_gib=peak,
                               t5_agree=t5_gap, t5_fan_in=fan_gap, agree=agree,
                               controls=ctrl, unseen=unseen, b1_calls=worst)
        del px
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return phases, stats


def cond_len(samples):
    """The context tokens of the training samples (77 CLIP + 77 T5)."""
    return samples[0]["encoder_hidden_states"].shape[0]


def latent_side(samples):
    """The side of the training samples' square latents (128 at 1024 px)."""
    return samples[0]["latents"].shape[0]


# ------------------------------------------- InternVL2-8B and Qwen-VL-Chat (46a-47d)
def views_flash_case(torch, F, dev, gen, record, attn, q, k, v, label, layout):
    """B1 at q (B, Sq, H, D) over k / v (B, Skv, H, D), views the caller
    made (read in place where they are strided views of one projection):
    per element against the plain version (FLASH_SUM) with the control (the
    last key tile left out) that must fail; times, bound and SDPA's time on
    the same views."""
    b_, sq, h_, d_ = q.shape
    skv = k.shape[1]
    check(attn._kernel_operand(q) is q and attn._kernel_operand(k) is k,
          f"{label}: a {layout} view would be copied")
    out = attn.flash_attention(q, k, v, int8_qk=False)
    torch.cuda.synchronize()
    ref = attn.flash_attention_ref(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    excess, need = ulp_gate(out, ref, FLASH_SUM)
    n = skv - (skv % 64 or 64)
    control, _ = ulp_gate(attn.flash_attention_ref(q.float(), k[:, :n].float(), v[:, :n].float()),
                          ref, FLASH_SUM)
    shape = (b_, sq, skv, h_, d_) if sq != skv else (b_, sq, h_, d_)
    print(f"[{label}] flash {shape} bf16, {layout} (strides q {tuple(q.stride())}): max_abs_err "
          f"{err:.3e}, excess {excess:.3e} (least c {need:.2e}); control without the last "
          f"{skv - n} keys: excess {control:.3e} (must be > 0)", flush=True)
    check(bool(torch.isfinite(out).all()) and excess <= 0, f"{label} flash {shape}: {excess}")
    check(control > 0, f"{label} flash {shape}: the control passes ({control})")
    del ref
    ms, plain_ms = timed_pair(torch, lambda: attn.flash_attention(q, k, v, int8_qk=False),
                              lambda: attn.flash_attention_ref(q, k, v))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
    ops = 4 * b_ * h_ * sq * skv * d_
    record(label, "flash_attention", shape, err, ms, plain_ms, lib_ms,
           bound(nbytes(q, k, v, out), ops, "bf16"), f" {layout} | library: SDPA",
           flash=(d_, ops, False))
    del out


def vlm_ln_plans(torch, norms, label, shapes):
    """B10's forward plan at each (rows, width, 1) of `shapes`, the library's
    against the wrapper's mirror."""
    for rows, h, _ in shapes:
        plan = norms.layer_norm_plan(rows, h, 2)
        lib = norms.layer_norm_plan_library(rows, h, torch.bfloat16)
        print(f"[{label}] layer_norm plan ({rows}, {h}) bf16: mirror {plan}, library {lib}",
              flush=True)
        check(plan == lib, f"layer_norm plan ({rows}, {h}): mirror {plan} != library {lib}")


def internvl2_kernels(torch, F, dev, gen, record, m):
    """Phase 46a (see the module docstring)."""
    label = "internvl2 kernels"
    for tiles in INTERNVL2_FLASH_TILES:
        qkv = torch.randn((tiles, 1025, 3, 16, 64), generator=gen, device=dev,
                          dtype=torch.bfloat16)
        views_flash_case(torch, F, dev, gen, record, m.attn, *qkv.unbind(2), label,
                         "q / k / v global thirds (T, N, 3, H, D) of one projection")
        del qkv
    vlm_ln_plans(torch, m.norms, label, INTERNVL2_LN_SHAPES)
    clip_kernels(torch, F, dev, gen, record, m.norms, shapes=INTERNVL2_LN_SHAPES, backward=False,
                 label=label)
    decode_kernels(torch, F, dev, gen, record, m.da, cases=INTERNVL2_DECODE_CASES, label=label)
    torch.cuda.empty_cache()


def qwenvl_kernels(torch, F, dev, gen, record, m):
    """Phase 47a (see the module docstring)."""
    label = "qwenvl kernels"
    bf16 = torch.bfloat16
    for b_ in QWENVL_FLASH_IMAGES:
        qkv = torch.randn((b_, 1024, 16, 312), generator=gen, device=dev, dtype=bf16)
        views_flash_case(torch, F, dev, gen, record, m.attn, *qkv.chunk(3, dim=-1), label,
                         "q / k / v per head (B, N, H, 3 hd) of one projection")
        q = torch.randn((b_, 256, 32, 128), generator=gen, device=dev, dtype=bf16)
        k, v = (torch.randn((b_, 1024, 32, 128), generator=gen, device=dev, dtype=bf16)
                for _ in range(2))
        views_flash_case(torch, F, dev, gen, record, m.attn, q, k, v, label,
                         "the Resampler's 256 queries over the patch grid")
        del qkv, q, k, v
    vlm_ln_plans(torch, m.norms, label, QWENVL_LN_SHAPES)
    clip_kernels(torch, F, dev, gen, record, m.norms, shapes=QWENVL_LN_SHAPES, backward=False,
                 label=label)
    decode_kernels(torch, F, dev, gen, record, m.da, cases=QWENVL_DECODE_CASES, label=label)
    torch.cuda.empty_cache()


def vlm_dir(torch, dev, model, label, card):
    """One round trip of `model` through a directory in JAX's layout:
    save_pretrained (flax keys), then AutoModel.from_pretrained in bf16; the
    same config and 0 tensors differing. Returns (the model read back, its
    numbers); the directory is removed."""
    import shutil
    import tempfile

    from paddlemix_tpu_torch.auto import AutoModel

    total = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    tmp = tempfile.mkdtemp(prefix=f"pmix_smoke_{label.split()[0]}_dir_")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"[{label}] {tmp}: {free / 1e9:.1f} GB free, this phase needs "
              f"{(total + 2 ** 30) / 1e9:.1f} GB", flush=True)
        check(free >= total + 2 ** 30, f"{label}: {free / 1e9:.1f} GB free under {tmp}")
        t0 = time.perf_counter()
        files = model.save_pretrained(tmp)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = AutoModel.from_pretrained(tmp, device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        mine = model.state_dict()
        differ = [k for k, t in back.state_dict().items()
                  if t.dtype != mine[k].dtype or not torch.equal(t, mine[k])]
        same_cfg = back.config.to_dict() == model.config.to_dict()
        print(f"[{label}] save_pretrained (flax keys, {len(files)} files) {t_write:.2f} s "
              f"({total / 1e9 / t_write:.2f} GB/s of {total / 1e9:.3f} GB); AutoModel "
              f"({type(back).__name__}) read back in bf16 {t_read:.2f} s "
              f"({total / 1e9 / t_read:.2f} GB/s, warm page cache); the same config {same_cfg}; "
              f"tensors differing {len(differ)} of {len(mine)} {differ[:3]} ({card})", flush=True)
        check(same_cfg and not differ, f"{label}: {len(differ)} tensors differ: {differ[:3]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return back, dict(gb=total / 1e9, write_s=t_write, read_s=t_read, files=len(files))


def vlm_agree(torch, dev, m, counters, model, kw, ids, walk, label):
    """The prefill's logits (the images' arguments `kw`) and those of
    VLM_AGREE_STEPS decode steps fed seeded ids, kernels (B1, B10, B11, B7)
    against their plain versions swapped in, within a relative L2 of
    AGREE_TOL; the kernels' launches as `walk(prompt_len, forwards)` says."""
    from paddlemix_tpu_torch.models.llama import modeling as llama_mod

    attn, norms, da = m.attn, m.norms, m.da
    s_ = ids.shape[1]
    toks = torch.randint(0, 90000, (VLM_AGREE_STEPS, 1, 1),
                         generator=torch.Generator().manual_seed(0)).to(dev)

    def steps(swaps=()):
        with torch.inference_mode(), swapped(swaps):
            cache = model.init_cache(1, s_ + VLM_AGREE_STEPS)
            logits, cache = model(ids, cache=cache, **kw)
            outs = [logits[0].float()]
            for tok in toks:
                step, cache = model(tok, None, cache.lengths[:, None], cache=cache)
                outs.append(step[0].float())
        return outs[0], torch.cat(outs[1:])

    def flash_plain(q, k, v, *, causal=False, scale=None, segment_ids=None, int8_qk=None):
        return attn.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                        segment_ids=segment_ids)

    swaps = [(attn, "flash_attention", flash_plain),
             (llama_mod, "decode_attention", da.decode_attention_ref),
             (llama_mod, "rms_norm", norms.rms_norm_ref),
             (norms, "_ln_forward", norms.layer_norm_ref)]
    for fn in counters.values():
        fn.launches = 0
    pre_k, dec_k = steps()
    torch.cuda.synchronize()
    got = {name: fn.launches for name, fn in counters.items()}
    pre_p, dec_p = steps(swaps)
    rel_pre, rel_dec = rel_l2(pre_k, pre_p), rel_l2(dec_k, dec_p)
    want = walk(s_, 1 + VLM_AGREE_STEPS)
    print(f"[{label}] full width, kernels (B1, B10, B11, B7) vs plain: relative L2 of the "
          f"logits, prefill ({s_} tokens) {rel_pre:.3e}, {VLM_AGREE_STEPS} decode steps "
          f"{rel_dec:.3e} (tol {AGREE_TOL}); |logits| max {pre_p.abs().max().item():.3f}; ids "
          f"fed {toks.view(-1).tolist()}; launches {got} (walk {want})", flush=True)
    check(bool(torch.isfinite(pre_k).all() and torch.isfinite(dec_k).all())
          and rel_pre <= AGREE_TOL and rel_dec <= AGREE_TOL,
          f"{label}: relative L2 {rel_pre} / {rel_dec}")
    check(got == want, f"{label}: launches {got} != the walk {want}")
    del pre_k, dec_k, pre_p, dec_p
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill=rel_pre, decode=rel_dec)


def vlm_serve(torch, counters, model, requests, walk, tower, label, card, before=None):
    """Batch-1 requests of VLM_NEW_TOKENS tokens, eos off: each `requests`
    entry (kind, make) with make(seed) -> (the images' arguments, prompt
    ids, images or tiles), run twice (a 1-token generate for the TTFT, then
    the full one), timed as processor (make), tower (`tower(kwargs)` alone,
    again), prefill (TTFT less both) and decode; decode tokens/s = 127 /
    (t128 - TTFT); each run's launches as `walk(prompt_len, new_tokens,
    images)` says. `before(kind, ids)` runs ahead of each generate (Qwen-VL's
    NTK alpha). Then one more request of the first kind under the profiler:
    device ms by category and the busy share. Returns (launches, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    totals, rows = collections.Counter(), {}
    torch.cuda.reset_peak_memory_stats()

    def run(kind, make, seed, new_tokens):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kw, ids, n_img = make(seed)
        t_proc = time.perf_counter() - t0
        if before is not None:
            before(kind, ids)
        out = model.generate(ids, max_new_tokens=new_tokens, eos_token_id=-1, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in counters.items()}
        want = walk(ids.shape[1], new_tokens, n_img)
        check(got == want, f"{label} ({kind}): launches {got} != the walk {want}")
        totals.update(got)
        return seconds, t_proc, out, kw, ids, n_img

    for kind, make in requests:
        ttft, _, first, _, _, _ = run(kind, make, 0, 1)
        seconds, t_proc, out, kw, ids, n_img = run(kind, make, 0, VLM_NEW_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            tower(kw)
        torch.cuda.synchronize()
        t_tower = time.perf_counter() - t0
        tps = (VLM_NEW_TOKENS - 1) / (seconds - ttft)
        row = dict(seconds=seconds, processor=t_proc, tower=t_tower,
                   prefill=ttft - t_proc - t_tower, decode=seconds - ttft, ttft=ttft,
                   tokens_per_s=tps, prompt=ids.shape[1], images=n_img)
        rows[kind] = row
        print(f"[{label}] {kind} ({ids.shape[1]} prompt ids, {n_img} images or tiles): "
              f"{seconds:.3f} s for {VLM_NEW_TOKENS} tokens = processor {1e3 * t_proc:.1f} + "
              f"tower {1e3 * t_tower:.1f} + prefill {1e3 * row['prefill']:.1f} + decode "
              f"{1e3 * row['decode']:.1f} ms | TTFT {1e3 * ttft:.1f} ms | decode {tps:.2f} "
              f"tokens/s | tokens {out[0, :8].tolist()}... ({card})", flush=True)
        check(out.shape == (1, VLM_NEW_TOKENS) and out.dtype == torch.int32,
              f"{label}: tokens {tuple(out.shape)} {out.dtype}")
        check(bool(((out >= 0) & (out < model.config.text.vocab_size)).all()),
              f"{label}: a token outside the vocab")
        check(int(first[0, 0]) == int(out[0, 0]),
              f"{label} ({kind}): the first token differs between the TTFT run and the full run")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kind, make = requests[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        seconds, _, _, _, ids, _ = run(kind, make, 1, VLM_NEW_TOKENS)
    device_ms = kernel_breakdown(label, f"profiled {kind} request", prof, 10)
    by_category = collections.Counter()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            by_category[kernel_category(e.key)] += e.self_device_time_total / 1e3
    busy = device_ms / 1e3 / seconds
    print(f"[{label}] profiled {kind} request: {seconds:.3f} s, {device_ms:.2f} ms of device "
          f"time (busy {100 * busy:.1f}%), by category "
          f"{ {k: round(v, 3) for k, v in by_category.most_common()} }; peak memory "
          f"{peak:.2f} GiB; launches over the phase {dict(totals)} ({card})", flush=True)
    return dict(totals), dict(requests=rows, profiled_seconds=seconds, device_ms=device_ms,
                              busy=busy, by_category=dict(by_category), peak_gib=peak)


def internvl2_slice(torch, np, dev, m, counters, card):
    """Phases 46b-46d (see the module docstring): InternVL2-8B at full width
    with seeded random bf16 weights, written and read back, then served
    from the directory's read. `counters` are every kernel wrapper's, by
    name. Returns the launches of the serve and its numbers."""
    import io

    from PIL import Image

    from paddlemix_tpu_torch.models.internvl2 import (
        expected_launches_internvl2,
        prompt_ids,
        random_internvl2,
    )
    from paddlemix_tpu_torch.processors import InternVLImageProcessor

    t0 = time.perf_counter()
    model = random_internvl2(device=dev, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[internvl2 dir] InternVL2-8B built on the card in {t_build:.1f} s: {n_params} "
          f"parameters (tower {sum(p.numel() for p in model.vision_model.parameters())}), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)
    check(8.0e9 < n_params < 8.15e9, f"internvl2: {n_params} parameters")
    served, io_stats = vlm_dir(torch, dev, model, "internvl2 dir", card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = served
    cfg = model.config

    def maker(hw, proc):
        def make(seed):
            """A seeded jpeg decoded and tiled: the padded stack and its mask
            (the tower runs the real tiles alone), the prompt of its tiles."""
            data = smooth_jpeg(np, Image, 500 + seed + hw[1], size=hw)
            with Image.open(io.BytesIO(data)) as im:
                enc = proc(im.convert("RGB"))
            n = int(enc["num_tiles"][0])
            kw = dict(pixel_values=enc["pixel_values"], tile_mask=enc["tile_mask"])
            return kw, prompt_ids(cfg, [n], seed=seed), n
        return make

    requests = [("1 tile", maker(INTERNVL2_ONE_TILE, InternVLImageProcessor())),
                ("12 tiles + thumbnail", maker(INTERNVL2_BIG, InternVLImageProcessor())),
                ("minimonkey", maker(INTERNVL2_BIG, InternVLImageProcessor(
                    multi_scale=True, max_num=INTERNVL2_MINIMONKEY_MAX)))]

    def walk(prompt_len, new_tokens, tiles):
        want = expected_launches_internvl2(model, prompt_len, new_tokens, tiles=tiles)
        return {name: want.get(name, 0) for name in counters}

    kw, ids, n = requests[1][1](0)
    check(n == 13 and ids.shape[1] == 13 * cfg.tokens_per_tile + 2 + 32,
          f"internvl2: the 12-tile request has {n} tiles, {ids.shape[1]} ids")
    agree = vlm_agree(torch, dev, m, counters, model, kw, ids, lambda s_, t_: walk(s_, t_, n),
                      "internvl2 agree")
    launches, stats = vlm_serve(
        torch, counters, model, requests, walk,
        lambda kw_: model.extract_feature(kw_["pixel_values"], kw_["tile_mask"]),
        "internvl2 serve", card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(build_s=t_build, io=io_stats, agree=agree, **stats)


def qwenvl_slice(torch, np, dev, m, counters, card):
    """Phases 47b-47d (see the module docstring): Qwen-VL-Chat at full width
    with seeded random bf16 weights, written and read back, then served
    from the directory's read. Returns the launches of the serve and its
    numbers."""
    import io

    from PIL import Image

    from paddlemix_tpu_torch.models.llama.modeling import logn_scale
    from paddlemix_tpu_torch.models.qwen_vl import (
        expected_launches_qwen_vl,
        prompt_ids,
        random_qwen_vl,
        set_ntk_alpha,
    )
    from paddlemix_tpu_torch.processors import QwenVLProcessor

    t0 = time.perf_counter()
    model = random_qwen_vl(device=dev, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[qwenvl dir] Qwen-VL-Chat built on the card in {t_build:.1f} s: {n_params} "
          f"parameters (tower {sum(p.numel() for p in model.visual.parameters())}), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)
    check(9.6e9 < n_params < 9.7e9, f"qwenvl: {n_params} parameters")
    served, io_stats = vlm_dir(torch, dev, model, "qwenvl dir", card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = served
    cfg = model.config
    proc = QwenVLProcessor()

    def maker(images, text_len):
        def make(seed):
            """Seeded jpegs decoded and processed (448 bicubic, CLIP's
            normalization), the prompt in from_list_format's order ("Picture
            i: " as 4 seeded ids, each image's placeholders), then text."""
            pics = []
            for i in range(images):
                with Image.open(io.BytesIO(smooth_jpeg(np, Image, 700 + 10 * seed + i,
                                                       size=QWENVL_IMAGE))) as im:
                    pics.append(im.convert("RGB"))
            kw = dict(pixel_values=proc.image_processor(pics))
            return kw, prompt_ids(cfg, images, text_len=text_len, seed=seed, filler=4), images
        return make

    requests = [("image", maker(1, 32)), ("two images", maker(2, 32)),
                ("past 2,048 positions", maker(1, QWENVL_LONG_TEXT))]
    alphas = {}

    def before(kind, ids):
        """QWen's dynamic NTK: the alpha of the request's whole context."""
        alphas[kind] = (set_ntk_alpha(model, ids.shape[1] + VLM_NEW_TOKENS),
                        model.language_model.config.rope_base)

    def walk(prompt_len, new_tokens, images):
        want = expected_launches_qwen_vl(model, prompt_len, new_tokens, images=images)
        return {name: want.get(name, 0) for name in counters}

    kw, ids, n = requests[1][1](0)
    set_ntk_alpha(model, ids.shape[1] + VLM_AGREE_STEPS)
    agree = vlm_agree(torch, dev, m, counters, model, kw, ids, lambda s_, t_: walk(s_, t_, n),
                      "qwenvl agree")
    launches, stats = vlm_serve(torch, counters, model, requests, walk,
                                lambda kw_: model.encode_images(kw_["pixel_values"]),
                                "qwenvl serve", card, before=before)
    long = stats["requests"]["past 2,048 positions"]
    last = long["prompt"] + VLM_NEW_TOKENS - 1
    scale = logn_scale(torch.tensor([[last - 1]]), cfg.text.logn_seq_length).item()
    print(f"[qwenvl serve] the long request: positions 0-{last - 1} (logn_seq_length "
          f"{cfg.text.logn_seq_length}), logn scale at the last {scale:.5f}; NTK alpha and "
          f"rope base {alphas['past 2,048 positions']} (the image request's "
          f"{alphas['image']})", flush=True)
    check(last > cfg.text.logn_seq_length and scale > 1.0 and alphas["image"][0] == 1.0
          and alphas["past 2,048 positions"][0] > 1.0,
          f"qwenvl serve: the long request's logn scale {scale}, NTK {alphas}")
    set_ntk_alpha(model, 0)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(build_s=t_build, io=io_stats, agree=agree, ntk_alphas=alphas,
                          logn_scale_last=scale, **stats)


def main():
    import types

    import numpy as np
    import torch
    import torch.nn.functional as F

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this run needs a "
                                     "CUDA card")
    check(os.path.isdir(os.path.join(REPO, "paddlemix_tpu_torch")),
          f"paddlemix_tpu_torch not found beside {__file__}: run from a checkout")
    sys.path.insert(0, REPO)
    from paddlemix_tpu_torch.diffusers.models import resnet as resnet_mod
    from paddlemix_tpu_torch.diffusers.sdxl import (
        calibrate_static_a8w8,
        expected_launches,
        random_sdxl_pipeline,
    )
    from paddlemix_tpu_torch.kernels import build_all, build_log
    from paddlemix_tpu_torch.ops import attention as attn_mod
    from paddlemix_tpu_torch.ops import conv_int8 as conv_int8_mod
    from paddlemix_tpu_torch.ops import fused_resnet as fused_mod
    from paddlemix_tpu_torch.ops import norms as norms_mod
    from paddlemix_tpu_torch.ops import paged_attention as pa_mod
    from paddlemix_tpu_torch.ops import quant as quant_mod

    mods = types.SimpleNamespace(attn=attn_mod, resnet=resnet_mod, norms=norms_mod,
                                 quant=quant_mod, conv_int8=conv_int8_mod, fused=fused_mod)

    # ---------------------------------------------------------------- device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16

    # ----------------------------------------------------------------- build
    sources = ["flash_fwd", "flash_bwd", "int8_gemm", "int8_conv3x3", "wint8_gemm",
               "a8w_gemm", "decode_attention", "paged_attention", "norms"]
    t0 = time.perf_counter()
    build_all(sources)
    print(f"[build] {len(sources)} sources in parallel: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in build_log.items():
        print(f"[build] {name}.cu: {log['seconds']:.1f} s -> {log['path']}", flush=True)
        for line in log["ptxas"].splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "spill", "Performance")):
                print(f"[build]   {line.strip()}")

    lap("build")
    # --------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    record = recorder(summary)

    def flash_case(label, shape, name="flash_attention"):
        b_, s_, h_, d_ = shape
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=bf16) for _ in range(3))
        out = attn_mod.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attn_mod.flash_attention_ref(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        excess, need = ulp_gate(out, ref, FLASH_SUM)
        # the control: the keys of the last tile (the ragged tail) left out
        n = s_ - (s_ % 64 or 64)
        control, _ = ulp_gate(attn_mod.flash_attention_ref(q.float(), k[:, :n].float(),
                                                           v[:, :n].float()), ref, FLASH_SUM)
        print(f"[{label}] flash {shape} bf16: max_abs_err {err:.3e}, excess {excess:.3e} over "
              f"{FLASH_ULP:.4g}|ref| + {FLASH_SUM:g}|ref|max (least c {need:.2e}); control "
              f"without the last {s_ - n} keys: excess {control:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0, f"flash {shape}: excess {excess}")
        check(control > 0, f"flash {shape}: the control passes the limit ({control})")
        del ref
        ms, plain_ms = timed_pair(torch, lambda: attn_mod.flash_attention(q, k, v),
                                  lambda: attn_mod.flash_attention_ref(q, k, v))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        ops = 4 * b_ * h_ * s_ * s_ * d_
        record(label, name, shape, err, ms, plain_ms, lib_ms,
               bound(nbytes(q, k, v, out), ops, "bf16"), flash=(d_, ops, False))

    for shape in FLASH_SHAPES:
        flash_case("kernels", shape)
    def gn_case(label, shape, act, control=False, wdtype=bf16):
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev, dtype=bf16)
        if control:  # channels of their own mean and scale, so the grouping shows
            x = (x.float() * (0.5 + 1.5 * torch.rand(c, generator=gen, device=dev))
                 + torch.randn(c, generator=gen, device=dev)).to(bf16)
        w = (1.0 + 0.05 * torch.randn(c, generator=gen, device=dev)).to(wdtype)
        b = (0.05 * torch.randn(c, generator=gen, device=dev)).to(wdtype)
        t0 = time.perf_counter()
        out = norms_mod.group_norm(x, w, b, 32, 1e-5, act)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ref = norms_mod.group_norm_ref(x.float(), w.float(), b.float(), 32, 1e-5, act)
        err = (out.float() - ref).abs().max().item()
        note = ""
        if control:  # the plain version over 16 groups of twice the channels
            control = (norms_mod.group_norm_ref(x.float(), w.float(), b.float(), 16, 1e-5, act)
                       - ref).abs().max().item()
            note = f"; control over 16 groups: {control:.3e} (must exceed the tol)"
            check(control > GN_TOL, f"group_norm {shape} {act}: the control passes ({control})")
        print(f"[{label}] group_norm {shape} {act} bf16, {str(wdtype)[6:]} w / b: max_abs_err "
              f"{err:.3e} (tol {GN_TOL})"
              f"{note} | first call {first_s:.2f} s", flush=True)
        check(bool(torch.isfinite(out).all()) and err <= GN_TOL,
              f"group_norm {shape} {act}: err {err}")
        ms, plain_ms = timed_pair(torch, lambda: norms_mod.group_norm(x, w, b, 32, 1e-5, act),
                                  lambda: norms_mod.group_norm_ref(x, w, b, 32, 1e-5, act))
        x_nchw = x.permute(0, 3, 1, 2)  # the channels_last view cuDNN's GroupNorm reads
        # F.group_norm takes no fp32 weight beside bf16 rows: the nearest
        # yardstick gives it the weights rounded to bf16
        w_lib, b_lib = w.to(bf16), b.to(bf16)

        def torch_gn():
            y = F.group_norm(x_nchw, 32, w_lib, b_lib, 1e-5)
            return F.silu(y) if act == "silu" else y
        # a few fp32 operations an element (moments, affine, SiLU): bytes bound it
        record(label, "group_norm", shape, err, ms, plain_ms, library_ms(torch, torch_gn),
               bound(nbytes(x, w, b, out), 8 * x.numel(), "fp32"), f" {act}"
               + ("" if wdtype == bf16 else ", fp32 w / b | library: w / b rounded to bf16"))
        del x, out, ref, x_nchw

    for shape, act in GN_CASES + [(GN_RAGGED, "silu")]:
        gn_case("kernels", shape, act, control=True)
    norms_kernels(torch, dev, gen, record, norms_mod)

    def int8_case(name, shape, kernel, plain, library, extra=""):
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        ulps = bf16_ulps(out, ref)
        control = bf16_ulps(unquantized(mods, plain)(), ref)
        print(f"[kernels] {name} {shape}{extra}: max_abs_err {err:.3e}, {ulps:.3g} bf16 ulps "
              f"(limit {INT8_ULPS}; control without the quantize {control:.3g})", flush=True)
        check(bool(torch.isfinite(out).all()) and ulps <= INT8_ULPS,
              f"{name} {shape}: {ulps} bf16 ulps")
        check(control > INT8_ULPS, f"{name} {shape}: the control passes the limit ({control})")
        ms, plain_ms = timed_pair(torch, kernel, plain)
        return out, err, ms, plain_ms, library_ms(torch, library)

    ci, fr = conv_int8_mod, fused_mod
    for m, k, n in GEMM_SHAPES + [GEMM_RAGGED]:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wf = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        wq, sw = ci.quantize_weight_per_cout(wf)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        sx = quant_mod.static_scale(x.float().abs().max().item())
        w16 = wf.to(bf16).t().contiguous()
        out, *times = int8_case("int8_a8w8_matmul", (m, k, n),
                                lambda: ci.int8_a8w8_matmul(x, wq, sw, sx, bias),
                                lambda: ci.int8_a8w8_matmul_ref(x, wq, sw, sx, bias),
                                lambda: torch.matmul(x, w16))
        record("kernels", "int8_a8w8_matmul", (m, k, n), *times,
               bound(nbytes(x, wq, sw, bias, out), 2 * m * n * k, "int8"))
        # the s8 tensor-core yardstick beside bf16 torch.matmul: torch._int_mm
        # on x quantized beforehand (int32 out, no scales)
        xq, wq_t = ci.quantize_int8(x, sx), wq.t()
        int_mm = library_ms(torch, lambda: torch._int_mm(xq, wq_t))
        summary["int8_a8w8_matmul"][-1].update(
            int_mm_ms=int_mm, **gemm_note("kernels", "int8_a8w8_matmul", "a8w8", (m, k, n),
                                          times[1], 2 * m * n * k, "TOP/s",
                                          f"torch._int_mm {int_mm:.3f} ms"))
        del x, wf, wq, w16, out, xq
    for shape in [s_ + (s_[-1],) for s_ in CONV_SHAPES] + [CONV_RAGGED]:
        b_, h_, w_, c, o = shape
        x = torch.randn(shape[:4], generator=gen, device=dev).to(bf16)
        wf = torch.randn((o, c, 3, 3), generator=gen, device=dev) * (9 * c) ** -0.5
        wq, sw = ci.quantize_weight_per_cout(wf)
        wq = ci.conv3x3_weight_layout(wq)
        bias = 0.1 * torch.randn(o, generator=gen, device=dev)
        sx = quant_mod.static_scale(x.float().abs().max().item())
        # cuDNN's bf16 conv over the same channels_last map, the dequantized weight
        x_nchw = x.permute(0, 3, 1, 2)
        w16 = wf.to(bf16).contiguous(memory_format=torch.channels_last)
        b16 = bias.to(bf16)
        ops = 2 * b_ * h_ * w_ * c * 9 * o
        label = shape[:4] if o == c else shape
        out, *times = int8_case("int8_conv3x3_same", label,
                                lambda: ci.int8_conv3x3_same(x, wq, sw, sx, bias),
                                lambda: ci.int8_conv3x3_same_ref(x, wq, sw, sx, bias),
                                lambda: F.conv2d(x_nchw, w16, b16, padding=1))
        record("kernels", "int8_conv3x3_same", label, *times,
               bound(nbytes(x, wq, sw, bias, out), ops, "int8"))
        xq = ci.conv3x3_act_quant(x, sx)
        conv_note("kernels", "int8_conv3x3_same", shape, times[1], ops, {
            "activation pass": cuda_ms(torch, lambda: ci.conv3x3_act_quant(x, sx)),
            "conv": cuda_ms(torch, lambda: ci.conv3x3_gemm(xq, wq, sw, sx, bias))})
        del x, wf, wq, w16, out, x_nchw, xq
    for shape, o, epi in FUSED_CASES + [FUSED_RAGGED]:
        b_, h, w_, c = shape
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        wf = torch.randn((o, c, 3, 3), generator=gen, device=dev) * (9 * c) ** -0.5
        wq, sw = ci.quantize_weight_per_cout(wf)
        wq = ci.conv3x3_weight_layout(wq)
        bias = 0.1 * torch.randn(o, generator=gen, device=dev)
        kw = {}
        if epi == "temb":
            kw["temb"] = torch.randn((b_, o), generator=gen, device=dev).to(bf16)
        elif epi == "residual":
            kw["residual"] = torch.randn((b_, h, w_, o), generator=gen, device=dev).to(bf16)
        sx = quant_mod.static_scale(4.0)  # SiLU of a unit-variance GroupNorm output
        args = (x, gamma, beta, 32, 1e-5, wq, sw, sx, bias)
        ops = 2 * b_ * h * w_ * o * 9 * c
        # no single PyTorch call computes GroupNorm + SiLU + int8 quantize + conv
        out, *times = int8_case("fused_gn_silu_conv3x3", shape + (o,),
                                lambda: fr.fused_gn_silu_conv3x3(*args, **kw),
                                lambda: fr.fused_gn_silu_conv3x3_ref(*args, **kw), None,
                                f" {epi or 'bias only'}")
        record("kernels", "fused_gn_silu_conv3x3", shape + (o,), *times,
               bound(nbytes(x, gamma, beta, wq, sw, bias, out, *kw.values()), ops, "int8"),
               f" {epi or 'bias only'}")
        # the nearest yardstick: cuDNN's bf16 conv of the same map (no norm,
        # no quantize), over the channels_last map and the dequantized weight
        x_nchw = x.permute(0, 3, 1, 2)
        w16 = wf.to(bf16).contiguous(memory_format=torch.channels_last)
        cudnn = library_ms(torch, lambda: F.conv2d(x_nchw, w16, bias.to(bf16), padding=1))
        stats = norms_mod.group_norm_stats(x, 32, 1e-5)
        xq = ci.conv3x3_act_quant(x, sx, stats, gamma, beta, 32)
        conv_note("kernels", "fused_gn_silu_conv3x3", shape + (o,), times[1], ops, {
            "GroupNorm statistics (B4)": cuda_ms(
                torch, lambda: norms_mod.group_norm_stats(x, 32, 1e-5)),
            "activation pass": cuda_ms(
                torch, lambda: ci.conv3x3_act_quant(x, sx, stats, gamma, beta, 32)),
            "conv": cuda_ms(torch, lambda: ci.conv3x3_gemm(xq, wq, sw, sx, bias, **kw))},
            f"cuDNN bf16 F.conv2d of the same conv {cudnn:.3f} ms")
        del x, wf, wq, kw, out, x_nchw, w16, xq

    lap("kernels")
    # ---------------------------------------------------------------- models
    t0 = time.perf_counter()
    pipe = random_sdxl_pipeline(dev, bf16, seed=0, quant="a8w8_static")
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("unet", "vae", "text_encoder", "text_encoder_2")}
    print(f"[models] built on the card in {time.perf_counter() - t0:.1f} s (quant "
          f"a8w8_static, no scales loaded yet: the bf16 path): {n_params}", flush=True)

    lap("models")
    # ----------------------------------------------------------------- agree
    rand_inputs = (
        torch.randn((2, 32, 32, 4), generator=gen, device=dev, dtype=bf16),
        torch.tensor([500.0, 500.0], device=dev),
        torch.randn((2, 77, 2048), generator=gen, device=dev, dtype=bf16),
        {"text_embeds": torch.randn((2, 1280), generator=gen, device=dev, dtype=bf16),
         "time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]] * 2, device=dev)})
    # a8w8 is checked on inputs like the calibration's (the first request's
    # prompt, the first timestep), which fill the recorded int8 ranges
    with torch.inference_mode():
        ctx_c, added_c, lat_c = pipe.prepare_inputs(REQUESTS[0][0], 256, 256, GUIDANCE, seed=0)
    t_c = pipe.scheduler.set_timesteps(STEPS).timesteps[0].to(dev).expand(2)
    calib_inputs = (torch.cat([lat_c, lat_c]).to(bf16), t_c, ctx_c, added_c)

    def unet(inputs, swaps=()):
        lat, t, ctx, added = inputs
        with torch.inference_mode(), swapped(swaps):
            return pipe.unet(lat, t, ctx, added_cond_kwargs=added).float()

    def agree(label, out_k, out_p, what, tol=AGREE_TOL):
        rel = rel_l2(out_k, out_p)
        print(f"[{label}] full-width UNet at 32x32 latents, {what}: relative L2 "
              f"{rel:.3e} (tol {tol}), |out| max {out_p.abs().max().item():.3f}",
              flush=True)
        check(bool(torch.isfinite(out_k).all()) and rel <= tol, f"{label}: relative L2 {rel}")

    agree("agree", unet(rand_inputs), unet(rand_inputs, plain_swaps(mods, int8=False)),
          "kernels vs plain")
    out_bf16 = unet(calib_inputs)

    lap("agree")
    # ----------------------------------------------------------------- serve
    counters = {"flash_attention": attn_mod.flash_attention,
                "flash_attention_int8": attn_mod.flash_attention_int8,
                "group_norm": norms_mod.group_norm,
                "group_norm_stats": norms_mod.group_norm_stats,
                "layer_norm": norms_mod.layer_norm,
                "int8_a8w8_matmul": conv_int8_mod.int8_a8w8_matmul,
                "int8_conv3x3_same": conv_int8_mod.int8_conv3x3_same,
                "fused_gn_silu_conv3x3": fused_mod.fused_gn_silu_conv3x3}

    def count(name):
        fn = counters.get(name, conv_int8_mod.int8_conv2d_plain)
        return fn.calls if name == "int8_conv2d_plain" else fn.launches

    names = list(counters) + ["int8_conv2d_plain"]

    def serve(label):
        expected = expected_launches(pipe, HEIGHT, WIDTH, STEPS, guidance_scale=GUIDANCE)
        expected = {name: expected.get(name, 0) for name in names}
        print(f"[{label}] expected launches per request (walking the blocks): {expected}")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        conv_int8_mod.int8_conv2d_plain.calls = 0
        seconds = []
        for prompt, seed in REQUESTS:
            before = {name: count(name) for name in names}
            t0 = time.perf_counter()
            image = pipe(prompt, height=HEIGHT, width=WIDTH, num_inference_steps=STEPS,
                         guidance_scale=GUIDANCE, seed=seed, output_type="np")[0]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            got = {name: count(name) - before[name] for name in names}
            print(f"[{label}] seed {seed}: {seconds[-1]:.3f} s | image {image.shape} finite "
                  f"{bool((image == image).all())} range [{image.min():.3f}, "
                  f"{image.max():.3f}] mean {image.mean():.3f} std {image.std():.3f} | "
                  f"launches {got}", flush=True)
            check(image.shape == (1, HEIGHT, WIDTH, 3), f"image shape {image.shape}")
            check(bool(torch.isfinite(torch.from_numpy(image)).all()), "image not finite")
            check(image.min() >= 0.0 and image.max() <= 1.0, "image outside [0, 1]")
            check(got == expected, f"{label}: launches {got} != expected {expected}")
        launches = {name: count(name) for name in names}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{label}] peak memory allocated {peak:.2f} GiB | launches over "
              f"{len(REQUESTS)} requests {launches}", flush=True)
        return launches, seconds, peak

    launches_bf16, s_bf16, peak_bf16 = serve("serve")

    lap("serve")
    # ------------------------------------------------------------- calibrate
    t0 = time.perf_counter()
    raw = calibrate_static_a8w8(pipe, REQUESTS[0][0], HEIGHT, WIDTH, STEPS, GUIDANCE, seed=0)
    torch.cuda.synchronize()
    n_unet = len(quant_mod.quant_modules(pipe.unet))
    print(f"[calibrate] {len(raw)} scales ({n_unet} UNet + {len(raw) - n_unet} VAE) recorded "
          f"and loaded in {time.perf_counter() - t0:.1f} s; raw absmax min {min(raw):.3f} "
          f"max {max(raw):.3f}", flush=True)
    check(n_unet == 771 and len(raw) == 771 + 33, f"calibrate: {len(raw)} scales")

    lap("calibrate")
    # ------------------------------------------------------------ a8w8 agree
    out_a8w8 = unet(calib_inputs)
    agree("a8w8 agree", out_a8w8, unet(calib_inputs, plain_swaps(mods, bf16=False)),
          "int8 kernels (B2, B3, B5) vs their plain versions, on calibration-like inputs",
          A8W8_AGREE_TOL)
    # the controls: one int8 wrapper at a time runs its plain version without
    # the activation quantize; each must fail the limit above
    for mod, name, plain in plain_swaps(mods, bf16=False):
        rel = rel_l2(unet(calib_inputs, [(mod, name, unquantized(mods, plain))]), out_a8w8)
        print(f"[a8w8 agree] control: {name} without its quantize step: relative L2 "
              f"{rel:.3e} (must exceed {A8W8_AGREE_TOL})", flush=True)
        check(rel > A8W8_AGREE_TOL, f"a8w8 agree: the {name} control passes the limit ({rel})")
    # every op requantizes its input, so a bf16 rounding difference upstream
    # (flash, GroupNorm) can move an int8 value by a whole step downstream
    all_plain = unet(calib_inputs, plain_swaps(mods))
    print(f"[a8w8 agree] not gated: all five kernels vs plain: relative L2 "
          f"{rel_l2(out_a8w8, all_plain):.3e}; a8w8 vs bf16 UNet (random weights): "
          f"{rel_l2(out_a8w8, out_bf16):.3e}", flush=True)

    lap("a8w8 agree")
    # ------------------------------------------------------------ a8w8 serve
    launches_a8w8, s_a8w8, peak_a8w8 = serve("a8w8 serve")
    print(f"[a8w8 serve] seconds per request a8w8 {[round(x, 3) for x in s_a8w8]} vs bf16 "
          f"{[round(x, 3) for x in s_bf16]} (same run); peak memory a8w8 {peak_a8w8:.2f} GiB "
          f"vs bf16 {peak_bf16:.2f} GiB", flush=True)

    lap("a8w8 serve")
    # ------------------------------------------------------ a8w8 int8-attn
    int8_attention_kernels(torch, F, dev, gen, record, attn_mod)
    os.environ["PMIX_INT8_ATTN"] = "1"  # JAX's switch: every inference flash call takes int8 QK^T
    prompt, seed = REQUESTS[0]
    # int8-attn agree: one full-width a8w8 UNet forward at the request's size
    # (the first request's prompt and timestep), each of its int8 attention
    # calls held per element against the plain version on its own inputs;
    # the forward passes if every call does. The UNet's output cannot gate
    # this: any rounding change in attention moves this random-weight a8w8
    # UNet by 7.4e-2 relative L2, the truncation control no more
    # (tools/probe_torch_int8_attn_agree.py)
    with torch.inference_mode():
        ctx_f, added_f, lat_f = pipe.prepare_inputs(prompt, HEIGHT, WIDTH, GUIDANCE, seed=seed)
    full_inputs = (torch.cat([lat_f, lat_f]).to(bf16), t_c, ctx_f, added_f)
    with checked_int8_calls(torch, attn_mod, INT8_ATTN_PATH_SUM) as calls:
        out_i8 = unet(full_inputs)
    worst = max(r[2] for r in calls)
    control_least = min(r[4] for r in calls)
    control_most = max(r[4] for r in calls)
    by_shape = collections.Counter(r[0] for r in calls)
    print(f"[a8w8 int8-attn agree] full-width a8w8 UNet at {HEIGHT // 8}x{WIDTH // 8} latents: "
          f"{len(calls)} int8 attention calls {dict(by_shape)}, each per element against "
          f"the plain version on its own inputs: largest excess "
          f"{max(r[1] for r in calls):.3e} over 2**-7|ref| + {INT8_ATTN_PATH_SUM:g}|ref|max "
          f"(least c {worst:.2e}); truncation control: largest excess "
          f"{max(r[3] for r in calls):.3e} (must be > 0), least c {control_least:.2e} "
          f".. {control_most:.2e}, failing on "
          f"{sum(r[3] > 0 for r in calls)} calls", flush=True)
    check(bool(torch.isfinite(out_i8).all()), "a8w8 int8-attn agree: UNet output not finite")
    check(len(calls) == 70, f"a8w8 int8-attn agree: {len(calls)} int8 calls, not 70")
    check(all(r[1] <= 0 for r in calls), f"a8w8 int8-attn agree: least c {worst}")
    check(any(r[3] > 0 for r in calls),
          f"a8w8 int8-attn agree: the control passes on every call (least c {control_most})")
    del out_i8, full_inputs, ctx_f, added_f, lat_f

    # the request: counts set to 0 just before it, read just after
    want = expected_launches(pipe, HEIGHT, WIDTH, STEPS, guidance_scale=GUIDANCE)
    want = {name: want.get(name, 0) for name in names}
    for fn in counters.values():
        fn.launches = 0
    conv_int8_mod.int8_conv2d_plain.calls = 0
    t0 = time.perf_counter()
    image_i8 = pipe(prompt, height=HEIGHT, width=WIDTH, num_inference_steps=STEPS,
                    guidance_scale=GUIDANCE, seed=seed, output_type="np")[0]
    torch.cuda.synchronize()
    s_i8attn = time.perf_counter() - t0
    launches_i8attn = {name: count(name) for name in names}
    del os.environ["PMIX_INT8_ATTN"]
    print(f"[a8w8 int8-attn] seed {seed}: {s_i8attn:.3f} s (a8w8 with bf16 attention "
          f"{[round(x, 3) for x in s_a8w8]}) | image {image_i8.shape} range "
          f"[{image_i8.min():.3f}, {image_i8.max():.3f}] mean {image_i8.mean():.3f} | launches "
          f"{launches_i8attn} (expected {want})", flush=True)
    check(image_i8.shape == (1, HEIGHT, WIDTH, 3), f"a8w8 int8-attn: image shape {image_i8.shape}")
    check(bool(np.isfinite(image_i8).all()) and image_i8.min() >= 0.0 and image_i8.max() <= 1.0,
          "a8w8 int8-attn: image not finite in [0, 1]")
    check(launches_i8attn == want and want["flash_attention_int8"] == 1750
          and want["flash_attention"] == 0, f"a8w8 int8-attn: launches {launches_i8attn} != "
          f"expected {want}")

    lap("a8w8 int8-attn")
    # ------------------------------------------------------ free the pipeline
    del image_i8
    del pipe, out_bf16, out_a8w8, all_plain, rand_inputs, calib_inputs, ctx_c, added_c, lat_c
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[llava] SDXL pipeline freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"still allocated", flush=True)
    from paddlemix_tpu_torch.models.llama import modeling as llama_mod
    from paddlemix_tpu_torch.models.llava import (
        bench_input_ids,
        expected_launches_llava,
        random_llava,
    )
    from paddlemix_tpu_torch.ops import decode_attention as da_mod

    lap("free the pipeline")
    # --------------------------------------------------------- llava kernels
    for m, k, n in WINT8_SHAPES + [WINT8_RAGGED]:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        wq, scale = quant_mod.quantize_weights_int8(w)
        w16 = w.to(bf16)
        del w
        out = quant_mod.wint8_matmul(x, wq, scale)
        torch.cuda.synchronize()
        ref = quant_mod.wint8_matmul_ref(x, wq, scale).float()
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        excess = (diff - WINT8_ULP * ref.abs() - WINT8_SUM * ref.abs().max()).max().item()
        print(f"[llava kernels] wint8_matmul {(m, k, n)}: max_abs_err {err:.3e} (limit "
              f"{WINT8_ULP:.4g}|ref| + {WINT8_SUM:g}|ref|max, excess {excess:.3e})", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"wint8_matmul {(m, k, n)}: err {err}")
        ms, plain_ms = timed_pair(
            torch, cold(lambda wq_: quant_mod.wint8_matmul(x, wq_, scale), wq, wq.numel()),
            cold(lambda wq_: quant_mod.wint8_matmul_ref(x, wq_, scale), wq, wq.numel()))
        lib_ms = library_ms(torch, cold(lambda w_: torch.matmul(x, w_.t()), w16,
                                        2 * w16.numel()))
        record("llava kernels", "wint8_matmul", (m, k, n), err, ms, plain_ms, lib_ms,
               bound(nbytes(x, wq, scale, out), 2 * m * n * k, "bf16"))
        summary["wint8_matmul"][-1].update(gemm_note("llava kernels", "wint8_matmul", "wint8",
                                                     (m, k, n), ms, 2 * m * n * k, "TFLOP/s"))
        del x, wq, scale, w16, out, ref, diff
        gc.collect()
    # N1 / N2: the activation pass alone, bit for bit, at the prefill's rows
    for m, k in ((608, 4096), (608, 11008)):
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        x[1] = 0  # a zero row quantizes to zeros
        xq, sx = quant_mod.quantize_rows_int8_cuda(x)
        torch.cuda.synchronize()
        rq, rs = quant_mod.quantize_rows_int8(x)
        miss = (xq != rq).sum().item() + (sx != rs).sum().item()
        pass_ms = cuda_ms(torch, lambda: quant_mod.quantize_rows_int8_cuda(x))
        print(f"[llava kernels] a8w activation pass {(m, k)}: {miss} elements apart from "
              f"quantize_rows_int8 (must be 0); {pass_ms:.4f} ms, bound "
              f"{bound(3 * m * k + 4 * m, 0, 'int8')[0]:.4f} ms (bytes)", flush=True)
        check(miss == 0, f"a8w activation pass {(m, k)}: {miss} elements apart")
    try:  # the library's s8 GEMM takes no single row: why the decode needs N1's GEMV
        torch._int_mm(torch.zeros((1, 4096), dtype=torch.int8, device=dev),
                      torch.zeros((4096, 4096), dtype=torch.int8, device=dev))
        int_mm_one_row = "torch._int_mm took a single row"
    except (RuntimeError, ValueError) as exc:
        int_mm_one_row = f"torch._int_mm refuses a single row: {str(exc).splitlines()[0]}"
    print(f"[llava kernels] {int_mm_one_row}", flush=True)
    for qmode in LLAVA_QUANT_MODES:
        name = f"{qmode}_matmul"
        wrapper, plain = getattr(quant_mod, name), getattr(quant_mod, f"{name}_ref")
        quantizer = (quant_mod.quantize_weights_int4 if qmode == "a8w4"
                     else quant_mod.quantize_weights_int8)
        for m, k, n in A8W_SHAPES + [A8W_RAGGED[qmode]]:
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
            wq, scale = quantizer(w)
            w16 = w.to(bf16)
            wq8, scale8 = quant_mod.quantize_weights_int8(w)  # B6's weights, the yardstick
            del w
            out = wrapper(x, wq, scale)
            torch.cuda.synchronize()
            ref = plain(x, wq, scale)
            miss = (out != ref).sum().item()
            err = (out.float() - ref.float()).abs().max().item()
            if qmode == "a8w8":
                after = torch.randn((1, k), generator=gen, device=dev).to(bf16)
                control = neighbour_sx_control(torch, quant_mod, x, wq, scale, after)
                what = "each row quantized with its neighbour's sx"
            else:
                control = swapped_halves_control(torch, quant_mod, x, wq, scale)
                what = "the nibble halves swapped"
            c_miss = (control != out).sum().item()
            print(f"[llava kernels] {name} {(m, k, n)}: {miss} of {out.numel()} elements apart "
                  f"from the plain version (gate: 0), max_abs_err {err:.3e}; control ({what}): "
                  f"{c_miss} apart (must be > 0)", flush=True)
            check(bool(torch.isfinite(out).all()) and miss == 0,
                  f"{name} {(m, k, n)}: {miss} elements apart")
            check(c_miss > 0, f"{name} {(m, k, n)}: the control passes the gate")
            ms, plain_ms = timed_pair(
                torch, cold(lambda wq_: wrapper(x, wq_, scale), wq, wq.numel()),
                cold(lambda wq_: plain(x, wq_, scale), wq, wq.numel()))
            lib_ms = library_ms(torch, cold(lambda w_: torch.matmul(x, w_.t()), w16,
                                            2 * w16.numel()))
            b6_ms = library_ms(torch, cold(lambda wq_: quant_mod.wint8_matmul(x, wq_, scale8),
                                           wq8, wq8.numel()))
            yard = f"bf16 torch.matmul {lib_ms:.4f} ms, B6 wint8_matmul {b6_ms:.4f} ms"
            int_mm = None
            if m > 16:  # torch._int_mm on x quantized beforehand, int32 out, no scales
                xq, _ = quant_mod.quantize_rows_int8(x)
                wt = (quant_mod.unpack_int4(wq) if qmode == "a8w4" else wq).t()
                int_mm = library_ms(torch, lambda: torch._int_mm(xq, wt))
                yard += f", torch._int_mm {int_mm:.4f} ms"
                del xq, wt
            record("llava kernels", name, (m, k, n), err, ms, plain_ms, lib_ms,
                   bound(nbytes(x, wq, scale, out), 2 * m * n * k, "int8"))
            core, note = a8w_core(qmode, m, k, n)
            print(f"[llava kernels]   {name} {(m, k, n)}: core {core} ({note}) | "
                  f"{2 * m * n * k / ms / 1e9:.1f} TOP/s of the bound's {2 * m * n * k:.4g} "
                  f"operations | yardsticks: {yard}", flush=True)
            summary[name][-1].update(core=core, tflops=2 * m * n * k / ms / 1e9,
                                     wint8_ms=b6_ms, int_mm_ms=int_mm)
            del x, wq, scale, w16, wq8, scale8, out, ref, control
            gc.collect()
    m, k, n = A8W_RAGGED["a8w8"]  # N2's refusal of a packed row of no whole 16 bytes
    x = torch.zeros((m, k), dtype=bf16, device=dev)
    try:
        quant_mod.a8w4_matmul(x, torch.zeros((n, k // 2), dtype=torch.int8, device=dev),
                              torch.ones(n, device=dev))
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    print(f"[llava kernels] a8w4_matmul {(m, k, n)} refused: {refused}", flush=True)
    check("K % 32 == 0" in refused, f"a8w4_matmul {(m, k, n)} was not refused")
    del x
    decode_kernels(torch, F, dev, gen, record, da_mod)
    row_norm_checks(torch, dev, gen, norms_mod)
    rms_kernels(torch, F, dev, gen, record, norms_mod)

    lap("llava kernels")
    # ----------------------------------------------------------- llava agree
    t0 = time.perf_counter()
    model = random_llava(dev, bf16, seed=0)
    torch.cuda.synchronize()
    cfg = model.config
    n_params = {name: sum(p.numel() for p in getattr(model, name).parameters())
                for name in ("vision_tower", "multi_modal_projector", "language_model")}
    print(f"[llava] LLaVA-1.5-7B built on the card in {time.perf_counter() - t0:.1f} s: "
          f"{n_params}, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)
    ids = bench_input_ids(cfg, device=dev)
    prompt_len = ids.shape[1]
    isz = cfg.vision.image_size
    pixels = [torch.randn((1, isz, isz, 3), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(s))
              for s in LLAVA_REQUESTS]

    def llava_steps(swaps=(), tokens=None):
        """Prefill logits (prompt_len, vocab) and the logits of the next decode
        steps, fed `tokens` or, when None, the greedy ones (returned)."""
        toks = [] if tokens is None else tokens
        with torch.inference_mode(), swapped(swaps):
            cache = model.init_cache(1, prompt_len + LLAVA_AGREE_STEPS)
            logits, cache = model(ids, pixels[0], torch.arange(prompt_len, device=dev)[None],
                                  cache=cache)
            outs = [logits[0].float()]
            for i in range(LLAVA_AGREE_STEPS):
                if tokens is None:
                    toks.append(outs[-1][-1].argmax())
                step, cache = model(toks[i].view(1, 1), None, cache.lengths[:, None],
                                    cache=cache)
                outs.append(step[0].float())
        return outs[0], torch.cat(outs[1:]), toks

    def llava_agree(label, quant=None):
        """The kernels (and under `quant` its GEMM: B6, N1 or N2) against their
        plain versions swapped in; returns the greedy tokens of the kernels' run."""
        swaps = [(llama_mod, "rms_norm", norms_mod.rms_norm_ref),
                 (llama_mod, "decode_attention", da_mod.decode_attention_ref),
                 (norms_mod, "_ln_forward", norms_mod.layer_norm_ref)]  # the ViT's B10
        if quant is not None:
            gemm = {"wint8": "wint8_matmul", "a8w8": "a8w8_matmul"}.get(quant, "a8w4_matmul")
            swaps.append((llama_mod, gemm, getattr(quant_mod, f"{gemm}_ref")))
        pre_k, dec_k, toks = llava_steps()
        pre_p, dec_p, _ = llava_steps(swaps, toks)
        rel_pre, rel_dec = rel_l2(pre_k, pre_p), rel_l2(dec_k, dec_p)
        print(f"[{label}] full-width LLaVA, kernels ({', '.join(n for _, n, _ in swaps)}) vs "
              f"plain: relative L2 of the logits, prefill ({prompt_len} tokens) {rel_pre:.3e}, "
              f"{LLAVA_AGREE_STEPS} decode steps {rel_dec:.3e} (tol {LLAVA_AGREE_TOL}); |logits| "
              f"max {pre_p.abs().max().item():.3f}; greedy tokens {[int(t) for t in toks]}",
              flush=True)
        check(bool(torch.isfinite(pre_k).all() and torch.isfinite(dec_k).all())
              and rel_pre <= LLAVA_AGREE_TOL and rel_dec <= LLAVA_AGREE_TOL,
              f"{label}: relative L2 {rel_pre} / {rel_dec}")
        return [int(t) for t in toks]

    llava_counters = {"rms_norm": norms_mod.rms_norm, "decode_attention": da_mod.decode_attention,
                      "wint8_matmul": quant_mod.wint8_matmul,
                      "a8w8_matmul": quant_mod.a8w8_matmul, "a8w4_matmul": quant_mod.a8w4_matmul,
                      "flash_attention": attn_mod.flash_attention,
                      "layer_norm": norms_mod.layer_norm}

    def llava_serve(label):
        """The bench's requests: TTFT is a 1-token generate, then the full
        generate; tokens/s = (new tokens - 1) / (full - TTFT), as bench.py."""
        want = expected_launches_llava(model, prompt_len, LLAVA_NEW_TOKENS)
        want_1 = expected_launches_llava(model, prompt_len, 1)
        print(f"[{label}] expected launches per request (walking the modules): {want}; "
              f"TTFT run {want_1}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        for fn in llava_counters.values():
            fn.launches = 0
        stats = []
        for seed, px in zip(LLAVA_REQUESTS, pixels):
            runs = []
            for n_new, expected in ((1, want_1), (LLAVA_NEW_TOKENS, want)):
                before = {name: fn.launches for name, fn in llava_counters.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = model.generate(ids, px, max_new_tokens=n_new, eos_token_id=-1)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0, toks))
                got = {name: fn.launches - before[name] for name, fn in llava_counters.items()}
                check(got == expected, f"{label}: launches {got} != expected {expected}")
            (ttft, first), (total, toks) = runs
            tps = (LLAVA_NEW_TOKENS - 1) / (total - ttft)
            stats.append((ttft, total, tps))
            print(f"[{label}] pixels seed {seed}: TTFT {1e3 * ttft:.1f} ms | {LLAVA_NEW_TOKENS} "
                  f"tokens {total:.3f} s | decode {tps:.2f} tokens/s "
                  f"({1e3 / tps:.2f} ms/token) | tokens {toks[0, :8].tolist()}...", flush=True)
            check(toks.shape == (1, LLAVA_NEW_TOKENS) and toks.dtype == torch.int32,
                  f"{label}: tokens {tuple(toks.shape)} {toks.dtype}")
            check(bool(((toks >= 0) & (toks < cfg.text.vocab_size)).all()),
                  f"{label}: a token outside the vocab")
            check(int(toks[0, 0]) == int(first[0, 0]), f"{label}: the first token differs "
                  f"between the TTFT run and the full run")
        launches = {name: fn.launches for name, fn in llava_counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{label}] peak memory allocated {peak:.2f} GiB | launches over "
              f"{len(LLAVA_REQUESTS)} requests {launches}", flush=True)
        return launches, stats, peak

    llava_agree("llava agree")
    launches_llava, stats_llava, peak_llava = llava_serve("llava serve")

    lap("llava agree")
    # ---------------------------------------------------- quantized: wint8
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    freed = model.quantize_("wint8")
    torch.cuda.synchronize()
    print(f"[wint8] quantized in place in {time.perf_counter() - t0:.2f} s: {freed / 1e9:.3f} "
          f"GB of weights freed; allocated {allocated / 2 ** 30:.2f} -> "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    llava_agree("wint8 agree", "wint8")
    launches_wint8, stats_wint8, peak_wint8 = llava_serve("wint8 serve")
    med = lambda stats, i: sorted(s_[i] for s_ in stats)[len(stats) // 2]  # noqa: E731
    print(f"[wint8 serve] median decode tokens/s wint8 {med(stats_wint8, 2):.2f} vs bf16 "
          f"{med(stats_llava, 2):.2f}; TTFT wint8 {1e3 * med(stats_wint8, 0):.1f} ms vs bf16 "
          f"{1e3 * med(stats_llava, 0):.1f} ms; peak memory wint8 {peak_wint8:.2f} GiB vs "
          f"bf16 {peak_llava:.2f} GiB (same run)", flush=True)

    lap("quantized: wint8")
    # ------------------------------------------------ quantized: a8w8, a8w4
    # quantizing frees the bf16 weights: each mode builds a fresh seeded model
    launches_q, stats_q = {}, {}
    lm_bf16_bytes = 2 * sum(m_.in_features * m_.out_features
                            for m_ in model.language_model.modules()
                            if isinstance(m_, llama_mod.MXUDense))
    for mode in LLAVA_QUANT_MODES + ("wint4",):
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = random_llava(dev, bf16, seed=0, quant=mode)
        torch.cuda.synchronize()
        dense = [m_ for m_ in model.language_model.modules() if isinstance(m_, llama_mod.MXUDense)]
        q_bytes = sum(nbytes(m_.kernel_q, m_.scale) for m_ in dense)
        print(f"[{mode}] random_llava(quant={mode!r}) built and quantized in "
              f"{time.perf_counter() - t0:.1f} s: {len(dense)} projections, weights "
              f"{q_bytes / 1e9:.3f} GB against bf16's {lm_bf16_bytes / 1e9:.3f} GB "
              f"({q_bytes / lm_bf16_bytes:.3f}x); {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
              f"GiB allocated; config quant {model.config.text.quant!r}", flush=True)
        check(all(m_.quant == mode for m_ in dense) and model.config.text.quant == mode,
              f"{mode}: a projection left unquantized")
        if mode == "wint4":  # a8w4's path: N2 launched, the same greedy tokens bit for bit
            before = quant_mod.a8w4_matmul.launches
            toks = llava_agree("wint4 agree", mode)
            n2 = quant_mod.a8w4_matmul.launches - before
            print(f"[wint4 agree] {n2} N2 launches in the kernels' run; greedy tokens "
                  f"{toks} against a8w4's {toks_a8w4}", flush=True)
            check(n2 > 0 and toks == toks_a8w4, "wint4: N2 not launched or tokens differ")
            continue
        toks = llava_agree(f"{mode} agree", mode)
        if mode == "a8w4":
            toks_a8w4 = toks
        launches_q[mode], stats_q[mode], peak = llava_serve(f"{mode} serve")
        print(f"[{mode} serve] median decode tokens/s {mode} {med(stats_q[mode], 2):.2f} vs wint8 "
              f"{med(stats_wint8, 2):.2f} vs bf16 {med(stats_llava, 2):.2f}; TTFT {mode} "
              f"{1e3 * med(stats_q[mode], 0):.1f} ms vs bf16 {1e3 * med(stats_llava, 0):.1f} ms; "
              f"peak memory {mode} {peak:.2f} GiB vs bf16 {peak_llava:.2f} GiB (same run)",
              flush=True)

    lap("quantized: a8w8, a8w4")
    # ------------------------------------------------------ free the LLaVA model
    del model, pixels, ids
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[sd3] LLaVA freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          f"allocated", flush=True)
    from paddlemix_tpu_torch.diffusers.models import transformer_sd3 as sd3_mod
    from paddlemix_tpu_torch.diffusers.sd3 import (
        expected_launches_sd3,
        random_sd3_pipeline,
        seeded_t5_tokenizer,
    )

    lap("free the LLaVA model")
    # ----------------------------------------------------------- sd3 kernels
    for shape in ADALN_SHAPES:
        b_, s_, h_ = shape
        # x and the residual rotate together through cold copies; the
        # modulation vectors are chunks of one (B, 6H) projection, as in a block
        rx = torch.randn((2,) + shape, generator=gen, device=dev).mul_(2.0).to(bf16)
        mod = torch.randn((b_, 6 * h_), generator=gen, device=dev).to(bf16)
        shift, scale, gate = mod.chunk(6, dim=-1)[:3]
        x = rx[1]
        out = norms_mod.adaptive_layer_norm(x, scale, shift)
        torch.cuda.synchronize()
        ref = norms_mod.adaptive_layer_norm_ref(x, scale, shift)
        err = (out.float() - ref.float()).abs().max().item()
        excess, need = ulp_gate(out, ref, ADALN_SUM)
        control, _ = ulp_gate(norms_mod.adaptive_layer_norm_ref(x, scale, 0 * shift), ref,
                              ADALN_SUM)
        print(f"[sd3 kernels] adaptive_layer_norm {shape} bf16: max_abs_err {err:.3e}, excess "
              f"{excess:.3e} over 2**-7|ref| + {ADALN_SUM:g}|ref|max (least c {need:.2e}); "
              f"control without the shift: excess {control:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"adaptive_layer_norm {shape}: excess {excess}")
        check(control > 0, f"adaptive_layer_norm {shape}: the control passes ({control})")
        kernel = cold(lambda t: norms_mod.adaptive_layer_norm(t[1], scale, shift), rx, nbytes(rx))
        ms, plain_ms = timed_pair(
            torch, kernel,
            cold(lambda t: norms_mod.adaptive_layer_norm_ref(t[1], scale, shift), rx, nbytes(rx)))
        lib_ms = library_ms(torch, cold(lambda t: F.layer_norm(t[1], (h_,), eps=1e-5), rx,
                                        nbytes(rx)))
        plan = norms_mod.adaln_plan_of(x, scale, shift)
        floor = floor_ms(torch, norms_mod, b_ * plan.nb, plan.threads, kernel.copies)
        # a few fp32 operations an element (moments, normalise, modulate)
        record("sd3 kernels", "adaptive_layer_norm", shape, err, ms, plain_ms, lib_ms,
               bound(nbytes(x, scale, shift, out), 8 * x.numel(), "fp32"),
               f" (library: F.layer_norm, the norm alone) | {plan}", floor=floor)

        residual = rx[0]
        y, resi = norms_mod.fused_adaln_scale_residual(residual, x, gate, scale, shift)
        torch.cuda.synchronize()
        ref_y, ref_resi = norms_mod.fused_adaln_scale_residual_ref(residual, x, gate, scale,
                                                                   shift)
        err = max((y.float() - ref_y.float()).abs().max().item(),
                  (resi.float() - ref_resi.float()).abs().max().item())
        (ex_y, need_y), (ex_r, need_r) = (ulp_gate(y, ref_y, ADALN_SUM),
                                          ulp_gate(resi, ref_resi, ADALN_SUM))
        ungated = norms_mod.fused_adaln_scale_residual_ref(residual, x, torch.ones_like(gate),
                                                           scale, shift)
        control = max(ulp_gate(ungated[0], ref_y, ADALN_SUM)[0],
                      ulp_gate(ungated[1], ref_resi, ADALN_SUM)[0])
        print(f"[sd3 kernels] fused_adaln_scale_residual {shape} bf16: max_abs_err {err:.3e}, "
              f"excess y {ex_y:.3e} resi {ex_r:.3e} (least c {max(need_y, need_r):.2e}); "
              f"control without the gate: excess {control:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(y).all() and torch.isfinite(resi).all())
              and max(ex_y, ex_r) <= 0, f"fused_adaln_scale_residual {shape}: {ex_y}, {ex_r}")
        check(control > 0, f"fused_adaln_scale_residual {shape}: the control passes ({control})")
        kernel = cold(lambda t: norms_mod.fused_adaln_scale_residual(t[0], t[1], gate, scale,
                                                                     shift), rx, nbytes(rx))
        ms, plain_ms = timed_pair(
            torch, kernel,
            cold(lambda t: norms_mod.fused_adaln_scale_residual_ref(t[0], t[1], gate, scale,
                                                                    shift), rx, nbytes(rx)))
        plan = norms_mod.fused_adaln_plan_of(residual, x, gate, scale, shift)
        floor = floor_ms(torch, norms_mod, b_ * plan.nb, plan.threads, kernel.copies)
        # the residual and x read, as many bytes written: one copy_ of both
        copy = cuda_ms(torch, cold(lambda t: torch.empty_like(t).copy_(t), rx, nbytes(rx)))
        # no single PyTorch call computes the gated residual and the adaLN
        record("sd3 kernels", "fused_adaln_scale_residual", shape, err, ms, plain_ms, None,
               bound(nbytes(rx, gate, scale, shift, y, resi), 10 * x.numel(), "fp32"),
               f" | {norm_kernel_note(norms_mod, plan, norms_mod.OP_FUSED)}", floor=floor,
               copy=copy)
        del rx, mod, out, ref, y, resi, ref_y, ref_resi, ungated
    adaln_extra_cases(torch, dev, gen, norms_mod)
    flash_case("sd3 kernels", SD3_FLASH_SHAPE)
    gc.collect()
    torch.cuda.empty_cache()

    lap("sd3 kernels")
    # ------------------------------------------------------------- sd3 agree
    t0 = time.perf_counter()
    sd3 = random_sd3_pipeline(dev, bf16, seed=0, tokenizer_3=seeded_t5_tokenizer(SD3_T5_SEED))
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(sd3, name).parameters())
                for name in ("transformer", "text_encoder", "text_encoder_2", "text_encoder_3",
                             "vae")}
    print(f"[sd3] SD3-medium built on the card in {time.perf_counter() - t0:.1f} s: {n_params}, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)
    sd3_inputs = (torch.randn((2, 64, 64, 16), generator=gen, device=dev),
                  sd3.scheduler.set_timesteps(SD3_STEPS).timesteps[:2].to(dev),
                  torch.randn((2, 154, 4096), generator=gen, device=dev, dtype=bf16),
                  torch.randn((2, 2048), generator=gen, device=dev, dtype=bf16))

    def sd3_forward(swaps=()):
        lat, t, ctx, pooled = sd3_inputs
        with torch.inference_mode(), swapped(swaps):
            return sd3.transformer(lat.to(bf16), t, ctx, pooled).float()

    sd3_swaps = [(sd3_mod, "adaptive_layer_norm", norms_mod.adaptive_layer_norm_ref),
                 (sd3_mod, "fused_adaln_scale_residual", norms_mod.fused_adaln_scale_residual_ref),
                 (attn_mod, "flash_attention", lambda q, k, v, **kw: attn_mod.flash_attention_ref(
                     q, k, v, scale=kw.get("scale")))]
    out_k, out_p = sd3_forward(), sd3_forward(sd3_swaps)
    rel = rel_l2(out_k, out_p)
    print(f"[sd3 agree] full-width SD3 transformer at 64x64 latents (1,024 image + 154 text "
          f"tokens, flash), kernels (adaLN, fused adaLN + residual, flash) vs plain: relative "
          f"L2 {rel:.3e} (tol {AGREE_TOL}), |out| max {out_p.abs().max().item():.3f}", flush=True)
    check(bool(torch.isfinite(out_k).all()) and rel <= AGREE_TOL, f"sd3 agree: relative L2 {rel}")
    del out_k, out_p, sd3_inputs

    lap("sd3 agree")
    # ------------------------------------------------------------- sd3 serve
    all_counters = dict(counters, **llava_counters,
                        adaptive_layer_norm=norms_mod.adaptive_layer_norm,
                        fused_adaln_scale_residual=norms_mod.fused_adaln_scale_residual,
                        decode_attention_int8=da_mod.decode_attention_int8,
                        paged_decode_attention=pa_mod.paged_decode_attention)
    want = expected_launches_sd3(sd3, HEIGHT, WIDTH, SD3_STEPS, SD3_GUIDANCE)
    want = {name: want.get(name, 0) for name in all_counters}
    print(f"[sd3 serve] expected launches per request (walking the modules): {want}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    for fn in all_counters.values():
        fn.launches = 0
    s_sd3 = []
    for prompt, seed in SD3_REQUESTS:
        before = {name: fn.launches for name, fn in all_counters.items()}
        t0 = time.perf_counter()
        image = sd3(prompt, height=HEIGHT, width=WIDTH, num_inference_steps=SD3_STEPS,
                    guidance_scale=SD3_GUIDANCE, seed=seed, output_type="np")[0]
        torch.cuda.synchronize()
        s_sd3.append(time.perf_counter() - t0)
        got = {name: fn.launches - before[name] for name, fn in all_counters.items()}
        print(f"[sd3 serve] seed {seed}: {s_sd3[-1]:.3f} s | image {image.shape} finite "
              f"{bool(np.isfinite(image).all())} range [{image.min():.3f}, {image.max():.3f}] "
              f"mean {image.mean():.3f} std {image.std():.3f} | launches {got}", flush=True)
        check(image.shape == (1, HEIGHT, WIDTH, 3), f"sd3 image shape {image.shape}")
        check(bool(np.isfinite(image).all()), "sd3 image not finite")
        check(image.min() >= 0.0 and image.max() <= 1.0, "sd3 image outside [0, 1]")
        check(got == want, f"sd3 serve: launches {got} != expected {want}")
    launches_sd3 = {name: fn.launches for name, fn in all_counters.items()}
    peak_sd3 = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[sd3 serve] peak memory allocated {peak_sd3:.2f} GiB | seconds per request "
          f"{[round(x, 3) for x in s_sd3]} | launches over {len(SD3_REQUESTS)} requests "
          f"{launches_sd3}", flush=True)

    lap("sd3 serve")
    # ------------------------------------------------------- free SD3-medium
    del sd3
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[llama] SD3 freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          f"allocated", flush=True)
    from paddlemix_tpu_torch.models.llama import (
        Int8KVCache,
        KVCache,
        LlamaForCausalLM,
        PagedKVCache,
        blocks_needed,
        expected_launches_llama,
        greedy_generate,
        int8kv_request,
        llama2_7b_config,
        paged_batch,
        paged_greedy_generate,
        random_llama,
    )
    from paddlemix_tpu_torch.models.llama import llama7b

    with torch.device("meta"):  # the launch walk needs the modules, not their weights
        meta_llama = LlamaForCausalLM(llama2_7b_config())
    per_request = {
        "decode_attention_int8": expected_launches_llama(
            meta_llama, [llama7b.INT8KV_PROMPT_LEN], llama7b.INT8KV_NEW_TOKENS,
            "int8")["decode_attention_int8"],
        "paged_decode_attention": expected_launches_llama(
            meta_llama, llama7b.PAGED_PROMPT_LENS, llama7b.PAGED_NEW_TOKENS,
            "paged")["paged_decode_attention"]}
    paged_bs = llama7b.PAGED_BLOCK_SIZE

    lap("free SD3-medium")
    # --------------------------------------------------------- llama kernels
    int8_decode_kernels(torch, F, dev, gen, record, da_mod, llama_mod._quantize_kv,
                        per_request["decode_attention_int8"])
    for b_, h_, kvh, d, bs, lengths in PAGED_CASES:
        if lengths is None:  # the paged batch's last decode step
            lengths = tuple(n + llama7b.PAGED_NEW_TOKENS - 1 for n in llama7b.PAGED_PROMPT_LENS)
        owned = [-(-n // bs) for n in lengths]
        nb_max = max(owned) + 1
        # the pool's blocks handed out in a random order, as a fragmented pool's
        ids = torch.randperm(sum(owned), generator=torch.Generator().manual_seed(b_)).tolist()
        tables = torch.full((b_, nb_max), -1, dtype=torch.int32)
        for i, n in enumerate(owned):
            tables[i, :n] = torch.tensor(ids[sum(owned[:i]):sum(owned[:i + 1])])
        # the control: each sequence's last block dropped where it is partly filled
        ctrl_tables, ctrl_lens = tables.clone(), list(lengths)
        for i, n in enumerate(lengths):
            if n % bs:
                ctrl_tables[i, owned[i] - 1] = -1
                ctrl_lens[i] = n - n % bs
        tables, ctrl_tables = tables.to(dev), ctrl_tables.to(dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ctrl_lens = torch.tensor(ctrl_lens, dtype=torch.int32, device=dev)
        pool = torch.randn((2, sum(owned) + 1, kvh, bs, d), generator=gen, device=dev).to(bf16)
        q = torch.randn((b_, h_, d), generator=gen, device=dev).to(bf16)
        out = pa_mod.paged_decode_attention(q, pool[0], pool[1], tables, lens)
        torch.cuda.synchronize()
        ref = pa_mod.paged_decode_attention_ref(q.float(), pool[0], pool[1], tables, lens)
        err = (out.float() - ref).abs().max().item()
        excess, need = ulp_gate(out, ref, PAGED_SUM)
        control, _ = ulp_gate(pa_mod.paged_decode_attention_ref(q.float(), pool[0], pool[1],
                                                                ctrl_tables, ctrl_lens),
                              ref, PAGED_SUM)
        shape = (b_, h_, kvh, d, bs, lengths)
        print(f"[llama kernels] paged_decode_attention {shape}, a permuted pool of "
              f"{sum(owned)} blocks: max_abs_err {err:.3e}, excess {excess:.3e} over "
              f"2**-7|ref| + {PAGED_SUM:g}|ref|max (least c {need:.2e}); control without each "
              f"last, partly filled block: excess {control:.3e} (must be > 0)", flush=True)
        check(bool(torch.isfinite(out).all()) and excess <= 0,
              f"paged_decode_attention {shape}: excess {excess}")
        check(control > 0, f"paged_decode_attention {shape}: the control passes ({control})")
        ms, plain_ms = timed_pair(
            torch, cold(lambda p: pa_mod.paged_decode_attention(q, p[0], p[1], tables, lens), pool,
                        nbytes(pool)),
            cold(lambda p: pa_mod.paged_decode_attention_ref(q, p[0], p[1], tables, lens), pool,
                 nbytes(pool)))
        # (2, B, nb_max * bs, KVH, D): each sequence's blocks gathered densely
        dense = pool[:, tables.clamp(min=0).long()].transpose(3, 4).reshape(
            2, b_, nb_max * bs, kvh, d)
        mask = (torch.arange(nb_max * bs, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        qh = q[:, :, None]  # (B, H, 1, D)
        lib_ms = library_ms(torch, cold(lambda c: F.scaled_dot_product_attention(
            qh, c[0].transpose(1, 2), c[1].transpose(1, 2), attn_mask=mask,
            enable_gqa=h_ != kvh), dense, nbytes(dense)))
        used = sum(lengths)
        launches = per_request["paged_decode_attention"] if b_ == 8 else "-"
        record("llama kernels", "paged_decode_attention", shape, err, ms, plain_ms, lib_ms,
               bound(nbytes(q, tables, lens, out) + 2 * used * kvh * d * 2, 4 * h_ * used * d,
                     "fp32"),
               f" | {launches} launches a request | library: SDPA over the gathered bf16 "
               f"cache, gather not included")
        del pool, q, out, ref, dense
    gc.collect()
    torch.cuda.empty_cache()

    lap("llama kernels")
    # ---------------------------------------------------------- llama int8kv
    t0 = time.perf_counter()
    llama = random_llama(dev, bf16, seed=0, cachekv_int8=True)
    torch.cuda.synchronize()
    lcfg = llama.config
    print(f"[llama] Llama-2-7B built on the card in {time.perf_counter() - t0:.1f} s "
          f"(cachekv_int8): {sum(p.numel() for p in llama.parameters())} parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)

    def llama_steps(cache, ids, mask, swaps=(), tokens=None):
        """Prefill logits at the valid positions, the logits of the next
        decode steps fed `tokens` or, when None, the greedy ones (returned)."""
        toks = [] if tokens is None else tokens
        b = ids.shape[0]
        positions = torch.where(mask > 0, mask.cumsum(dim=-1) - 1, -1)
        with torch.inference_mode(), swapped(swaps):
            logits, cache = llama(ids, positions, cache=cache)
            outs = [logits[mask > 0].float()]
            nxt = logits[torch.arange(b, device=dev), mask.sum(dim=-1) - 1]
            del logits
            for i in range(LLAMA_AGREE_STEPS):
                if tokens is None:
                    toks.append(nxt.float().argmax(dim=-1).view(b, 1))
                step, cache = llama(toks[i], cache.lengths[:, None], cache=cache)
                nxt = step[:, -1]
                outs.append(nxt.float())
        return outs[0], torch.cat(outs[1:]), toks

    def llama_agree(label, what, got, want):
        (pre_k, dec_k, toks), (pre_p, dec_p, _) = got, want
        rel_pre, rel_dec = rel_l2(pre_k, pre_p), rel_l2(dec_k, dec_p)
        print(f"[{label}] full-width Llama-2-7B, {what}: relative L2 of the logits, prefill "
              f"({pre_k.shape[0]} tokens) {rel_pre:.3e}, {LLAMA_AGREE_STEPS} decode steps "
              f"{rel_dec:.3e} (tol {LLAMA_AGREE_TOL}); |logits| max "
              f"{pre_p.abs().max().item():.3f}; greedy tokens "
              f"{torch.cat(toks, dim=1)[:2].tolist()}", flush=True)
        check(bool(torch.isfinite(pre_k).all() and torch.isfinite(dec_k).all())
              and rel_pre <= LLAMA_AGREE_TOL and rel_dec <= LLAMA_AGREE_TOL,
              f"{label}: relative L2 {rel_pre} / {rel_dec}")

    ids, mask = int8kv_request(lcfg, LLAMA_REQUESTS[0], dev)
    prompt = ids.shape[1]
    got = llama_steps(llama.init_cache(1, prompt + LLAMA_AGREE_STEPS), ids, mask)
    llama_agree("llama int8kv agree", "int8 KV cache, kernels (rms_norm, decode_attention_int8) "
                "vs plain", got, llama_steps(
                    llama.init_cache(1, prompt + LLAMA_AGREE_STEPS), ids, mask,
                    [(llama_mod, "rms_norm", norms_mod.rms_norm_ref),
                     (llama_mod, "decode_attention_int8", da_mod.decode_attention_int8_ref)],
                    got[2]))
    del got

    llama_counters = {"rms_norm": norms_mod.rms_norm, "decode_attention": da_mod.decode_attention,
                      "decode_attention_int8": da_mod.decode_attention_int8,
                      "paged_decode_attention": pa_mod.paged_decode_attention,
                      "wint8_matmul": quant_mod.wint8_matmul,
                      "flash_attention": attn_mod.flash_attention}

    def llama_serve(label, run, batch, prompt_lens, new_tokens, cache_kind, full_cache):
        """The LLAMA_REQUESTS requests (batches) made by `batch(config, seed)`: TTFT is a
        1-token run, then the full run; tokens/s = B (new tokens - 1) / (full
        - TTFT), as bench.py. `full_cache(ids)`: an empty cache of the full
        run's size."""
        want = expected_launches_llama(llama, prompt_lens, new_tokens, cache_kind)
        want_1 = expected_launches_llama(llama, prompt_lens, 1, cache_kind)
        print(f"[{label}] expected launches per request (walking the modules): {want}; TTFT "
              f"run {want_1}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        for fn in llama_counters.values():
            fn.launches = 0
        stats = []
        for seed in LLAMA_REQUESTS:
            ids, mask = batch(lcfg, seed, dev)
            runs = []
            for n_new, expected in ((1, want_1), (new_tokens, want)):
                before = {name: fn.launches for name, fn in llama_counters.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = run(ids, mask, n_new)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0, toks))
                got = {name: fn.launches - before[name] for name, fn in llama_counters.items()}
                check(got == expected, f"{label}: launches {got} != expected {expected}")
            (ttft, first), (total, toks) = runs
            tps = ids.shape[0] * (new_tokens - 1) / (total - ttft)
            stats.append((ttft, total, tps))
            print(f"[{label}] prompt seed {seed}: TTFT {1e3 * ttft:.1f} ms | {new_tokens} tokens "
                  f"{total:.3f} s | decode {tps:.2f} tokens/s | tokens {toks[0, :8].tolist()}...",
                  flush=True)
            check(toks.shape == (ids.shape[0], new_tokens) and toks.dtype == torch.int32,
                  f"{label}: tokens {tuple(toks.shape)} {toks.dtype}")
            check(bool(((toks >= 0) & (toks < lcfg.vocab_size)).all()),
                  f"{label}: a token outside the vocab")
            flipped = toks[:, 0] != first[:, 0]
            if bool(flipped.any()):
                # the two runs' prefills attend over caches of different sizes,
                # so their bf16 logits differ by summation order, and a first
                # token may flip between two near-equal logits: both tokens
                # must lie within the agree tolerance of the full run's best
                positions = torch.where(mask > 0, mask.cumsum(dim=-1) - 1, -1)
                counts = {name: fn.launches for name, fn in llama_counters.items()}
                with torch.inference_mode():
                    logits, _ = llama(ids, positions, cache=full_cache(ids))
                for name, fn in llama_counters.items():  # this check's launches do not count
                    fn.launches = counts[name]
                last = logits[torch.arange(ids.shape[0], device=dev),
                              mask.sum(dim=-1) - 1].float()
                del logits
                best = last.amax(dim=-1)
                gaps = torch.stack([best - last.gather(1, t[:, :1].long())[:, 0]
                                    for t in (first, toks)])[:, flipped]
                tol = LLAMA_AGREE_TOL * last.abs().max().item()
                print(f"[{label}] prompt seed {seed}: the first token flips for "
                      f"{int(flipped.sum())} of {ids.shape[0]} sequences; logit gaps to the best "
                      f"{gaps.tolist()} (tol {tol:.3f})", flush=True)
                check(bool((gaps <= tol).all()), f"{label}: the first tokens differ between the "
                      f"TTFT run and the full run beyond a near tie")
        launches = {name: fn.launches for name, fn in llama_counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{label}] peak memory allocated {peak:.2f} GiB | launches over "
              f"{len(LLAMA_REQUESTS)} requests {launches}", flush=True)
        return launches, stats, peak

    new = llama7b.INT8KV_NEW_TOKENS
    launches_i8, stats_i8, peak_i8 = llama_serve(
        "llama int8kv", lambda ids, mask, n: greedy_generate(llama, ids, mask, max_new_tokens=n,
                                                             eos_token_id=-1),
        int8kv_request, [prompt], new, "int8", lambda ids: llama.init_cache(1, prompt + new))
    launches_kv, stats_kv, peak_kv = llama_serve(
        "llama bf16kv", lambda ids, mask, n: greedy_generate(
            llama, ids, mask, max_new_tokens=n, eos_token_id=-1,
            cache=KVCache.create(lcfg, 1, prompt + n, device=dev)),
        int8kv_request, [prompt], new, "dense",
        lambda ids: KVCache.create(lcfg, 1, prompt + new, device=dev))
    # the caches' bytes, from their shapes (the meta device allocates nothing)
    c8 = Int8KVCache.create(lcfg, 1, prompt + new, device="meta")
    ckv = KVCache.create(lcfg, 1, prompt + new, device="meta")
    bytes_i8, bytes_kv = nbytes(c8.k, c8.v, c8.k_scale, c8.v_scale), nbytes(ckv.k, ckv.v)
    print(f"[llama int8kv] median decode tokens/s int8 cache {med(stats_i8, 2):.2f} vs bf16 "
          f"cache {med(stats_kv, 2):.2f}; TTFT int8 {1e3 * med(stats_i8, 0):.1f} ms vs bf16 "
          f"{1e3 * med(stats_kv, 0):.1f} ms; peak memory int8 {peak_i8:.2f} GiB vs bf16 "
          f"{peak_kv:.2f} GiB; cache bytes ({prompt + new + 1} slots) int8 + scales "
          f"{bytes_i8 / 1e9:.3f} GB vs bf16 {bytes_kv / 1e9:.3f} GB (same run)", flush=True)

    lap("llama int8kv")
    # ----------------------------------------------------------- llama paged
    ids, mask = paged_batch(lcfg, LLAMA_REQUESTS[0], dev)
    b_, s_ = ids.shape
    steps_blocks = blocks_needed(llama7b.PAGED_PROMPT_LENS, LLAMA_AGREE_STEPS, paged_bs)

    def agree_pool():
        return PagedKVCache.create(lcfg, b_, steps_blocks, paged_bs,
                                   -(-(s_ + LLAMA_AGREE_STEPS) // paged_bs), device=dev)
    got = llama_steps(agree_pool(), ids, mask)
    llama_agree("llama paged agree", "paged KV cache, kernels (rms_norm, paged_decode_attention) "
                "vs plain", got, llama_steps(
                    agree_pool(), ids, mask,
                    [(llama_mod, "rms_norm", norms_mod.rms_norm_ref),
                     (llama_mod, "paged_decode_attention", pa_mod.paged_decode_attention_ref)],
                    got[2]))
    llama_agree("llama paged agree", "the paged path vs the dense KVCache (B7) on the same "
                "batch", got, llama_steps(KVCache.create(lcfg, b_, s_ + LLAMA_AGREE_STEPS,
                                                         device=dev), ids, mask, (), got[2]))
    del got
    new = llama7b.PAGED_NEW_TOKENS
    launches_pg, stats_pg, peak_pg = llama_serve(
        "llama paged", lambda ids, mask, n: paged_greedy_generate(
            llama, ids, mask, max_new_tokens=n, block_size=paged_bs,
            num_blocks=blocks_needed(llama7b.PAGED_PROMPT_LENS, n, paged_bs), eos_token_id=-1),
        paged_batch, llama7b.PAGED_PROMPT_LENS, new, "paged",
        lambda ids: PagedKVCache.create(lcfg, b_, blocks_needed(llama7b.PAGED_PROMPT_LENS, new,
                                                                paged_bs),
                                        paged_bs, -(-(s_ + new) // paged_bs), device=dev))
    need = blocks_needed(llama7b.PAGED_PROMPT_LENS, new, paged_bs)
    pool = PagedKVCache.create(lcfg, b_, need, paged_bs, -(-(s_ + new) // paged_bs),
                               device="meta")
    dense = KVCache.create(lcfg, b_, s_ + new, device="meta")
    per_block = nbytes(pool.k_pool, pool.v_pool) // (need + 1)
    print(f"[llama paged] median batch TTFT {1e3 * med(stats_pg, 0):.1f} ms, aggregate decode "
          f"{med(stats_pg, 2):.2f} tokens/s ({b_} sequences), peak memory {peak_pg:.2f} GiB; "
          f"pool {need} blocks {need * per_block / 1e9:.3f} GB (+ the parking block "
          f"{per_block / 1e9:.3f} GB) vs a dense cache for the batch "
          f"{nbytes(dense.k, dense.v) / 1e9:.3f} GB", flush=True)

    del llama

    lap("llama paged")
    # -------------------------------------------------------------- training
    gc.collect()
    torch.cuda.empty_cache()
    tmods = types.SimpleNamespace(attn=attn_mod, norms=norms_mod, da=da_mod, pa=pa_mod,
                                  quant=quant_mod)
    train_kernels(torch, F, dev, gen, record, tmods)
    eval_kernels(torch, F, dev, gen, record, tmods)
    gc.collect()
    torch.cuda.empty_cache()
    launches_tr, train_stats, launches_sft, launches_sft_eval, sft_stats = train_slice(
        torch, F, np, dev, tmods, card)

    lap("training")
    # ------------------------------------------------------------ CLIP slice
    gc.collect()
    torch.cuda.empty_cache()
    clip_kernels(torch, F, dev, gen, record, norms_mod)
    clip_kernels(torch, F, dev, gen, record, norms_mod, shapes=EVA_LN_SHAPES)
    ln_extra_cases(torch, dev, gen, norms_mod)
    ln_wide_extra_cases(torch, dev, gen, norms_mod)
    every = dict(all_counters, rms_norm_backward=norms_mod.rms_norm_backward,
                 flash_fwd_lse=attn_mod.flash_fwd_lse, flash_bwd_dkv=attn_mod.flash_bwd_dkv,
                 flash_bwd_dq=attn_mod.flash_bwd_dq,
                 layer_norm_backward=norms_mod.layer_norm_backward)
    launches_clip, launches_clip_tr, clip_stats, clip_train_stats = clip_slice(
        torch, np, dev, tmods, every)

    lap("CLIP slice")
    # ------------------------------------------------- C.9 and EVA-CLIP slice
    gc.collect()
    torch.cuda.empty_cache()
    quantizer_checks(torch, dev, gen)
    launches_eva, eva_stats = eva_slice(torch, np, dev, tmods, every)

    lap("C.9 and EVA-CLIP slice")
    # ----------------------------------------------------------- SD1.5 slice
    gc.collect()
    torch.cuda.empty_cache()
    sd15_kernels(torch, F, dev, gen, record, flash_case, gn_case, attn_mod)
    launches_sd15, sd15_stats = sd15_slice(torch, np, dev, gen, mods, every)

    lap("SD1.5 slice")
    # ------------------------------------------------ SD1.5 UNet fine-tuning
    gc.collect()
    torch.cuda.empty_cache()
    for shape, act in SD15_TRAIN_GN_CASES:
        gn_case("sd15 train kernels", shape, act, control=True, wdtype=torch.float32)
    sd15_train_kernels(torch, F, dev, gen, record, attn_mod)
    launches_sd15_tr, dims_sd15_tr, sd15_train_stats = sd15_train_slice(torch, np, dev, mods,
                                                                        every)

    lap("SD1.5 UNet fine-tuning")
    # ---------------------------------------------------------- BLIP-2 slice
    gc.collect()
    torch.cuda.empty_cache()
    blip2_kernels(torch, F, dev, gen, record, tmods)
    launches_blip2, blip2_stats = blip2_slice(torch, np, dev, tmods, every)

    lap("BLIP-2 slice")
    # ------------------------------------------------ diffusers directories
    gc.collect()
    torch.cuda.empty_cache()
    launches_dir, dims_dir, dir_stats = sd15_dir_slice(torch, F, np, dev, gen, mods, every,
                                                       record, gn_case, card)
    launches_sdxl_dir, sdxl_dir_stats = sdxl_dir_slice(torch, np, dev, gen, every, card)

    lap("diffusers directories")
    # ------------------------------------------------------- Qwen2-VL slice
    gc.collect()
    torch.cuda.empty_cache()
    qwen2vl_kernels(torch, F, dev, gen, record, tmods)
    launches_qwen2vl, qwen2vl_stats = qwen2vl_slice(torch, np, dev, tmods, every, card)

    lap("Qwen2-VL slice")
    # ----------------------------------------------- SD3-medium directory slice
    gc.collect()
    torch.cuda.empty_cache()
    launches_sd3_dir, sd3_dir_stats = sd3_dir_slice(torch, F, np, dev, gen, tmods, every, record,
                                                    card)

    lap("SD3-medium directory slice")
    # ------------------------------------ SD1.5 under a ControlNet / an adapter
    gc.collect()
    torch.cuda.empty_cache()
    for shape, act, wdtype in CONTROL_TRAIN_GN_CASES:
        gn_case("control train kernels", shape, act, control=True,
                wdtype=torch.float32 if wdtype == "fp32" else bf16)
    launches_ctl, dims_ctl, ctl_stats = control_slice(torch, F, np, dev, gen, mods, every, record,
                                                      card)

    lap("SD1.5 under a ControlNet / an adapter")
    # ------------------------------------------------- DiT and PixArt-alpha
    gc.collect()
    torch.cuda.empty_cache()
    launches_dit, dit_stats = dit_slice(torch, F, np, dev, gen, tmods, every, record, gn_case,
                                        card)

    lap("DiT and PixArt-alpha")
    # --------------------------------------------- InternVL2-8B and Qwen-VL-Chat
    gc.collect()
    torch.cuda.empty_cache()
    internvl2_kernels(torch, F, dev, gen, record, tmods)
    launches_ivl, ivl_stats = internvl2_slice(torch, np, dev, tmods, every, card)
    lap("InternVL2-8B")
    qwenvl_kernels(torch, F, dev, gen, record, tmods)
    launches_qvl, qvl_stats = qwenvl_slice(torch, np, dev, tmods, every, card)
    lap("Qwen-VL-Chat")
    # --------------------------------------------------------------- summary
    def entry(name, route, source, replaces, by_phase):
        # ms / plain_ms / library_ms / bound at the first shape listed;
        # max_abs_err over all shapes; launches summed over the serve phases
        rows = summary[name]
        first = rows[0]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
                "max_abs_err": max(r["err"] for r in rows), "ms": first["ms"],
                "plain_ms": first["plain_ms"], "bound_ms": first["bound"][0],
                "bound_by": first["bound"][1], "library_ms": first["library_ms"],
                "shape": list(first["shape"]),
                **({"core": first["core"], "tflops": first["tflops"]} if "core" in first else {}),
                **({"floor_ms": first["floor_ms"]} if "floor_ms" in first else {}),
                **({"copy_ms": first["copy_ms"]} if "copy_ms" in first else {})}

    def sdxl(name):
        return {"bf16": launches_bf16[name], "a8w8": launches_a8w8[name],
                "a8w8_int8_attn": launches_i8attn[name], "sd3": launches_sd3[name],
                "sd15": launches_sd15[name], "sd15_dir": launches_dir["sd15_dir"][name],
                "sdxl_dir": launches_sdxl_dir[name], "sd3_dir": launches_sd3_dir["sd3_dir"][name]}

    dir_train = ("t2i_dir", "db_lora", "db_full")

    def llava(name):
        return {"llava_bf16": launches_llava[name], "llava_wint8": launches_wint8[name],
                "llava_a8w8": launches_q["a8w8"][name], "llava_a8w4": launches_q["a8w4"][name],
                "sd3": launches_sd3[name], "sd3_dir": launches_sd3_dir["sd3_dir"][name]}

    def train_phases(name):
        return {"train": launches_tr[name], "sft_main": launches_sft[name],
                "sd15_train": launches_sd15_tr[name],
                **{phase: launches_dir[phase][name] for phase in dir_train},
                "sd3_train": launches_sd3_dir["sd3_train"][name]}

    def sd15_train_dim(name, d_):
        return {"sd15_train": dims_sd15_tr[name].get(d_, 0),
                **{phase: dims_dir[phase][name].get(d_, 0) for phase in dir_train}}

    def llama_phases(name):
        return {"llama_int8kv": launches_i8[name], "llama_bf16kv": launches_kv[name],
                "llama_paged": launches_pg[name]}

    kernels = [
        entry("flash_attention", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:168",
              dict(sdxl("flash_attention"), sft_main=launches_sft["flash_attention"],
                   sft_eval=launches_sft_eval["flash_attention"],
                   qwen2vl=launches_qwen2vl["flash_attention"],
                   internvl2=launches_ivl["flash_attention"],
                   qwenvl=launches_qvl["flash_attention"])),
        entry("group_norm", "cuda", "paddlemix_tpu_torch/csrc/norms.cu",
              "paddlemix_tpu/ops/norms.py:462", sdxl("group_norm")),
        entry("group_norm_stats", "cuda", "paddlemix_tpu_torch/csrc/norms.cu",
              "paddlemix_tpu/ops/norms.py:462", sdxl("group_norm_stats")),
        entry("int8_a8w8_matmul", "cuda", "paddlemix_tpu_torch/csrc/int8_gemm.cu",
              "paddlemix_tpu/ops/conv_int8.py:187", sdxl("int8_a8w8_matmul")),
        entry("int8_conv3x3_same", "cuda", "paddlemix_tpu_torch/csrc/int8_conv3x3.cu",
              "paddlemix_tpu/ops/conv_int8.py:108", sdxl("int8_conv3x3_same")),
        entry("fused_gn_silu_conv3x3", "cuda", "paddlemix_tpu_torch/csrc/int8_conv3x3.cu",
              "paddlemix_tpu/ops/fused_resnet.py:196", sdxl("fused_gn_silu_conv3x3")),
        entry("wint8_matmul", "cuda", "paddlemix_tpu_torch/csrc/wint8_gemm.cu",
              "paddlemix_tpu/ops/quant.py:445", llava("wint8_matmul")),
        # N1 / N2 replace no Pallas kernel: JAX's a8w8 and a8w4 Dense are XLA dots
        entry("a8w8_matmul", "cuda", "paddlemix_tpu_torch/csrc/a8w_gemm.cu",
              "paddlemix_tpu/models/llama/modeling.py:169", llava("a8w8_matmul")),
        entry("a8w4_matmul", "cuda", "paddlemix_tpu_torch/csrc/a8w_gemm.cu",
              "paddlemix_tpu/models/llama/modeling.py:150", llava("a8w4_matmul")),
        entry("decode_attention", "cuda", "paddlemix_tpu_torch/csrc/decode_attention.cu",
              "paddlemix_tpu/ops/decode_attention.py:68",
              dict(llava("decode_attention"), **llama_phases("decode_attention"),
                   blip2=launches_blip2["decode_attention"],
                   qwen2vl=launches_qwen2vl["decode_attention"],
                   internvl2=launches_ivl["decode_attention"],
                   qwenvl=launches_qvl["decode_attention"])),
        entry("rms_norm", "cuda", "paddlemix_tpu_torch/csrc/norms.cu",
              "paddlemix_tpu/ops/norms.py:148",
              dict(llava("rms_norm"), **llama_phases("rms_norm"),
                   qwen2vl=launches_qwen2vl["rms_norm"], internvl2=launches_ivl["rms_norm"],
                   qwenvl=launches_qvl["rms_norm"])),
        entry("adaptive_layer_norm", "cuda", "paddlemix_tpu_torch/csrc/norms.cu",
              "paddlemix_tpu/ops/norms.py:261",
              {"sd3": launches_sd3["adaptive_layer_norm"],
               **{phase: launches_sd3_dir[phase]["adaptive_layer_norm"]
                  for phase in ("sd3_dir", "sd3_train")}}),
        entry("fused_adaln_scale_residual", "cuda", "paddlemix_tpu_torch/csrc/norms.cu",
              "paddlemix_tpu/ops/norms.py:289",
              {"sd3": launches_sd3["fused_adaln_scale_residual"],
               **{phase: launches_sd3_dir[phase]["fused_adaln_scale_residual"]
                  for phase in ("sd3_dir", "sd3_train")}}),
        entry("decode_attention_int8", "cuda", "paddlemix_tpu_torch/csrc/decode_attention.cu",
              "paddlemix_tpu/ops/decode_attention.py:196", llama_phases("decode_attention_int8")),
        entry("paged_decode_attention", "cuda", "paddlemix_tpu_torch/csrc/paged_attention.cu",
              "paddlemix_tpu/ops/paged_attention.py:134", llama_phases("paged_decode_attention")),
        entry("flash_fwd_lse", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:243", train_phases("flash_fwd_lse")),
        entry("flash_bwd_dkv", "cuda", "paddlemix_tpu_torch/csrc/flash_bwd.cu",
              "paddlemix_tpu/ops/attention.py:386", train_phases("flash_bwd_dkv")),
        entry("flash_bwd_dq", "cuda", "paddlemix_tpu_torch/csrc/flash_bwd.cu",
              "paddlemix_tpu/ops/attention.py:422", train_phases("flash_bwd_dq")),
        entry("rms_norm_backward", "triton", "paddlemix_tpu_torch/ops/norms.py",
              "paddlemix_tpu/ops/norms.py:172", {"train": launches_tr["rms_norm_backward"],
                                                 "sft_main": launches_sft["rms_norm_backward"]}),
        entry("layer_norm", "cuda", "paddlemix_tpu_torch/csrc/norms.cu",
              "paddlemix_tpu/ops/norms.py:204",
              {"bf16": launches_bf16["layer_norm"], "a8w8": launches_a8w8["layer_norm"],
               "a8w8_int8_attn": launches_i8attn["layer_norm"], "sd15": launches_sd15["layer_norm"],
               "llava_bf16": launches_llava["layer_norm"],
               "llava_wint8": launches_wint8["layer_norm"],
               "llava_a8w8": launches_q["a8w8"]["layer_norm"],
               "llava_a8w4": launches_q["a8w4"]["layer_norm"], "sd3": launches_sd3["layer_norm"],
               "clip": launches_clip["layer_norm"], "clip_train": launches_clip_tr["layer_norm"],
               **{phase: got["layer_norm"] for phase, got in launches_eva.items()},
               "blip2": launches_blip2["layer_norm"], "sdxl_dir": launches_sdxl_dir["layer_norm"],
               "qwen2vl": launches_qwen2vl["layer_norm"],
               "internvl2": launches_ivl["layer_norm"], "qwenvl": launches_qvl["layer_norm"],
               **{phase: launches_dir[phase]["layer_norm"]
                  for phase in ("sd15_dir", "db_lora", "db_full")},
               **{phase: launches_sd3_dir[phase]["layer_norm"]
                  for phase in ("sd3_dir", "sd3_encode")}}),
        entry("layer_norm_backward", "cuda", "paddlemix_tpu_torch/csrc/norms.cu",
              "paddlemix_tpu/ops/norms.py:226",
              {"clip_train": launches_clip_tr["layer_norm_backward"],
               "eva_train": launches_eva["eva_train"]["layer_norm_backward"],
               "clip_main": launches_eva["clip_main"]["layer_norm_backward"]}),
        # B1's forms: int8 QK^T (the `int8_qk` branch of `_fwd_kernel`) and
        # the wide heads; B15 at the SD1.5 training path's head dims (40, 80
        # and 160, read in place at D = 64, 128 and 192) and at 256
        entry("flash_attention_int8", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:89",
              {"a8w8_int8_attn": launches_i8attn["flash_attention_int8"]}),
        entry("flash_attention_d160", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:243",
              {"sd15": launches_sd15["flash_attention_d160"],
               "sd15_dir": dims_dir["sd15_dir"]["flash_attention"].get(160, 0)}),
        entry("flash_attention_d256", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:243", {}),
        entry("flash_fwd_lse_d40", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:243", sd15_train_dim("flash_fwd_lse", 40)),
        entry("flash_fwd_lse_d80", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:243", sd15_train_dim("flash_fwd_lse", 80)),
        entry("flash_fwd_lse_d160", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:243", sd15_train_dim("flash_fwd_lse", 160)),
        entry("flash_fwd_lse_d256", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:243", {}),
    ]
    # B14 at the SD1.5 training path's head dims (40, 80 and 160 read in
    # place at D = 64, 128 and 192), at 256, and at heads of 32 or less
    kernels += [entry(f"{name}_d{d_}", "cuda", "paddlemix_tpu_torch/csrc/flash_bwd.cu",
                      f"paddlemix_tpu/ops/attention.py:{line}", sd15_train_dim(name, d_))
                for d_ in (40, 80, 160, 256, 32, 24, 20)
                for name, line in (("flash_bwd_dkv", 386), ("flash_bwd_dq", 422))]
    by_name = {k["name"]: k for k in kernels}
    # the BLIP-2 and Qwen2-VL paths' shapes of B10, B7, B11 and B1, each case
    # as the line's first shape
    for key, name, shapes in (
            ("blip2_shapes", "layer_norm", BLIP2_LN_SHAPES),
            ("blip2_shapes", "decode_attention", BLIP2_DECODE_CASES),
            ("qwen2vl_shapes", "decode_attention", QWEN2VL_DECODE_CASES),
            ("qwen2vl_shapes", "rms_norm", QWEN2VL_RMS_SHAPES),
            ("qwen2vl_shapes", "layer_norm", [sh[:2] for sh in QWEN2VL_LN_SHAPES]),
            ("qwen2vl_shapes", "flash_attention", [(1, s_, 16, 80, tuple(lengths))
                                                   for s_, lengths in QWEN2VL_FLASH_LAYOUTS]),
            ("internvl2_shapes", "flash_attention", [(t, 1025, 16, 64)
                                                     for t in INTERNVL2_FLASH_TILES]),
            ("internvl2_shapes", "layer_norm", [sh[:2] for sh in INTERNVL2_LN_SHAPES]),
            ("internvl2_shapes", "decode_attention", INTERNVL2_DECODE_CASES),
            ("qwenvl_shapes", "flash_attention",
             [sh for b_ in QWENVL_FLASH_IMAGES
              for sh in ((b_, 1024, 16, 104), (b_, 256, 1024, 32, 128))]),
            ("qwenvl_shapes", "layer_norm", [sh[:2] for sh in QWENVL_LN_SHAPES]),
            ("qwenvl_shapes", "decode_attention", QWENVL_DECODE_CASES)):
        by_name[name][key] = [
            {"shape": list(r["shape"]), "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
             "max_abs_err": r["err"]}
            for r in summary[name] if tuple(r["shape"]) in {tuple(sh) for sh in shapes}]
    for phase, got in (("train", launches_tr), ("sft_main", launches_sft),
                       ("sft_eval", launches_sft_eval),
                       ("sd3_encode", launches_sd3_dir["sd3_encode"])):
        by_name["rms_norm"]["launches_by_phase"][phase] = got["rms_norm"]
        by_name["rms_norm"]["launches"] += got["rms_norm"]
    for phase, got in [("sd15_train", launches_sd15_tr)] + [
            (phase, launches_dir[phase]) for phase in ("vae_encode",) + dir_train] + [
            ("sd3_encode", launches_sd3_dir["sd3_encode"])]:
        by_name["group_norm"]["launches_by_phase"][phase] = got["group_norm"]
        by_name["group_norm"]["launches"] += got["group_norm"]
    # B15 / B14 at the SD3 training path's joint attention (phase 43c)
    for name in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        by_name[name]["sd3_train_shapes"] = [
            {"shape": list(r["shape"]), "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
             "max_abs_err": r["err"]}
            for r in summary[name] if tuple(r["shape"]) in {tuple(c[:5]) for c in
                                                             SD3_TRAIN_FLASH_CASES}]
    # the ControlNet and T2I-Adapter phases (44b-44f): B1, B4 and B10 in the
    # requests, B15 / B14 (and B1 in the frozen UNet's down blocks) in the
    # trainers, by head_dim too
    for phase, got in launches_ctl.items():
        for name in ("flash_attention", "group_norm", "layer_norm", "flash_fwd_lse",
                     "flash_bwd_dkv", "flash_bwd_dq"):
            by_name[name]["launches_by_phase"][phase] = got[name]
            by_name[name]["launches"] += got[name]
        for name, d_ in itertools.product(("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"),
                                          (40, 80, 160)):
            n_ = dims_ctl[phase][name].get(d_, 0)
            by_name[f"{name}_d{d_}"]["launches_by_phase"][phase] = n_
            by_name[f"{name}_d{d_}"]["launches"] += n_
        n_ = dims_ctl[phase]["flash_attention"].get(160, 0)
        by_name["flash_attention_d160"]["launches_by_phase"][phase] = n_
        by_name["flash_attention_d160"]["launches"] += n_
    # B15 / B14 at the trainers' shapes (phase 44d), beside each head_dim's line
    for name, d_ in itertools.product(("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"),
                                      (40, 80, 160)):
        key = f"{name}_d{d_}"
        by_name[key]["control_train_shapes"] = [
            {"shape": list(r["shape"]), "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
             "max_abs_err": r["err"]}
            for r in summary.get(key, []) if tuple(r["shape"]) in {
                tuple(c[:5]) for c in CONTROL_TRAIN_FLASH_CASES if c[4] == d_}]
    by_name["group_norm"]["control_train_shapes"] = [
        {"shape": list(r["shape"]), "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
         "max_abs_err": r["err"]}
        for r in summary["group_norm"]
        if tuple(r["shape"]) in {c[0] for c in CONTROL_TRAIN_GN_CASES}]
    # B4 at the VAE encoder's shapes (phase 41c), beside the line's first shape
    by_name["group_norm"]["vae_encode_shapes"] = [
        {"shape": list(r["shape"]), "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
         "max_abs_err": r["err"]}
        for r in summary["group_norm"]
        if tuple(r["shape"]) in {shape for shape, _ in VAE_ENCODE_GN_CASES}]
    # the DiT and PixArt phases (45b, 45d, 45e): B1, B12, B4 in the DiT request,
    # B15 / B14 and B12 in its trainer, B1, B11 and B4 in the PixArt request;
    # the new shapes of phase 45c beside each line's first shape
    for phase, got in launches_dit.items():
        for name in ("flash_attention", "adaptive_layer_norm", "rms_norm", "group_norm",
                     "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
            by_name[name]["launches_by_phase"][phase] = got[name]
            by_name[name]["launches"] += got[name]
    for name, key in (("flash_attention", "flash_attention"),
                      ("flash_fwd_lse", "flash_fwd_lse_d72"),
                      ("flash_bwd_dkv", "flash_bwd_dkv_d72"), ("flash_bwd_dq", "flash_bwd_dq_d72"),
                      ("adaptive_layer_norm", "adaptive_layer_norm"), ("rms_norm", "rms_norm"),
                      ("group_norm", "group_norm")):
        shapes = {tuple(sh) for sh in DIT_FLASH_SHAPES + [c[:5] for c in DIT_TRAIN_FLASH_CASES]
                  + [DIT_ADALN_SHAPE] + PIXART_RMS_SHAPES + [c[0] for c in DIT_GN_CASES]}
        by_name[name]["dit_shapes"] = [
            {"shape": list(r["shape"]), "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
             "max_abs_err": r["err"]}
            for r in summary.get(key, []) if tuple(r["shape"]) in shapes]
    # the a8w8 requests run all six SDXL kernels (B4's statistics for B5
    # among them), the bf16 ones flash and
    # GroupNorm; both LLaVA configurations run decode attention and RMSNorm,
    # wint8 also the wint8 GEMM; SD3 runs flash, GroupNorm, RMSNorm and both
    # adaLN kernels; the Llama requests run RMSNorm and the decode attention
    # of their cache: B8, B7 or B9 (and, checked per request above, no other);
    # the CLIP towers of SDXL, LLaVA and SD3 run B10, and the CLIP phases B10
    # and (training) its backward, and nothing else
    must_run = [(k["name"], phase) for k in kernels[:6] for phase in ("a8w8", "a8w8_int8_attn")
                if k["name"] != "flash_attention"] + [("flash_attention", "a8w8")] + \
        [("flash_attention_int8", "a8w8_int8_attn"), ("flash_attention_d160", "sd15")] + \
        [(name, "sd15") for name in ("flash_attention", "group_norm", "layer_norm")] + \
        [("flash_attention", "bf16"), ("group_norm", "bf16")] + \
        [(name, phase) for name in ("decode_attention", "rms_norm")
         for phase in ("llava_bf16", "llava_wint8", "llava_a8w8", "llava_a8w4")] + \
        [("wint8_matmul", "llava_wint8"), ("a8w8_matmul", "llava_a8w8"),
         ("a8w4_matmul", "llava_a8w4")] + \
        [(name, "sd3") for name in ("flash_attention", "group_norm", "rms_norm",
                                    "adaptive_layer_norm", "fused_adaln_scale_residual")] + \
        [("rms_norm", phase) for phase in ("llama_int8kv", "llama_bf16kv", "llama_paged")] + \
        [("decode_attention_int8", "llama_int8kv"), ("decode_attention", "llama_bf16kv"),
         ("paged_decode_attention", "llama_paged")] + \
        [(name, phase) for name in ("rms_norm", "flash_fwd_lse", "flash_bwd_dkv",
                                    "flash_bwd_dq", "rms_norm_backward")
         for phase in ("train", "sft_main")] + \
        [(name, phase) for name in ("flash_attention", "rms_norm")
         for phase in ("sft_main", "sft_eval")] + \
        [("layer_norm", phase) for phase in ("bf16", "a8w8", "llava_bf16", "llava_wint8",
                                             "llava_a8w8", "llava_a8w4", "sd3", "clip",
                                             "clip_train")] + \
        [("layer_norm", phase) for phase in launches_eva] + \
        [("layer_norm_backward", phase) for phase in ("clip_train", "eva_train", "clip_main")] + \
        [("layer_norm", "blip2"), ("decode_attention", "blip2")] + \
        [(name, "qwen2vl") for name in ("flash_attention", "layer_norm", "rms_norm",
                                        "decode_attention")] + \
        [(name, phase) for phase in ("sd15_train",) + dir_train for name in (
            "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "group_norm",
            "flash_fwd_lse_d40", "flash_fwd_lse_d80", "flash_fwd_lse_d160",
            "flash_bwd_dkv_d40", "flash_bwd_dq_d40", "flash_bwd_dkv_d80", "flash_bwd_dq_d80",
            "flash_bwd_dkv_d160", "flash_bwd_dq_d160")] + \
        [(name, phase) for phase in ("sd15_dir", "sdxl_dir")
         for name in ("flash_attention", "group_norm", "layer_norm")] + \
        [("flash_attention_d160", "sd15_dir"), ("group_norm", "vae_encode")] + \
        [("layer_norm", phase) for phase in ("db_lora", "db_full")] + \
        [(name, "sd3_dir") for name in ("flash_attention", "group_norm", "rms_norm", "layer_norm",
                                        "adaptive_layer_norm", "fused_adaln_scale_residual")] + \
        [(name, "sd3_encode") for name in ("group_norm", "rms_norm", "layer_norm")] + \
        [(name, "sd3_train") for name in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq",
                                          "adaptive_layer_norm", "fused_adaln_scale_residual")] + \
        [(name, phase) for phase in ("cn_serve", "adapter_serve")
         for name in ("flash_attention", "flash_attention_d160", "group_norm", "layer_norm")] + \
        [(name, phase) for phase in ("cn_train", "adapter_train", "sd15_gc") for name in (
            "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "group_norm",
            "flash_fwd_lse_d40", "flash_fwd_lse_d80", "flash_fwd_lse_d160",
            "flash_bwd_dkv_d40", "flash_bwd_dq_d40", "flash_bwd_dkv_d80", "flash_bwd_dq_d80",
            "flash_bwd_dkv_d160", "flash_bwd_dq_d160")] + \
        [("flash_attention", "cn_train"), ("flash_attention", "adapter_train"),
         ("layer_norm", "adapter_train")] + \
        [(name, "dit") for name in ("flash_attention", "adaptive_layer_norm", "group_norm")] + \
        [(name, "dit_train") for name in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq",
                                          "adaptive_layer_norm")] + \
        [(name, "pixart") for name in ("flash_attention", "rms_norm", "group_norm")] + \
        [(name, phase) for phase in ("internvl2", "qwenvl")
         for name in ("flash_attention", "layer_norm", "rms_norm", "decode_attention")]
    idle = [(name, phase) for name, phase in must_run
            if by_name[name]["launches_by_phase"][phase] == 0]
    check(not idle, f"kernels never launched by the requests: {idle}")
    check(launches_llava["wint8_matmul"] == 0 and launches_llava["flash_attention"] == 0
          and launches_wint8["flash_attention"] == 0, "LLaVA launched a kernel off its path")
    print(f"[summary] training: {train_stats}", flush=True)
    print(f"[summary] sft io, main, resume, eval, adapter: {sft_stats} ({card})", flush=True)
    print(f"[summary] clip: {clip_stats}; clip train: {clip_train_stats}", flush=True)
    print(f"[summary] eva: {eva_stats}", flush=True)
    print(f"[summary] sd15: {sd15_stats}", flush=True)
    print(f"[summary] sd15 train: {sd15_train_stats}", flush=True)
    print(f"[summary] blip2: {blip2_stats}", flush=True)
    print(f"[summary] sd15 dir: {dir_stats} ({card})", flush=True)
    print(f"[summary] sdxl dir: {sdxl_dir_stats} ({card})", flush=True)
    print(f"[summary] qwen2vl: {qwen2vl_stats} ({card})", flush=True)
    print(f"[summary] sd3 dir and train: {sd3_dir_stats} ({card})", flush=True)
    print(f"[summary] controlnet and t2i-adapter: {ctl_stats} ({card})", flush=True)
    print(f"[summary] dit and pixart: {dit_stats} ({card})", flush=True)
    print(f"[summary] internvl2: {ivl_stats} ({card})", flush=True)
    print(f"[summary] qwenvl: {qvl_stats} ({card})", flush=True)
    print(f"[summary] seconds by phase: {json.dumps(PHASE_SECONDS)}", flush=True)
    print(f"[summary] chip_smoke ran {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
