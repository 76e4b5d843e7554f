"""PyTorch + CUDA port of paddlemix_tpu for one NVIDIA H100.

The JAX package `paddlemix_tpu` is the reference: every module here mirrors
its counterpart's path and class names, and the tests hold each against its
JAX twin on shared weights. This package imports torch and never jax.

Slices so far, each with its kernels written for Hopper:
  - SDXL text-to-image in bf16 (CLIP text towers, UNet denoise loop with
    Euler, AutoencoderKL decode): flash-attention forward (CUDA C++,
    `csrc/flash_fwd.cu`) and GroupNorm(+SiLU) (Triton, `ops/norms.py`);
  - SDXL in static a8w8: int8 GEMM, int8 3x3 conv and fused
    GroupNorm+SiLU+int8 conv (`csrc/int8_gemm.cu`, `csrc/int8_conv3x3.cu`);
  - LLaVA-1.5 generation in bf16 and weight-only int8 (`models/llava`,
    `models/llama`): wint8 GEMM (`csrc/wint8_gemm.cu`), decode attention
    (`csrc/decode_attention.cu`) and RMSNorm (Triton, `ops/norms.py`);
  - SD3-medium text-to-image in bf16 (MM-DiT, CLIP-L + bigG, T5 encoder in
    `models/t5`, 16-channel VAE, FlowMatch Euler): adaLN and fused adaLN +
    gated residual (Triton, `ops/norms.py`);
  - later slices (README, PyTorch port): Llama serving and LoRA SFT, CLIP
    ViT-B/16, SD1.5 and its fine-tuning, LLaVA's quantized modes, and
    EVA-CLIP zero-shot (`models/clip/eva.py`, `processors`, `appflow`,
    `metrics`), with every norm kernel now CUDA in `csrc/norms.cu`.
"""
