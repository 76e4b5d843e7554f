"""Model families of the port (CLIP towers, Llama, LLaVA, T5, OPT, BLIP-2,
Qwen2-VL) and shared transformer layers."""
