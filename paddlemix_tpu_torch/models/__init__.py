"""Model families of the port (CLIP towers, Llama, LLaVA, T5) and shared transformer layers."""
