"""Model families of the port (CLIP towers, Llama, LLaVA) and shared transformer layers."""
