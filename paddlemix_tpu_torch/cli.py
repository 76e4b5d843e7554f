"""Command-line entry point of the port (port of paddlemix_tpu/cli.py's `env`,
`fp16-safetensors` and `merge-lora`; `convert` and `convert-pipeline` are not
ported yet).

  python -m paddlemix_tpu_torch.cli env
  python -m paddlemix_tpu_torch.cli fp16-safetensors DIR [--dtype fp16|bf16|fp32] [--output OUT]
  python -m paddlemix_tpu_torch.cli merge-lora MODEL_DIR LORA_DIR OUTPUT
      [--model-class paddlemix_tpu_torch.models.llama.LlamaForCausalLM]
      [--dtype fp32|bf16|fp16] [--device cuda|cpu]

Safetensors files are read and written by the port's `core.safetensors`.
`merge-lora` loads the model (by `AutoModel` unless a class is named) in
`--dtype` (fp32 by default, as the JAX command loads it) on `--device` (the
card by default), folds the adapter in and saves the merged model.
"""

from __future__ import annotations

import argparse
import importlib
import os
import platform
import sys

_DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}


def cmd_env(_args) -> int:
    import torch

    import paddlemix_tpu_torch

    rows = {
        "paddlemix_tpu_torch": getattr(paddlemix_tpu_torch, "__version__", "dev"),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "devices": ", ".join(torch.cuda.get_device_name(i)
                             for i in range(torch.cuda.device_count())) or "cpu only",
    }
    print("paddlemix-tpu-torch environment (copy into bug reports):")
    for k, v in rows.items():
        print(f"- {k}: {v}")
    return 0


def cmd_fp16_safetensors(args) -> int:
    """Re-save every .safetensors file of a directory with its floating
    tensors in fp16, bf16 or fp32 (other tensors as they are)."""
    import torch

    from .core import safetensors

    dtype = getattr(torch, _DTYPES[args.dtype])
    files = sorted(f for f in os.listdir(args.path) if f.endswith(".safetensors"))
    if not files:
        print(f"no .safetensors files under {args.path}", file=sys.stderr)
        return 1
    out_dir = args.output or args.path
    os.makedirs(out_dir, exist_ok=True)
    for f in files:
        tensors = {k: t.to(dtype) if t.is_floating_point() else t
                   for k, t in safetensors.load_file(os.path.join(args.path, f)).items()}
        out = os.path.join(out_dir, f if args.output else
                           f.replace(".safetensors", f".{args.dtype}.safetensors"))
        safetensors.save_file(tensors, out)
        print(f"wrote {out} ({len(tensors)} tensors, {args.dtype})")
    return 0


def cmd_merge_lora(args) -> int:
    """Fold a LoRA adapter into base weights and save the merged model (the
    reference's merge_lora_params.py)."""
    import torch

    from .auto import AutoModel
    from .core.modeling import save_pretrained
    from .peft import load_lora, merge_lora_into_model

    if args.model_class:
        mod_name, _, cls_name = args.model_class.rpartition(".")
        cls = getattr(importlib.import_module(mod_name), cls_name)
    else:
        cls = AutoModel
    model = cls.from_pretrained(args.model_name_or_path, device=args.device,
                                dtype=getattr(torch, _DTYPES[args.dtype]))
    lora_params, lora_config = load_lora(args.lora_path)
    merge_lora_into_model(model, lora_params, lora_config)
    save_pretrained(model, args.output)
    print(f"merged {args.lora_path} into {args.model_name_or_path} -> {args.output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("paddlemix-tpu-torch-cli")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("env", help="print environment info")

    p = sub.add_parser("fp16-safetensors", help="re-save weights in fp16/bf16")
    p.add_argument("path")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="fp16")
    p.add_argument("--output", default=None)

    p = sub.add_parser("merge-lora", help="fold a LoRA adapter into base weights")
    p.add_argument("model_name_or_path")
    p.add_argument("lora_path")
    p.add_argument("output")
    p.add_argument("--model-class", default=None,
                   help="e.g. paddlemix_tpu_torch.models.llama.LlamaForCausalLM (default: "
                        "AutoModel by config.json's model_type)")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="fp32")
    p.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)
    return {"env": cmd_env, "fp16-safetensors": cmd_fp16_safetensors,
            "merge-lora": cmd_merge_lora}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
