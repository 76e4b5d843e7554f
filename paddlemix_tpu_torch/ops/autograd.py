"""Gradients through the kernel wrappers, as the JAX package defines them.

Three kinds, one per kind of kernel (the JAX package's `custom_vjp`s and its
inference-only Pallas calls):
- a kernel with a backward kernel of its own (flash attention B1/B15 with
  B14, RMSNorm B11, LayerNorm B10) is a `torch.autograd.Function` in its
  module;
- a kernel whose JAX backward is XLA's derivative of its reference (GroupNorm
  B4, adaLN B12, fused adaLN + residual B13: `ops/norms.py` in the JAX
  package) runs forward on its kernel and takes its backward from autograd of
  its plain version, recomputed from the saved inputs: `with_plain_backward`;
- an inference kernel (B2, B3, B5-B9), which has no backward in the JAX
  package either, refuses a call on the card that autograd would have to
  differentiate: `refuse_grad`. On the CPU every wrapper runs its plain
  version, which autograd differentiates as it is.
"""

from __future__ import annotations

import torch


def grad_needed(*tensors) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record this inference kernel's call."""
    if grad_needed(*tensors):
        raise RuntimeError(f"{name}: an inference kernel with no backward (none in the JAX "
                           f"package either); call it under torch.no_grad() or on inputs that "
                           f"do not require grad")


class _PlainBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return run(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = ctx.plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wrt = [t for t, need in zip(inputs, needs) if need]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None, *[next(got) if need else None for need in needs])


def with_plain_backward(run, plain, *tensors):
    """`run(*tensors)` (the kernel); when autograd records the call, its
    backward is autograd of `plain(*tensors)`, recomputed from the saved
    inputs. `run` and `plain` take the same tensors (None allowed) and return
    a tensor or a tuple of them."""
    if not grad_needed(*tensors):
        return run(*tensors)
    return _PlainBackward.apply(run, plain, *tensors)
