#!/usr/bin/env python3
"""What the paged KV cache's pool check costs a decode step, in the PyTorch
port.

`PagedKVCache.allocate_for` refuses a step that needs more blocks than the
pool holds by reading the block count on the host: one sync a step. Builds
the full-width Llama-2-7B of paddlemix_tpu_torch (seeded random weights,
bf16) on one CUDA card, prefills the paged batch (8 right-padded prompts,
2,000 down to 130 tokens, blocks of 128), then runs turns of 12 decode steps.
A "queued" turn runs them as a decode loop does, synchronised only at the
turn's ends, so the check waits for whatever the device still has queued; a
"drained" turn synchronises before each allocate_for, outside the timed span,
so its time inside allocate_for is the call's own work and one read of an
idle device. Their difference is what the check waits for. Prints the card's
nvidia-smi name and power limit, then per turn (queued, drained, drained,
queued, after a warm-up turn) the mean ms a step and the median ms inside
allocate_for.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/time_torch_pool_check.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 12
TURNS = (False, True, True, False)  # drained?


def main():
    import torch

    from paddlemix_tpu_torch.models.llama import (
        PagedKVCache,
        blocks_needed,
        paged_batch,
        random_llama,
    )
    from paddlemix_tpu_torch.models.llama import llama7b

    if not torch.cuda.is_available():
        raise SystemExit("time_torch_pool_check: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    model = random_llama(dev, torch.bfloat16, seed=0)
    ids, mask = paged_batch(model.config, 1, dev)
    b, s = ids.shape
    bs, new = llama7b.PAGED_BLOCK_SIZE, (len(TURNS) + 1) * STEPS + 1
    cache = PagedKVCache.create(model.config, b, blocks_needed(llama7b.PAGED_PROMPT_LENS, new, bs),
                                bs, -(-(s + new) // bs), device=dev)
    allocate = PagedKVCache.allocate_for
    inside, drained = [], [False]

    def timed_allocate(self, positions):
        if drained[0]:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = allocate(self, positions)
        inside.append(time.perf_counter() - t0)
        return out

    PagedKVCache.allocate_for = timed_allocate
    with torch.inference_mode():
        positions = torch.where(mask > 0, mask.cumsum(dim=-1) - 1, -1)
        logits, cache = model(ids, positions, cache=cache)
        tok = logits[torch.arange(b, device=dev), mask.sum(dim=-1) - 1].argmax(-1)[:, None]
        del logits

        def turn(drain):
            nonlocal tok, cache
            drained[0] = drain
            inside.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                out, cache = model(tok, cache.lengths[:, None], cache=cache)
                tok = out[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / STEPS, 1e3 * sorted(inside)[STEPS // 2]

        turn(False)  # warm-up
        for drain in TURNS:
            step_ms, inside_ms = turn(drain)
            print(f"[pool check] {'drained' if drain else 'queued'} turn: {step_ms:.3f} ms a "
                  f"step, {inside_ms:.4f} ms inside allocate_for (median of {STEPS})", flush=True)
    PagedKVCache.allocate_for = allocate


if __name__ == "__main__":
    main()
