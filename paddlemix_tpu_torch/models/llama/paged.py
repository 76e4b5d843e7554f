"""Paged (blocked) KV cache for serving (port of paddlemix_tpu/models/llama/paged.py).

The KV pool is an arena of fixed-size blocks; sequences own blocks through a
block table and take them as they grow, so a batch of mixed-length sequences
shares device memory instead of each reserving max_len. Allocation is the
JAX package's: one cumsum over the "needs a block at this step" flags in flat
(sequence, entry) order, on the device, so the block tables equal JAX's. The
pool is written in place (JAX returns a new one). Decode attention reads the
pool through the tables (B9, `ops.paged_attention`); the prefill reads the
dense gather `layer_view`.

Where the port parts from the reference: the pool has one block more than
`num_blocks`, index `num_blocks`, which nothing allocates, and padded
positions (-1) write there, as the dense `KVCache` parks them in its last
slot. The JAX cache parks them at row bs - 1 of pool block 0, which
`allocate_for` gives to the first sequence: a right-padded batch overwrites
that sequence's key and value at position bs - 1 in every layer. Every block
table and every live key equals JAX's wherever that write does not land on a
live slot; where it does, the port keeps the sequence's own key.

Pool layout (layers, num_blocks + 1, kv_heads, block_size, head_dim): one
(block, head) tile is a contiguous block_size x head_dim run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .configuration import LlamaConfig


def blocks_needed(prompt_lengths: Sequence[int], max_new_tokens: int, block_size: int) -> int:
    """Pool blocks a batch needs: sum_i ceil((len_i + max_new_tokens) / bs)."""
    return sum(-(-(n + max_new_tokens) // block_size) for n in prompt_lengths)


@dataclasses.dataclass
class PagedKVCache:
    k_pool: torch.Tensor         # (layers, num_blocks + 1, kvh, block_size, hd)
    v_pool: torch.Tensor
    block_tables: torch.Tensor   # (B, max_blocks_per_seq) int32, -1 = unassigned
    lengths: torch.Tensor        # (B,) int32 tokens written per sequence
    num_allocated: torch.Tensor  # () int32, the pool watermark

    @classmethod
    def create(cls, config: LlamaConfig, batch: int, num_blocks: int, block_size: int = 128,
               max_blocks_per_seq: Optional[int] = None, dtype=torch.bfloat16,
               device="cuda") -> "PagedKVCache":
        max_blocks_per_seq = max_blocks_per_seq or num_blocks
        shape = (config.num_hidden_layers, num_blocks + 1, config.kv_heads, block_size,
                 config.head_dim_)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((batch, max_blocks_per_seq), -1, dtype=torch.int32, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[3]

    @property
    def num_blocks(self) -> int:
        """Allocatable blocks (the parking block not counted)."""
        return self.k_pool.shape[1] - 1

    @property
    def max_len(self) -> int:
        return self.block_tables.shape[1] * self.block_size

    def allocate_for(self, positions) -> "PagedKVCache":
        """Assign pool blocks so that every position in `positions` (B, S; -1 =
        padding) has a home, in place. Call once per step, before `update`.
        Raises ValueError, changing nothing, if the pool is too small."""
        bs = self.block_size
        b, max_blocks = self.block_tables.shape
        valid = positions >= 0
        # highest table entry each sequence needs after this write
        need_upto = torch.where(valid.any(dim=1),
                                torch.where(valid, positions, 0).amax(dim=1) // bs, -1)
        entry = torch.arange(max_blocks, device=positions.device)[None, :]
        need = (entry <= need_upto[:, None]) & (self.block_tables < 0)
        order = need.reshape(-1).cumsum(0) - 1  # flat allocation order
        new_ids = (self.num_allocated + order).reshape(b, max_blocks).int()
        taken = self.num_allocated + need.sum().int()
        # an id at or past num_blocks would be read and written out of bounds
        # on the card (JAX clamps it): refuse, at the cost of one host sync a step
        if int(taken) > self.num_blocks:
            raise ValueError(f"PagedKVCache.allocate_for: the step needs {int(taken)} blocks, "
                             f"the pool has {self.num_blocks}")
        self.block_tables = torch.where(need, new_ids, self.block_tables)
        self.num_allocated = taken
        return self

    def update(self, layer_idx: int, k, v, positions) -> None:
        """Write k/v (B, S, kvh, hd) at `positions` (B, S) in place; padding
        (-1) goes to the parking block."""
        bs = self.block_size
        safe = positions.clamp(min=0).long()
        blk = self.block_tables.gather(1, safe // bs).long()
        is_pad = positions < 0
        blk = torch.where(is_pad, self.num_blocks, blk).reshape(-1)
        off = torch.where(is_pad, 0, safe % bs).reshape(-1)
        kp, vp = self.k_pool[layer_idx], self.v_pool[layer_idx]
        kp[blk, :, off] = k.reshape(-1, *k.shape[2:]).to(kp.dtype)
        vp[blk, :, off] = v.reshape(-1, *v.shape[2:]).to(vp.dtype)

    def layer_view(self, layer_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (B, max_len, kvh, hd) gather of each sequence's blocks (-1
        read as block 0), what the prefill attends over."""
        b, max_blocks = self.block_tables.shape
        tables = self.block_tables.clamp(min=0).long()

        def gather(pool):
            x = pool[layer_idx][tables]  # (B, max_blocks, kvh, bs, hd)
            _, _, kvh, bs, hd = x.shape
            return x.transpose(2, 3).reshape(b, max_blocks * bs, kvh, hd)
        return gather(self.k_pool), gather(self.v_pool)


@torch.inference_mode()
def paged_greedy_generate(model, input_ids, attention_mask=None, max_new_tokens: int = 32,
                          block_size: int = 128, num_blocks: Optional[int] = None,
                          eos_token_id: Optional[int] = None):
    """Greedy generation over the paged cache (port of `paged_greedy_generate`):
    one prefill, then one cached forward a token, blocks taken as the
    sequences grow. input_ids (B, S) right-padded, attention_mask 0 on
    padding. `num_blocks` defaults to the worst case, B * ceil((S +
    max_new_tokens) / block_size); a smaller pool must still hold what the
    batch needs (`blocks_needed`, from the mask on the host), else this
    raises before allocating: a block id past the pool would be read out of
    bounds on the card. Returns (B, max_new_tokens) int32; after every
    sequence has made eos the rest stay 0, as in JAX."""
    eos = model.config.eos_token_id if eos_token_id is None else eos_token_id
    dev = model.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    mask = (torch.ones((b, s), dtype=torch.int32, device=dev) if attention_mask is None
            else attention_mask.to(dev).int())
    max_blocks_per_seq = -(-(s + max_new_tokens) // block_size)
    if num_blocks is None:
        num_blocks = b * max_blocks_per_seq
    prompt_lengths = mask.sum(dim=-1)
    need = blocks_needed(prompt_lengths.tolist(), max_new_tokens, block_size)
    if num_blocks < need:
        raise ValueError(f"paged_greedy_generate: num_blocks {num_blocks} < {need}, the blocks "
                         f"of block size {block_size} this batch needs for {max_new_tokens} "
                         f"new tokens")
    cache = PagedKVCache.create(model.config, b, num_blocks, block_size, max_blocks_per_seq,
                                dtype=model.dtype, device=dev)
    positions = torch.where(mask > 0, mask.cumsum(dim=-1) - 1, -1)
    logits, cache = model(input_ids, positions, cache=cache)
    last = logits[torch.arange(b, device=dev), prompt_lengths - 1]
    tokens = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
    tokens[:, 0] = last.float().argmax(dim=-1)
    done = tokens[:, 0] == eos
    for step in range(max_new_tokens - 1):
        if eos >= 0 and bool(done.all()):
            break
        logits, cache = model(tokens[:, step:step + 1], cache.lengths[:, None], cache=cache)
        nxt = logits[:, -1].float().argmax(dim=-1).int()
        tokens[:, step + 1] = torch.where(done, eos, nxt)
        done |= tokens[:, step + 1] == eos
    return tokens
