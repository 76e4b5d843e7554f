"""CLIP byte-BPE tokenizer, numpy only (copy of
paddlemix_tpu/models/clip/tokenizer.py, which cannot be imported without jax).

Lowercase, whitespace cleanup, byte-level BPE with </w> word-end markers,
start/end specials. Loads HF-format vocab.json + merges.txt from a directory."""

from __future__ import annotations

import functools
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 bos_token: str = "<|startoftext|>", eos_token: str = "<|endoftext|>",
                 pad_token: Optional[str] = None, model_max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token, self.eos_token = bos_token, eos_token
        self.pad_token = pad_token or eos_token
        self.model_max_length = model_max_length
        self.cache: Dict[str, str] = {}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[\d]|[^\s\w\d]+""",
            re.IGNORECASE,
        )

    @property
    def bos_token_id(self) -> int:
        return self.encoder[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.encoder[self.pad_token]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, **kwargs):
        root = os.path.join(path, subfolder) if subfolder else path
        with open(os.path.join(root, "vocab.json")) as f:
            vocab = json.load(f)
        merges_path = os.path.join(root, "merges.txt")
        if not os.path.exists(merges_path):
            merges_path += ".gz"
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#") and len(l.split()) == 2]
        cfg_path = os.path.join(root, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            for k in ("model_max_length", "bos_token", "eos_token", "pad_token"):
                if k in cfg and k not in kwargs and isinstance(cfg[k], (int, str)):
                    kwargs[k] = cfg[k]
        return cls(vocab, merges, **kwargs)

    def save_pretrained(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump(self.encoder, f)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({"model_max_length": self.model_max_length,
                       "bos_token": self.bos_token, "eos_token": self.eos_token,
                       "pad_token": self.pad_token}, f)
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in merges:
                f.write(f"{a} {b}\n")

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word) if len(word) > 1 else set()
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = basic_clean(text).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" ") if t in self.encoder)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts, max_length: Optional[int] = None, padding: str = "max_length",
                 truncation: bool = True) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        all_ids, all_mask = [], []
        for t in texts:
            ids = [self.bos_token_id] + self.encode(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            all_ids.append(ids)
            all_mask.append(mask)
        if padding != "max_length":
            longest = max(len(i) for i in all_ids)
            all_ids = [i + [self.pad_token_id] * (longest - len(i)) for i in all_ids]
            all_mask = [m + [0] * (longest - len(m)) for m in all_mask]
        return {
            "input_ids": np.asarray(all_ids, dtype=np.int32),
            "attention_mask": np.asarray(all_mask, dtype=np.int32),
        }


def byte_level_tokenizer(model_max_length: int = 77) -> CLIPTokenizer:
    """CLIP tokenizer over a byte-level vocab (every byte, with and without
    the </w> word end, plus the specials) and no merges: no vocab file needed."""
    vocab = {}
    for s in bytes_to_unicode().values():
        vocab[s] = len(vocab)
        vocab[s + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return CLIPTokenizer(vocab, [], model_max_length=model_max_length)
