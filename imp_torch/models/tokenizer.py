"""CLIP BPE tokenizer — a copy of ``imp_tpu/models/tokenizer.py`` for the
PyTorch port (it needs no framework: ``gzip``, ``html``, ``re`` and numpy).

A fresh implementation of the standard CLIP byte-pair-encoding scheme
(whitespace-normalized lowercased text, byte->unicode mapping, merges from
the public ``bpe_simple_vocab_16e6.txt.gz`` vocabulary, ``<|startoftext|>``
/ ``<|endoftext|>`` specials, context length 77) — the role of the
reference's vendored ``clip/simple_tokenizer.py`` + ``clip.tokenize``
(``clip/clip.py:185-221``).  The vocabulary file is not shipped; pass its
path (it ships with every public CLIP distribution).
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode mapping (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT, EOT])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}
        # ASCII approximation of CLIP's \p{L}/\p{N} classes (stdlib `re` has
        # no unicode property escapes; medical captions are ASCII).
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
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
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def decode(self, tokens: List[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def tokenize(
    texts, tokenizer: SimpleTokenizer, context_length: int = 77, truncate: bool = True
) -> np.ndarray:
    """texts -> [N, context_length] int32 (``clip.tokenize`` semantics)."""
    if isinstance(texts, str):
        texts = [texts]
    sot = tokenizer.encoder[SOT]
    eot = tokenizer.encoder[EOT]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        toks = [sot] + tokenizer.encode(text) + [eot]
        if len(toks) > context_length:
            if not truncate:
                raise RuntimeError(f"Input too long for context {context_length}")
            toks = toks[:context_length]
            toks[-1] = eot
        out[i, : len(toks)] = toks
    return out
