"""CLIP BPE tokenizer, BERT WordPiece tokenizer (GroundingDINO's captions)
and a hash tokenizer for tests (counterpart of
``tweediemix_tpu/utils/tokenizer.py``, copied so that the port imports
nothing of the JAX package).

The reference relies on HF ``CLIPTokenizer`` with ``padding="max_length",
max_length=77`` and ``tokenizer.add_tokens(modifier)`` for the
``<new1>``-style modifier tokens. This implementation matches that contract:
BOS + tokens + EOS, truncated to 77, padded with a configurable pad id
(SDXL: tokenizer 1 pads with EOS=49407, tokenizer 2 pads with "!"=0);
added tokens are matched whole-word before BPE. It reads ``vocab.json`` and
``merges.txt`` (or ``merges.txt.gz``) from a local checkpoint directory.

The upstream tokenizer also runs ftfy text fixing and a unicode-category
regex; this one covers the ASCII prompt space of the sample scripts exactly
and approximates \\p{L}/\\p{N} with python re classes for other scripts.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2/CLIP reversible byte→unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_TOKEN_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE,
)


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class CLIPBPETokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[str],
        max_length: int = 77,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        pad_token: Optional[str] = None,  # None → pad with EOS (SDXL tokenizer 1)
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = [tuple(m.split()) for m in merges if m and not m.startswith("#")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.max_length = max_length
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self.pad_token_id = (
            self.encoder[pad_token] if pad_token is not None else self.eos_token_id
        )
        self.added_tokens: Dict[str, int] = {}
        self.cache = {bos_token: bos_token, eos_token: eos_token}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPBPETokenizer":
        """Load from an HF-layout tokenizer dir (vocab.json + merges.txt)."""
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges_path = os.path.join(path, "merges.txt")
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
        else:
            with gzip.open(os.path.join(path, "merges.txt.gz"), "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [m for m in merges if m.strip()]
        # read pad token from tokenizer_config.json when present
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if "pad_token" not in kw and os.path.exists(cfg_path):
            with open(cfg_path) as f:
                tc = json.load(f)
            pad = tc.get("pad_token")
            if isinstance(pad, dict):
                pad = pad.get("content")
            if pad in vocab:
                kw["pad_token"] = pad
        return cls(vocab, merges, **kw)

    # -- core BPE -------------------------------------------------------------

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
            new_word = []
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

    def _encode_word(self, token: str) -> List[int]:
        if token in self.added_tokens:
            return [self.added_tokens[token]]
        btok = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
        return [self.encoder[t] for t in self.bpe(btok).split(" ") if t in self.encoder]

    # -- public API -----------------------------------------------------------

    def add_tokens(self, tokens) -> int:
        """Append whole-word tokens (modifier tokens like <cat1>). Returns
        the number of tokens added; ids continue after the current vocab."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for t in tokens:
            if t in self.added_tokens or t in self.encoder:
                continue
            tid = len(self.encoder) + len(self.added_tokens)
            self.added_tokens[t] = tid
            added += 1
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.encoder.get(token, self.eos_token_id)

    def __len__(self):
        return len(self.encoder) + len(self.added_tokens)

    def encode(self, text: str) -> List[int]:
        """BOS + BPE ids + EOS, truncated/padded to max_length."""
        text = basic_clean(text)
        ids: List[int] = []
        # split out added tokens first (whole-word, whitespace-delimited)
        for chunk in text.split(" "):
            if not chunk:
                continue
            if chunk in self.added_tokens:
                ids.append(self.added_tokens[chunk])
                continue
            for tok in _TOKEN_PATTERN.findall(chunk):
                ids.extend(self._encode_word(tok))
        ids = ids[: self.max_length - 2]
        full = [self.bos_token_id] + ids + [self.eos_token_id]
        full += [self.pad_token_id] * (self.max_length - len(full))
        return full

    def __call__(self, texts) -> "list[list[int]]":
        if isinstance(texts, str):
            texts = [texts]
        return [self.encode(t) for t in texts]


class HashTokenizer:
    """Deterministic word-hash tokenizer for tests (no vocab files).

    Implements the same contract (77-length BOS/EOS/pad rows, add_tokens,
    convert_tokens_to_ids) over a fixed-size id space.
    """

    def __init__(self, vocab_size: int = 1000, max_length: int = 77,
                 pad_with_eos: bool = True):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = self.eos_token_id if pad_with_eos else 0
        self.added_tokens: Dict[str, int] = {}
        self._base = vocab_size

    def add_tokens(self, tokens) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for t in tokens:
            if t not in self.added_tokens:
                self.added_tokens[t] = self._base + len(self.added_tokens)
                added += 1
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        import zlib

        return zlib.crc32(token.encode()) % (self.vocab_size - 2)

    def __len__(self):
        return self._base + len(self.added_tokens)

    def encode(self, text: str):
        words = basic_clean(text).split(" ")
        ids = [self.convert_tokens_to_ids(w) for w in words if w]
        ids = ids[: self.max_length - 2]
        full = [self.bos_token_id] + ids + [self.eos_token_id]
        full += [self.pad_token_id] * (self.max_length - len(full))
        return full

    def __call__(self, texts):
        if isinstance(texts, str):
            texts = [texts]
        return [self.encode(t) for t in texts]


class BertWordPieceTokenizer:
    """BERT WordPiece tokenizer (uncased) for GroundingDINO's captions
    (``models/dino.py``): lowercase, NFD with the accents (category Mn)
    dropped, split at whitespace, punctuation and CJK ideographs, control
    characters dropped, then greedy longest-match pieces (``##`` inside a
    word, ``[UNK]`` for a word that does not split or is longer than 100
    characters), wrapped in ``[CLS]``/``[SEP]``. Reads the checkpoint's
    ``vocab.txt`` (bert-base-uncased's layout: one token per line, its id
    the line number)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.unk_id = vocab["[UNK]"]

    @classmethod
    def from_dir(cls, path: str) -> "BertWordPieceTokenizer":
        """``path`` is a directory holding ``vocab.txt``, or the file."""
        vf = path if path.endswith("vocab.txt") else os.path.join(path, "vocab.txt")
        with open(vf, encoding="utf-8") as f:
            vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        return cls(vocab)

    @staticmethod
    def _basic(text: str) -> List[str]:
        text = unicodedata.normalize("NFD", text.lower())
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out, cur = [], []
        for ch in text:
            cat = unicodedata.category(ch)
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif cat.startswith("P") or (0x4E00 <= ord(ch) <= 0x9FFF):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            elif cat.startswith("C"):
                continue
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk_id]
            ids.append(piece)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids = [self.cls_id]
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
        ids.append(self.sep_id)
        return ids

    def __call__(self, texts) -> List[List[int]]:
        if isinstance(texts, str):
            texts = [texts]
        return [self.encode(t) for t in texts]
