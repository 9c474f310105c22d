"""Byte-level BPE tokenizer: the text end of the port's fine-tune path
(text -> ids -> ``train/data.pack_documents`` -> ``Trainer``), the same
merges and ids as the JAX package's ``train/tokenizer.py``; no external
vocab files.

- **byte-level**: the base alphabet is all 256 bytes, so any unicode
  text round-trips losslessly (decode(encode(s)) == s, no <unk>);
- **BPE**: merges are learned by iterated most-frequent-pair counting
  over whitespace-delimited chunks (word-internal merges only, the
  GPT-2 constraint that keeps merges from crossing word boundaries);
- **special ids**: 0 <pad> (``pack_documents``' default pad_id), 1 <bos>,
  2 <eos>; byte tokens occupy 3..258, learned merges from 259, so a
  trained vocab_size of V yields V - 259 merges.

Pure Python, deterministic, JSON-serialisable; sized for the
documentation-scale corpora a notebook fine-tune starts from.

    python -m odh_kubeflow_tpu_torch.train.tokenizer train --corpus 'docs/*.md' --out tok.json
    python -m odh_kubeflow_tpu_torch.train.tokenizer encode --tokenizer tok.json "text"
"""

from __future__ import annotations

import collections
import json
import re
from typing import Iterable, Optional

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_N_SPECIAL = 3
_BYTE0 = _N_SPECIAL  # token id of byte 0x00
MIN_VOCAB = _N_SPECIAL + 256

# chunking: runs of word chars (with one leading space, GPT-2 style, so
# " the" and "the" learn distinct merges), runs of digits, runs of
# punctuation, runs of whitespace
_CHUNK_RE = re.compile(
    r" ?[^\s\d\W]+| ?\d+| ?[^\w\s]+|\s+", re.UNICODE
)


class Tokenizer:
    """``merges`` is an ordered list of (left_id, right_id) pairs; rank
    = priority (earlier merges first), merged token id = 259 + rank."""

    def __init__(self, merges: list[tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self._rank = {m: i for i, m in enumerate(self.merges)}
        # decode table: id -> bytes
        self._bytes: list[bytes] = [b""] * self.vocab_size
        for b in range(256):
            self._bytes[_BYTE0 + b] = bytes([b])
        for i, (a, b) in enumerate(self.merges):
            self._bytes[MIN_VOCAB + i] = self._bytes[a] + self._bytes[b]

    @property
    def vocab_size(self) -> int:
        return MIN_VOCAB + len(self.merges)

    # -- encode/decode ------------------------------------------------------

    def _encode_chunk(self, chunk: bytes) -> list[int]:
        ids = [_BYTE0 + b for b in chunk]
        while len(ids) > 1:
            # lowest-rank applicable merge anywhere in the chunk
            best_rank, best_i = None, -1
            for i in range(len(ids) - 1):
                r = self._rank.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            ids[best_i:best_i + 2] = [MIN_VOCAB + best_rank]
        return ids

    def encode(
        self, text: str, bos: bool = False, eos: bool = False
    ) -> list[int]:
        ids: list[int] = [BOS_ID] if bos else []
        for chunk in _CHUNK_RE.findall(text):
            ids.extend(self._encode_chunk(chunk.encode("utf-8")))
        if eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out = b"".join(
            self._bytes[i]
            for i in ids
            if _BYTE0 <= i < self.vocab_size
        )
        return out.decode("utf-8", errors="replace")

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "version": 1,
                    "type": "byte-bpe",
                    "vocab_size": self.vocab_size,
                    "merges": self.merges,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with open(path) as f:
            blob = json.load(f)
        if blob.get("type") != "byte-bpe":
            raise ValueError(f"not a byte-bpe tokenizer file: {path}")
        return cls([tuple(m) for m in blob["merges"]])


def train_bpe(
    texts: Iterable[str],
    vocab_size: int,
    min_pair_count: int = 2,
) -> Tokenizer:
    """Learn a byte-level BPE vocab of ``vocab_size`` total ids.

    Standard counting loop over unique chunks (words) weighted by
    frequency: each round merges the globally most frequent adjacent
    pair (ties broken by pair id for determinism) and rewrites only the
    words containing it. Stops early when no pair reaches
    ``min_pair_count`` — merges memorising one rare string are worse
    than a shorter vocab.
    """
    if vocab_size < MIN_VOCAB:
        raise ValueError(
            f"vocab_size must be >= {MIN_VOCAB} (256 bytes + "
            f"{_N_SPECIAL} specials), got {vocab_size}"
        )
    word_counts: collections.Counter = collections.Counter()
    for text in texts:
        for chunk in _CHUNK_RE.findall(text):
            word_counts[chunk.encode("utf-8")] += 1
    # each unique word as a mutable id sequence + its corpus frequency
    words = [
        ([_BYTE0 + b for b in w], c) for w, c in word_counts.items()
    ]

    merges: list[tuple[int, int]] = []
    while MIN_VOCAB + len(merges) < vocab_size:
        pair_counts: collections.Counter = collections.Counter()
        for ids, c in words:
            for i in range(len(ids) - 1):
                pair_counts[(ids[i], ids[i + 1])] += c
        if not pair_counts:
            break
        (a, b), count = min(
            pair_counts.items(), key=lambda kv: (-kv[1], kv[0])
        )
        if count < min_pair_count:
            break
        new_id = MIN_VOCAB + len(merges)
        merges.append((a, b))
        for ids, _ in words:
            i = 0
            while i < len(ids) - 1:
                if ids[i] == a and ids[i + 1] == b:
                    ids[i:i + 2] = [new_id]
                else:
                    i += 1
    return Tokenizer(merges)


def corpus_from_files(paths: Iterable[str]) -> list[str]:
    out = []
    for p in paths:
        with open(p, encoding="utf-8", errors="ignore") as f:
            out.append(f.read())
    return out


def sections(text: str) -> list[str]:
    """``text`` cut before every line that starts with "#" (a markdown
    heading): one document per section, nothing dropped."""
    cuts = [0] + [m.start() + 1 for m in re.finditer(r"\n#", text)]
    return [text[a:b] for a, b in zip(cuts, cuts[1:] + [len(text)]) if a < b]


def main(argv: Optional[list[str]] = None) -> int:
    """The CLI: ``train --corpus GLOB --vocab-size N --out FILE`` or
    ``encode --tokenizer FILE TEXT``."""
    import argparse
    import glob

    ap = argparse.ArgumentParser(prog="tokenizer")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--corpus", required=True, help="glob of text files")
    t.add_argument("--vocab-size", type=int, default=1024)
    t.add_argument("--out", required=True)
    e = sub.add_parser("encode")
    e.add_argument("--tokenizer", required=True)
    e.add_argument("text")
    args = ap.parse_args(argv)

    if args.cmd == "train":
        paths = sorted(glob.glob(args.corpus, recursive=True))
        if not paths:
            ap.error(f"no files match {args.corpus!r}")
        tok = train_bpe(corpus_from_files(paths), args.vocab_size)
        tok.save(args.out)
        print(
            f"trained vocab_size={tok.vocab_size} "
            f"({len(tok.merges)} merges) from {len(paths)} files -> {args.out}"
        )
    else:
        tok = Tokenizer.load(args.tokenizer)
        print(tok.encode(args.text))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
