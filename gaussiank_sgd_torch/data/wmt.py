"""WMT parallel-corpus data (port of ``gaussiank_sgd_tpu/data/wmt.py``): a
joint byte-pair-encoding tokenizer and the paired-text reader.

Real data under ``data_dir``: ``train.en``/``train.de`` and
``val.en``/``val.de``, one sentence a line, parallel. The BPE vocabulary is
learned on the train split, both languages pooled: characters plus an
end-of-word marker, then the most frequent adjacent pair merged (ties to
the larger pair) until ``vocab_size`` symbols. Special ids: PAD = 0 (also
the loss's mask id), UNK = 1, EOS = 2.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD_ID = 0
UNK_ID = 1
EOS_ID = 2
_EOW = "</w>"                     # end-of-word marker symbol
_SPECIALS = ("<pad>", "<unk>", "<eos>")


class BPETokenizer:
    """Minimal byte-pair-encoding tokenizer (train / encode / decode).

    ``merges`` is an ordered list of symbol pairs; encoding applies them
    greedily by learned rank (lowest rank first), the classic BPE inference
    rule, so encode is deterministic given (vocab, merges).
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self.ranks = {pair: i for i, pair in enumerate(self.merges)}
        self.inv_vocab = {i: s for s, i in self.vocab.items()}
        self._word_cache: Dict[str, List[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---- training ----
    @classmethod
    def train(cls, lines: Iterable[str], vocab_size: int,
              max_lines: int = 50_000) -> "BPETokenizer":
        """Learn merges from a corpus until the vocab holds ``vocab_size``
        symbols (specials + characters + merge products). ``max_lines``
        bounds training cost on large corpora — BPE statistics saturate
        long before that on natural text."""
        word_freq: Counter = Counter()
        for i, line in enumerate(lines):
            if i >= max_lines:
                break
            word_freq.update(line.split())
        if not word_freq:
            raise ValueError("empty training corpus for BPE")
        # words as symbol tuples, chars + end-of-word marker
        words = {w: tuple(w) + (_EOW,) for w in word_freq}
        symbols = {c for sym in words.values() for c in sym}
        vocab = {s: i for i, s in enumerate(_SPECIALS)}
        for s in sorted(symbols):
            vocab[s] = len(vocab)

        # incremental pair statistics: each merge touches only the words
        # that contain the merged pair — O(corpus) total instead of a full
        # corpus re-scan per merge, which is what makes a 32k-merge vocab
        # tractable on a real WMT-sized corpus
        pair_freq: Counter = Counter()
        pair_words: Dict[Tuple[str, str], set] = {}
        for w, sym in words.items():
            f = word_freq[w]
            for pair in zip(sym, sym[1:]):
                pair_freq[pair] += f
                pair_words.setdefault(pair, set()).add(w)

        merges: List[Tuple[str, str]] = []
        while len(vocab) < vocab_size and pair_freq:
            # deterministic tie-break: frequency desc, then lexicographic
            (a, b), top_f = max(pair_freq.items(),
                                key=lambda kv: (kv[1], kv[0]))
            if top_f <= 0:
                break
            merged = a + b
            merges.append((a, b))
            vocab[merged] = len(vocab)
            for w in list(pair_words.get((a, b), ())):
                sym, f = words[w], word_freq[w]
                for pair in zip(sym, sym[1:]):      # retire old pair counts
                    pair_freq[pair] -= f
                    if pair_freq[pair] <= 0:
                        del pair_freq[pair]
                    ws = pair_words.get(pair)
                    if ws is not None:
                        ws.discard(w)
                out, i = [], 0
                while i < len(sym):
                    if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(sym[i])
                        i += 1
                sym = tuple(out)
                words[w] = sym
                for pair in zip(sym, sym[1:]):      # account new pair counts
                    pair_freq[pair] += f
                    pair_words.setdefault(pair, set()).add(w)
        return cls(vocab, merges)

    # ---- inference ----
    def _encode_word(self, word: str) -> List[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        sym = list(word) + [_EOW]
        while len(sym) > 1:
            best, best_rank, best_i = None, None, -1
            for i, pair in enumerate(zip(sym, sym[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank, best_i = pair, r, i
            if best is None:
                break
            sym[best_i:best_i + 2] = [best[0] + best[1]]
        ids = [self.vocab.get(s, UNK_ID) for s in sym]
        self._word_cache[word] = ids
        return ids

    def encode(self, text: str, append_eos: bool = True) -> List[int]:
        ids: List[int] = []
        for w in text.split():
            ids.extend(self._encode_word(w))
        if append_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), "<unk>") for i in ids
                if int(i) not in (PAD_ID, EOS_ID)]
        return "".join(toks).replace(_EOW, " ").strip()


def _encode_corpus(tok: BPETokenizer, src_lines: Sequence[str],
                   tgt_lines: Sequence[str], src_len: int,
                   tgt_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Encode parallel lines to fixed [N, L] id arrays (truncate + pad).

    Pairs whose BOTH sides encode empty are dropped; everything else is
    kept (truncation over filtering: every batch has one fixed shape).
    """
    if len(src_lines) != len(tgt_lines):
        raise ValueError(
            f"parallel corpus sides differ: {len(src_lines)} src lines vs "
            f"{len(tgt_lines)} tgt lines")
    src_ids, tgt_ids = [], []
    for s, t in zip(src_lines, tgt_lines):
        es, et = tok.encode(s), tok.encode(t)
        if len(es) <= 1 and len(et) <= 1:      # both just <eos>: blank pair
            continue
        src_ids.append(es[:src_len])
        tgt_ids.append(et[:tgt_len])
    if not src_ids:
        raise ValueError("parallel corpus is empty after encoding")
    src = np.full((len(src_ids), src_len), PAD_ID, np.int32)
    tgt = np.full((len(tgt_ids), tgt_len), PAD_ID, np.int32)
    for i, ids in enumerate(src_ids):
        src[i, :len(ids)] = ids
    for i, ids in enumerate(tgt_ids):
        tgt[i, :len(ids)] = ids
    return src, tgt


def _read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def _interleave_files(*paths: str):
    """Yield lines from several files round-robin, lazily; shorter files
    drop out when exhausted."""
    files = [open(p, encoding="utf-8") for p in paths]
    try:
        while files:
            for f in list(files):
                line = f.readline()
                if not line:
                    files.remove(f)
                    f.close()
                    continue
                yield line.rstrip("\n")
    finally:
        for f in files:
            f.close()


_TOKENIZER_CACHE: Dict[Tuple[str, int], BPETokenizer] = {}


def load_wmt_corpus(data_dir: str, split: str, src_len: int, tgt_len: int,
                    vocab_size: int, src_lang: str = "en",
                    tgt_lang: str = "de"):
    """Read ``{split}.{src_lang}`` / ``{split}.{tgt_lang}`` under
    ``data_dir``, with a joint BPE vocab trained once per (data_dir,
    vocab_size) on the TRAIN split (never on val — no leakage of held-out
    text into the token inventory). Returns (src[N,S], tgt[N,T], tokenizer).
    """
    src_p = os.path.join(data_dir, f"{split}.{src_lang}")
    tgt_p = os.path.join(data_dir, f"{split}.{tgt_lang}")
    for p in (src_p, tgt_p):
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    key = (os.path.abspath(data_dir), vocab_size)
    tok = _TOKENIZER_CACHE.get(key)
    if tok is None:
        tr_src = os.path.join(data_dir, f"train.{src_lang}")
        tr_tgt = os.path.join(data_dir, f"train.{tgt_lang}")
        if not (os.path.exists(tr_src) and os.path.exists(tr_tgt)):
            raise FileNotFoundError(
                f"need train.{src_lang}/train.{tgt_lang} in {data_dir} to "
                f"build the BPE vocab (found only the {split} split)")
        # lazy round-robin over the two sides: train's max_lines cap then
        # samples BOTH languages evenly (a concatenated list would exhaust
        # the cap on the src side alone for a real-sized corpus) and only
        # the sampled prefix is ever held in memory
        tok = BPETokenizer.train(_interleave_files(tr_src, tr_tgt),
                                 vocab_size)
        _TOKENIZER_CACHE[key] = tok
    src, tgt = _encode_corpus(tok, _read_lines(src_p), _read_lines(tgt_p),
                              src_len, tgt_len)
    return src, tgt, tok
