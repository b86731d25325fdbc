"""Parity of the port's text data (``gaussiank_sgd_torch/data``: the
synthetic token stream and copy-reverse pairs, PTB's vocabulary and bptt
windows, the WMT BPE tokenizer and reader) with the reference's
``gaussiank_sgd_tpu/data``. Everything here is numpy in, numpy out, so
every comparison is exact: arrays bit for bit, vocabularies, merges,
encodings and decodings equal."""

import numpy as np
import pytest

from gaussiank_sgd_tpu import data as jdata
from gaussiank_sgd_tpu.data import ptb as jptb
from gaussiank_sgd_tpu.data import synthetic as jsyn
from gaussiank_sgd_tpu.data import wmt as jwmt
from gaussiank_sgd_torch import data
from gaussiank_sgd_torch.data import ptb, synthetic, wmt

TEXT = ["the cat sat on the mat", "a dog and the cat", "",
        "she sells sea shells by the sea shore",
        "the quick brown fox jumps over the lazy dog"]
GERMAN = ["die katze sass auf der matte", "ein hund und die katze", "",
          "sie verkauft muscheln am meer", "der schnelle braune fuchs"]


def _epoch(ds, seed=None):
    return list(ds.epoch(epoch_seed=seed))


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("order,vocab", [(1, 300), (1, 10_000), (2, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_tokens_bit_for_bit(order, vocab, seed):
    got = synthetic.synthetic_tokens(4000, vocab, seed=seed, order=order)
    want = jsyn.synthetic_tokens(4000, vocab, seed=seed, order=order)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="vocab_size <= 512"):
        synthetic.synthetic_tokens(10, 513, order=2)
    with pytest.raises(ValueError, match="order 3"):
        synthetic.synthetic_tokens(10, 5, order=3)


def test_copy_reverse_pairs_bit_for_bit():
    for args in ((64, 16, 16, 100), (33, 12, 9, 32000)):
        got = synthetic.synthetic_seq2seq(*args, seed=3)
        want = jsyn.synthetic_seq2seq(*args, seed=3)
        for u, v in zip(got, want):
            assert u.dtype == v.dtype == np.int32
            np.testing.assert_array_equal(u, v)
        src, tgt = got
        np.testing.assert_array_equal(tgt, src[:, ::-1][:, :args[2]])
        assert src.min() >= 1


@pytest.mark.parametrize("batch,bptt", [(4, 7), (20, 35), (3, 1)])
def test_ptb_windows_bit_for_bit(batch, bptt):
    toks = jsyn.synthetic_tokens(3001, 97, seed=5)
    a, b = ptb.PTBDataset(toks, batch, bptt), jptb.PTBDataset(toks, batch,
                                                                bptt)
    assert a.steps_per_epoch == b.steps_per_epoch
    _same_batches(_epoch(a, 7), _epoch(b))
    x, y = next(iter(a.epoch()))
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])   # shifted by one
    with pytest.raises(ValueError, match="no bptt window"):
        ptb.PTBDataset(toks[:10], 5, 2)


@pytest.mark.parametrize("split", ["train", "valid"])
def test_make_ptb_synthetic_and_dispatch(split):
    kw = dict(batch_size=6, bptt=9, vocab_size=211, synthetic_tokens_n=5000)
    (a, va), (b, vb) = (ptb.make_ptb(None, split, **kw),
                        jptb.make_ptb(None, split, **kw))
    assert va == vb == 211
    _same_batches(_epoch(a), _epoch(b))
    (c, vc), (d, vd) = (data.make_dataset("ptb", None, split == "train", 6),
                        jdata.make_dataset("ptb", None, split == "train", 6))
    assert vc == vd == 10_000 and c.steps_per_epoch == d.steps_per_epoch
    _same_batches(_epoch(c)[:3], _epoch(d)[:3])


def test_ptb_vocab_and_ids_on_a_text_file(tmp_path):
    (tmp_path / "ptb.train.txt").write_text("\n".join(TEXT) + "\n")
    (tmp_path / "ptb.valid.txt").write_text(
        "the dog sat on a zebra\nunseen words here\n")
    vocab = ptb.build_vocab(str(tmp_path / "ptb.train.txt"))
    assert vocab == jptb.build_vocab(str(tmp_path / "ptb.train.txt"))
    assert vocab["the"] == 0 and "<eos>" in vocab
    for split in ("train", "valid"):
        path = str(tmp_path / f"ptb.{split}.txt")
        np.testing.assert_array_equal(ptb.tokenize(path, vocab),
                                      jptb.tokenize(path, vocab))
        (a, va), (b, vb) = (ptb.make_ptb(str(tmp_path), split, 2, 3),
                            jptb.make_ptb(str(tmp_path), split, 2, 3))
        assert va == vb == len(vocab)
        _same_batches(_epoch(a), _epoch(b))


def _corpus(d, splits=("train", "val")):
    for split in splits:
        (d / f"{split}.en").write_text("\n".join(TEXT) + "\n")
        (d / f"{split}.de").write_text("\n".join(GERMAN) + "\n")


@pytest.mark.parametrize("vocab_size", [40, 80, 400])
def test_bpe_train_encode_decode(tmp_path, vocab_size):
    lines = TEXT + GERMAN
    a = wmt.BPETokenizer.train(lines, vocab_size)
    b = jwmt.BPETokenizer.train(lines, vocab_size)
    assert a.vocab == b.vocab and a.merges == b.merges
    assert a.vocab_size == b.vocab_size <= vocab_size
    for line in lines + ["unseen wörds", "the the the"]:
        ids = a.encode(line)
        assert ids == b.encode(line) and ids[-1] == wmt.EOS_ID
        assert a.encode(line, append_eos=False) == b.encode(
            line, append_eos=False)
        assert a.decode(ids) == b.decode(ids)
        if set(line) <= set("".join(lines)):
            assert a.decode(ids) == " ".join(line.split())
    with pytest.raises(ValueError, match="empty"):
        wmt.BPETokenizer.train(["", " "], 10)


def test_wmt_reader_and_make_wmt(tmp_path):
    _corpus(tmp_path)
    got = wmt.load_wmt_corpus(str(tmp_path), "val", 12, 10, 60)
    want = jwmt.load_wmt_corpus(str(tmp_path), "val", 12, 10, 60)
    for u, v in zip(got[:2], want[:2]):
        assert u.dtype == v.dtype == np.int32
        np.testing.assert_array_equal(u, v)
    assert len(got[0]) == 4                           # the blank pair dropped
    assert got[2].vocab == want[2].vocab
    for train in (True, False):
        kw = dict(batch_size=2, src_len=12, tgt_len=10, vocab_size=60)
        (a, va), (b, vb) = (data.make_wmt(str(tmp_path), train, **kw),
                            jdata.make_wmt(str(tmp_path), train, **kw))
        assert va == vb
        _same_batches(_epoch(a, 11), _epoch(b, 11))
        (a, va), (b, vb) = (
            data.make_dataset("wmt", "synthetic", train, 8,
                              synthetic_examples=64),
            jdata.make_dataset("wmt14", "synthetic", train, 8,
                               synthetic_examples=64))
        assert va == vb == 32000
        _same_batches(_epoch(a, 3), _epoch(b, 3))


def test_partial_wmt_dataset_raises(tmp_path):
    """A directory with some ``*.en``/``*.de`` files but not the split
    asked for raises ``FileNotFoundError``, as the reference's does; so
    does a val split without the train split the vocabulary comes from."""
    _corpus(tmp_path, ("train",))
    for make in (data.make_wmt, jdata.make_wmt):
        with pytest.raises(FileNotFoundError, match="val.en"):
            make(str(tmp_path), train=False)
    only_val = tmp_path / "v"
    only_val.mkdir()
    _corpus(only_val, ("val",))
    for load in (wmt.load_wmt_corpus, jwmt.load_wmt_corpus):
        with pytest.raises(FileNotFoundError, match="train.en"):
            load(str(only_val), "val", 8, 8, 50)
    with pytest.raises(ValueError, match="unknown dataset"):
        data.make_dataset("nonesuch")
