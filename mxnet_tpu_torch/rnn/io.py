"""Bucketed sentence iterator (counterpart of ``mxnet_tpu/rnn/io.py``):
variable-length sentences grouped into buckets of fixed length, so each
bucket is one static shape, and ``encode_sentences``, which maps words
to ids.

``BucketSentenceIter`` keeps the JAX package's draws: ``reset`` shuffles
the batch order with Python's ``random.shuffle`` and each bucket's rows
with ``numpy.random.shuffle``, so under the same seeds of both
generators both packages give the same batches. Batches are CPU tensors
(as ``NDArrayIter``'s); the module copies them to its device.
"""
from __future__ import annotations

import logging
import random as _pyrandom

import numpy as _np
import torch

from ..io.io import DataBatch, DataDesc

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Sentences of words as lists of ids, and the vocabulary. Without
    ``vocab`` a new one is built, ids counted up from ``start_label``
    and skipping ``invalid_label`` (which ``invalid_key`` takes); with
    one, an unknown word takes ``unknown_token``'s id, or raises when
    there is none."""
    new_vocab = vocab is None
    if new_vocab:
        vocab = {invalid_key: invalid_label}
    idx = start_label
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not (new_vocab or unknown_token):
                    raise KeyError("Unknown token %r" % (word,))
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter:
    """Batches of sentences padded with ``invalid_label`` to their
    bucket's length; a sentence longer than the largest bucket is
    discarded (counted in ``ndiscard``). Labels are the data shifted one
    step left. Without ``buckets``, every length that at least
    ``batch_size`` sentences have is a bucket."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        if not buckets:
            lens = _np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens) if n >= batch_size]
        buckets.sort()
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = _np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket", ndiscard)
        self.ndiscard = ndiscard
        # 2-D even when a bucket holds no sentence
        self.data = [_np.asarray(x, dtype=dtype).reshape(-1, blen)
                     for x, blen in zip(self.data, buckets)]
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)
        shape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(torch.from_numpy(buck.copy()))
            self.ndlabel.append(torch.from_numpy(label))

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.t(), label.t()
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
