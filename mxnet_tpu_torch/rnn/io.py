"""Bucketed sequences: ``encode_sentences`` and ``BucketSentenceIter``,
which feeds ``BucketingModule``.

Counterpart of ``mxnet_tpu/rnn/io.py``, the same batches from the same
seed; each batch's arrays are made on the CPU, and a module moves them
to its device.
"""
from __future__ import annotations

import logging
import random as pyrandom

import numpy as onp

from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import array

_log = logging.getLogger("mxnet_tpu_torch.rnn.io")

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Token lists -> id lists, building/extending the vocab
    (ref: rnn/io.py encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
        idx = max(max(vocab.values()) + 1, idx)
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token:
                        word = unknown_token
                    else:
                        raise ValueError(f"Unknown token {word}")
                if idx == invalid_label:
                    idx += 1
                if word not in vocab:
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pad each sentence to its bucket length, batch per bucket
    (ref: rnn/io.py BucketSentenceIter — the BucketingModule feeder)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT", shuffle=True, seed=0):
        super().__init__(batch_size)
        if not buckets:
            lens = onp.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets = sorted(buckets)
        self.buckets = buckets
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = next((i for i, b in enumerate(buckets)
                         if b >= len(sent)), None)
            if buck is None:
                ndiscard += 1
                continue
            buff = onp.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [onp.asarray(x, dtype=dtype) for x in self.data]
        if ndiscard:
            _log.warning("discarded %d sentences longer than the "
                         "largest bucket (%d)", ndiscard, buckets[-1])
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.layout = layout
        self.shuffle = shuffle
        self._rng = pyrandom.Random(seed)
        self.default_bucket_key = max(buckets)
        self.reset()

    def _shape(self, T):
        return (T, self.batch_size) if self.layout.startswith("T") \
            else (self.batch_size, T)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         self._shape(self.default_bucket_key))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         self._shape(self.default_bucket_key))]

    def reset(self):
        """Re-plan the epoch: (bucket, offset) pairs, shuffled."""
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend((i, j) for j in
                            range(0, len(buck) - self.batch_size + 1,
                                  self.batch_size))
        if self.shuffle:
            self._rng.shuffle(self.idx)
            for i, buck in enumerate(self.data):
                # permute ROWS via an index array: python shuffle on a
                # 2D numpy array swaps views and duplicates rows
                perm = onp.asarray(
                    self._rng.sample(range(len(buck)), len(buck)),
                    dtype=onp.int64)
                self.data[i] = buck[perm]
        self.curr_idx = 0

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[i][j:j + self.batch_size]
        # next-token labels; last position padded with invalid_label
        label = onp.full_like(data, self.invalid_label)
        label[:, :-1] = data[:, 1:]
        bucket = self.buckets[i]
        if self.layout.startswith("T"):  # TN: time-major
            data, label = data.T, label.T
            shape = (bucket, self.batch_size)
        else:
            shape = (self.batch_size, bucket)
        return DataBatch(
            data=[array(onp.ascontiguousarray(data), ctx=cpu())],
            label=[array(onp.ascontiguousarray(label), ctx=cpu())], pad=0,
            bucket_key=bucket,
            provide_data=[DataDesc(self.data_name, shape)],
            provide_label=[DataDesc(self.label_name, shape)])

    def iter_next(self):
        raise NotImplementedError  # next() is overridden directly
