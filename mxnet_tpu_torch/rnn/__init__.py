"""Symbolic RNN package (counterpart of ``mxnet_tpu/rnn/``): the
``mx.rnn`` cells, which build Symbols, and the bucketed sentence
iterator."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell,  # noqa: F401
                       GRUCell, FusedRNNCell, SequentialRNNCell,
                       BidirectionalCell, DropoutCell)
from .io import BucketSentenceIter, encode_sentences  # noqa: F401
