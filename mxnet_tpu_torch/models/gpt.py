"""The GPT language model of ``examples/train_transformer_lm.py`` as a
Symbol: token embedding plus a learned ``pos_weight``, pre-LN causal
multi-head attention through ``contrib.FlashAttention``, a 4x ReLU MLP
and an untied head, under a ``SoftmaxOutput`` loss.

:func:`gpt_lm` takes the symbolic namespace it builds with, so the same
graph, with the same argument names, can be built by this package
(``mxnet_tpu_torch.sym``, the default) or by any package with the same
``sym`` surface.
"""
from __future__ import annotations

import numpy as np

__all__ = ["gpt_lm", "make_copy_batch"]


def gpt_lm(vocab, dim, num_heads, num_layers, seq_len, sym=None):
    """Symbol over ``data`` (B, T) token ids and ``softmax_label`` (B, T):
    the (B, T, vocab) softmax. The attention block is spelled as the
    fused-train-step tests spell it: one qkv projection reshaped to
    (B, T, H, 3, D), the three heads sliced off a (3, B, H, T, D)
    transpose."""
    if sym is None:
        from .. import symbol as sym
    if dim % num_heads:
        raise ValueError("dim %d not divisible by %d heads"
                         % (dim, num_heads))
    hd = dim // num_heads
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    tok = sym.Embedding(data, input_dim=vocab, output_dim=dim, name="tok")
    pos = sym.Variable("pos_weight", shape=(seq_len, dim))
    h = sym.broadcast_add(tok, sym.expand_dims(pos, axis=0))
    for i in range(num_layers):
        p = "blk%d_" % i
        a = sym.LayerNorm(h, name=p + "ln1")
        qkv = sym.FullyConnected(a, num_hidden=3 * dim, flatten=False,
                                 name=p + "qkv")
        qkv = sym.reshape(qkv, shape=(0, 0, num_heads, 3, hd))
        qkv = sym.transpose(qkv, axes=(3, 0, 2, 1, 4))     # (3, B, H, T, D)
        q, k, v = [sym.squeeze(sym.slice_axis(qkv, axis=0, begin=j,
                                              end=j + 1), axis=0)
                   for j in range(3)]
        o = sym.contrib.FlashAttention(q, k, v, causal=True)
        o = sym.reshape(sym.transpose(o, axes=(0, 2, 1, 3)),
                        shape=(0, 0, -3))
        h = h + sym.FullyConnected(o, num_hidden=dim, flatten=False,
                                   name=p + "proj")
        m = sym.LayerNorm(h, name=p + "ln2")
        m = sym.Activation(sym.FullyConnected(m, num_hidden=4 * dim,
                                              flatten=False,
                                              name=p + "mlp1"),
                           act_type="relu")
        h = h + sym.FullyConnected(m, num_hidden=dim, flatten=False,
                                   name=p + "mlp2")
    h = sym.LayerNorm(h, name="ln_f")
    logits = sym.FullyConnected(h, num_hidden=vocab, flatten=False,
                                name="head")
    return sym.SoftmaxOutput(logits, label, name="softmax")


def make_copy_batch(rng, batch, seq_len, vocab, lag):
    """The example's lag-``lag`` copy task: the target at position t is
    the input token at t - lag (0 before it), as f32 ids."""
    x = rng.randint(1, vocab, (batch, seq_len))
    y = np.zeros_like(x)
    y[:, lag:] = x[:, :-lag]
    return x.astype("f4"), y.astype("f4")
