"""The GPT of ``examples/train_transformer_lm.py`` (``:33-91``), class for
class, for any package with the Gluon surface.

``gpt_classes(mx, gluon, nn)`` returns ``(CausalSelfAttention, Block,
GPT)`` built on that package's ``gluon.HybridBlock``, ``nn`` layers and
``mx.initializer.Normal``, with the example's ``hybrid_forward`` bodies
unchanged, so the JAX package and the PyTorch port run the same model
by the same names. ``make_copy_batch`` is the example's lag-k copy task.
No package is imported here: tests and ``chip_smoke.py`` pass theirs.
"""
import numpy as np


def gpt_classes(mx, gluon, nn):
    class CausalSelfAttention(gluon.HybridBlock):
        def __init__(self, dim, num_heads, **kw):
            super().__init__(**kw)
            assert dim % num_heads == 0
            self._h = num_heads
            self._d = dim // num_heads
            with self.name_scope():
                self.qkv = nn.Dense(3 * dim, use_bias=True, flatten=False)
                self.proj = nn.Dense(dim, use_bias=True, flatten=False)

        def hybrid_forward(self, F, x):
            # x: (N, T, C)
            qkv = self.qkv(x)                                  # (N, T, 3C)
            q, k, v = F.split(qkv, num_outputs=3, axis=-1)

            def heads(t):   # (N, T, C) -> (N, H, T, D)
                t = F.reshape(t, shape=(0, 0, -4, self._h, self._d))
                return F.transpose(t, axes=(0, 2, 1, 3))
            out = F.contrib.FlashAttention(heads(q), heads(k), heads(v),
                                           causal=True)
            out = F.transpose(out, axes=(0, 2, 1, 3))          # (N, T, H, D)
            out = F.reshape(out, shape=(0, 0, -3))             # merge H*D
            return self.proj(out)

    class Block(gluon.HybridBlock):
        def __init__(self, dim, num_heads, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.ln1 = nn.LayerNorm()
                self.attn = CausalSelfAttention(dim, num_heads)
                self.ln2 = nn.LayerNorm()
                self.mlp1 = nn.Dense(4 * dim, activation="relu",
                                     flatten=False)
                self.mlp2 = nn.Dense(dim, flatten=False)

        def hybrid_forward(self, F, x):
            x = x + self.attn(self.ln1(x))
            return x + self.mlp2(self.mlp1(self.ln2(x)))

    class GPT(gluon.HybridBlock):
        def __init__(self, vocab, dim, num_heads, num_layers, seq_len, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.tok = nn.Embedding(vocab, dim)
                self.pos = self.params.get("pos_weight", shape=(seq_len, dim),
                                           init=mx.initializer.Normal(0.02))
                self.blocks = nn.HybridSequential()
                for _ in range(num_layers):
                    self.blocks.add(Block(dim, num_heads))
                self.ln_f = nn.LayerNorm()
                self.head = nn.Dense(vocab, flatten=False)

        def hybrid_forward(self, F, x, pos):
            h = self.tok(x) + F.expand_dims(pos, axis=0)
            h = self.blocks(h)
            return self.head(self.ln_f(h))

    return CausalSelfAttention, Block, GPT


def make_copy_batch(rng, batch, seq_len, vocab, lag):
    """The example's task: the target at position t is the input token at
    t - lag (0 before it), as f32 ids."""
    x = rng.randint(1, vocab, (batch, seq_len))
    y = np.zeros_like(x)
    y[:, lag:] = x[:, :-lag]
    return x.astype("f4"), y.astype("f4")
