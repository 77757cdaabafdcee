"""The word language model of ``examples/word_language_model.py``
(``:32-61`` and its training loop ``:125-146``), for any package with
the Gluon surface.

``rnn_model_class(gluon)`` returns the example's ``RNNModel`` built on
that package's ``gluon.Block``, ``nn`` layers and ``rnn.LSTM``, its
``forward`` unchanged, so the JAX package and the PyTorch port run the
same model by the same names. ``lm_step`` is one iteration of the
example's loop: the hidden state detached (truncated BPTT), the forward
and the loss under ``autograd.record()``, the backward, the gradients
clipped by their global norm, and the Trainer's step. No package is
imported here: tests and ``chip_smoke.py`` pass theirs.
"""


def rnn_model_class(gluon):
    class RNNModel(gluon.Block):
        def __init__(self, vocab_size, embed, hidden, layers, dropout=0.2,
                     tie_weights=False, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(vocab_size, embed)
                self.rnn = gluon.rnn.LSTM(hidden, num_layers=layers,
                                          dropout=dropout, layout="NTC")
                if tie_weights:
                    if embed != hidden:
                        raise ValueError("tied weights need embed == hidden")
                    self.decoder = gluon.nn.Dense(
                        vocab_size, flatten=False,
                        params=self.encoder.params)
                else:
                    self.decoder = gluon.nn.Dense(vocab_size, flatten=False)
            self.hidden = hidden
            self.layers = layers

        def begin_state(self, batch, ctx):
            return self.rnn.begin_state(batch_size=batch, ctx=ctx)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            out, hidden = self.rnn(emb, hidden)
            out = self.drop(out)
            return self.decoder(out), hidden

    return RNNModel


def lm_step(gluon, autograd, model, trainer, loss_fn, X, Y, hidden, clip,
            batch_size, ctx=None, before_clip=None):
    """One step of the example's loop -> (loss NDArray, new hidden).
    ``before_clip(out, params)``, when given, sees the logits and the
    parameters (their gradients unclipped) after the backward."""
    hidden = [h.detach() for h in hidden]
    with autograd.record():
        out, hidden = model(X, hidden)
        loss = loss_fn(out, Y)
    loss.backward()
    params = model.collect_params()
    if before_clip is not None:
        before_clip(out, params)
    grads = [p.grad(ctx) for p in params.values() if p.grad_req != "null"]
    gluon.utils.clip_global_norm(grads, clip * batch_size)
    trainer.step(batch_size)
    return loss, hidden
