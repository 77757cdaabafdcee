"""The examples of BASELINE configurations 1, 3 and 5 and the other
single-process examples, spelled over a package argument so that the
JAX package and the port build the same models from the same data.

* ``sr_net(gluon, upscale)``: ``examples/super_resolution.py``'s ESPCN
  ``SuperResolutionNet`` (64-64-32-r^2 filters at 5/3/3/3, then
  ``depth_to_space``); ``synthetic_pairs`` and ``psnr`` are the
  example's, numpy only.
* ``mlp_symbol(sym)`` and ``mnist_data()``: ``examples/train_mnist.py``'s
  MLP and its synthetic stand-in (2048 images of seed 0, the last 512
  held out).
* ``cifar_data()``: ``examples/train_cifar10.py``'s synthetic stand-in;
  its network is ``models.resnet_symbol(10, 20, (3, 28, 28))`` in
  either package.

* ``make_synthetic_libsvm`` and ``sparse_linear(pkg, path, ...)``:
  ``examples/sparse_linear_classification.py``'s data and its loop
  (``LibSVMIter`` CSR batches, ``sparse.dot`` both ways, the row_sparse
  gradient pushed to the kvstore's optimizer); ``check_improved`` is the
  examples' own check.
* ``nce_symbol``, ``nce_batches`` and ``nce_train``:
  ``examples/nce_word2vec.py``'s NCE head, its skip-gram batches with
  zipfian negatives and its ``simple_bind`` loop with its two checks.
  The port's executor holds torch tensors where the JAX package's holds
  NDArrays, so the loop sets the starting weight by
  ``copy_params_from`` and reads values through ``host``.
* ``cnn_net``, ``cnn_loader`` and ``cnn_train``: ``examples/gluon_cnn.py``.
* ``dcgan_nets``, ``dcgan_images`` and ``dcgan_train``:
  ``examples/train_dcgan.py``.
* ``vae_net``, ``vae_images`` and ``vae_train``: ``examples/train_vae.py``.

The Gluon networks build their layers inside a name scope, so no layer
takes a name from the package's global block counter; their structure
and parameter shapes are the examples'. The loops take ``steps`` to stop
early and ``on_step``/``on_epoch`` callbacks to record what a test or a
card run holds.

Pass ``mxnet_tpu_torch`` (as ``chip_smoke.py`` does) or ``mxnet_tpu``;
nothing here imports either. The tests hold these spellings to the
examples' own graphs (``tests/test_torch_port_super_resolution.py``)
and to each other (``tests/test_torch_port_examples_gluon.py``,
``tests/test_torch_port_sparse_linear.py``).
"""
import math

import numpy as np


def sr_net(gluon, upscale_factor=2, **kwargs):
    """An ESPCN ``SuperResolutionNet`` of ``gluon``'s package."""
    class SuperResolutionNet(gluon.HybridBlock):
        def __init__(self, upscale_factor, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.conv1 = gluon.nn.Conv2D(64, (5, 5), padding=(2, 2),
                                             activation="relu")
                self.conv2 = gluon.nn.Conv2D(64, (3, 3), padding=(1, 1),
                                             activation="relu")
                self.conv3 = gluon.nn.Conv2D(32, (3, 3), padding=(1, 1),
                                             activation="relu")
                self.conv4 = gluon.nn.Conv2D(upscale_factor ** 2, (3, 3),
                                             padding=(1, 1))
            self.upscale_factor = upscale_factor

        def hybrid_forward(self, F, x):
            x = self.conv4(self.conv3(self.conv2(self.conv1(x))))
            return F.depth_to_space(x, block_size=self.upscale_factor)

    return SuperResolutionNet(upscale_factor, **kwargs)


def synthetic_pairs(n=128, size=32, factor=2, seed=0):
    """Band-limited random images (low, high resolution), as the
    example makes them."""
    rng = np.random.RandomState(seed)
    hi = []
    for _ in range(n):
        freq = rng.randn(6, 6)
        img = np.zeros((size * factor, size * factor), np.float32)
        xs = np.linspace(0, 2 * np.pi, size * factor)
        for i in range(6):
            for j in range(6):
                img += freq[i, j] * np.outer(np.sin((i + 1) * xs / 2),
                                             np.cos((j + 1) * xs / 2))
        img = (img - img.min()) / (np.ptp(img) + 1e-6)
        hi.append(img.astype(np.float32))
    hi = np.stack(hi)[:, None]
    return hi[:, :, ::factor, ::factor], hi


def psnr(pred, target):
    mse = float(np.mean((pred - target) ** 2))
    return 10 * math.log10(1.0 / max(mse, 1e-10))


def mlp_symbol(sym):
    data = sym.Variable("data")
    net = sym.Flatten(data)
    net = sym.FullyConnected(net, num_hidden=128, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(net, name="softmax")


def mnist_data(n=2048):
    """(X_train, y_train, X_val, y_val): class-dependent blobs."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n).astype(np.float32)
    X = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.1
    for i in range(n):
        c = int(y[i])
        X[i, 0, 2 * c:2 * c + 6, 4:24] += 0.8
    cut = n - 512
    return X[:cut], y[:cut], X[cut:], y[cut:]


def cifar_data(n=2048):
    """(X_train, y_train, X_val, y_val): class-dependent colour patches."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n).astype(np.float32)
    X = rng.rand(n, 3, 28, 28).astype(np.float32) * 0.1
    for i in range(n):
        c = int(y[i])
        X[i, c % 3, 2 * (c // 3):2 * (c // 3) + 8, 6:22] += 0.9
    cut = n - 512
    return X[:cut], y[:cut], X[cut:], y[cut:]


def check_improved(metric_name, values, lower_is_better=True):
    """``examples/_common.py``'s check: exit when a multi-epoch run did
    not improve."""
    if len(values) < 2:
        return
    ok = values[-1] < values[0] if lower_is_better else \
        values[-1] > values[0]
    if not ok:
        raise SystemExit("%s did not improve: %s" % (metric_name, values))


# ------------------------------------- sparse_linear_classification.py
def make_synthetic_libsvm(path, n=2000, dim=1000, nnz=12, seed=0):
    """Linearly separable sparse data: y = sign(w_true . x)."""
    nnz = min(nnz, dim)
    rng = np.random.RandomState(seed)
    w_true = rng.randn(dim)
    with open(path, "w") as f:
        for _ in range(n):
            idx = rng.choice(dim, nnz, replace=False)
            val = rng.randn(nnz)
            y = 1 if np.dot(w_true[idx], val) > 0 else 0
            f.write("%d %s\n" % (y, " ".join(
                "%d:%.4f" % (i, v) for i, v in sorted(zip(idx, val)))))
    return path


def sparse_linear(pkg, data_path, num_features=1000, batch_size=64,
                  epochs=6, lr=0.5, kv_store="local", optimizer="adagrad",
                  on_epoch=None, it=None):
    """The example's loop -> the accuracy of each epoch. ``on_epoch(epoch,
    weight, bias)`` runs after each epoch; ``it`` is a ``LibSVMIter``
    already made over ``data_path`` (the loop makes its own without)."""
    mx = pkg
    sp = pkg.nd.sparse
    kv = mx.kv.create(kv_store)
    if it is None:
        it = mx.io.LibSVMIter(data_libsvm=data_path,
                              data_shape=(num_features,),
                              batch_size=batch_size,
                              num_parts=kv.num_workers, part_index=kv.rank)
    weight = mx.nd.zeros((num_features, 1))
    bias = mx.nd.zeros((1,))
    kv.set_optimizer(mx.optimizer.create(optimizer, learning_rate=lr))
    kv.init(0, weight)
    kv.init(1, bias)
    accs = []
    for epoch in range(epochs):
        it.reset()
        correct = total = 0
        for batch in it:
            x = batch.data[0]
            y, logits_h, bias_h = mx.nd.asnumpy_all(
                batch.label[0], sp.dot(x, weight), bias)
            logits = logits_h.ravel() + float(bias_h.ravel()[0])
            prob = 1.0 / (1.0 + np.exp(-logits))
            g = (prob - y)[:, None].astype("f4") / len(y)
            gw_dense = sp.dot(x, mx.nd.array(g), transpose_a=True)
            gw = sp.cast_storage(gw_dense, "row_sparse")
            kv.push(0, gw)
            kv.push(1, mx.nd.array([float(g.sum())]))
            kv.pull(0, out=weight, ignore_sparse=False)
            kv.pull(1, out=bias)
            correct += int(((prob > 0.5) == (y > 0.5)).sum())
            total += len(y)
        accs.append(correct / total)
        if on_epoch is not None:
            on_epoch(epoch, weight, bias)
    return accs


# ------------------------------------------------------- nce_word2vec.py
def nce_symbol(sym, vocab_size, dim, num_neg):
    """Context word -> dot with [pos | negs] embeddings -> logistic."""
    center = sym.Variable("data")
    cands = sym.Variable("cands")
    targets = sym.Variable("softmax_label")
    embed_w = sym.Variable("embed_weight")
    ctx_vec = sym.Embedding(center, weight=embed_w, input_dim=vocab_size,
                            output_dim=dim, name="ctx_embed")
    cand_vec = sym.Embedding(cands, weight=embed_w, input_dim=vocab_size,
                             output_dim=dim, name="cand_embed")
    ctx3 = sym.Reshape(ctx_vec, shape=(-1, 1, dim))
    logits = sym.sum(sym.broadcast_mul(ctx3, cand_vec), axis=2)
    return sym.LogisticRegressionOutput(logits, targets, name="nce")


def nce_batches(pkg, vocab, batch, num_neg, steps, seed=0):
    """Skip-gram pairs (w, w^1) with zipfian negatives drawn by the op on
    the current context."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        center = np.minimum(
            np.exp(rng.uniform(0, np.log(vocab), batch)).astype("i8") - 1,
            vocab - 1)
        pos = center ^ 1
        negs, _ = pkg.nd.invoke("_sample_unique_zipfian", [],
                                {"range_max": vocab,
                                 "shape": (batch, num_neg)})
        negs = negs.asnumpy().astype("i8")
        hit = negs == pos[:, None]
        negs[hit] = (negs[hit] + vocab // 2) % vocab
        cands = np.concatenate([pos[:, None], negs], axis=1)
        targets = np.zeros((batch, 1 + num_neg), "f4")
        targets[:, 0] = 1.0
        yield center.astype("f4"), cands.astype("f4"), targets


def host(x):
    """An executor's value as numpy: the JAX package's executor holds
    NDArrays, the port's torch tensors."""
    return x.asnumpy() if hasattr(x, "asnumpy") else \
        x.detach().cpu().numpy()


def nce_train(pkg, dev, vocab=512, dim=32, num_neg=15, batch_size=256,
              steps=300, lr=0.2, on_step=None, check=True):
    """The example's loop on ``dev`` -> (NLL of each step, the trained
    embedding, the partner-nearest-neighbour rate). ``on_step(i, ex)``
    runs after each step's backward, before the update."""
    mx = pkg
    sym = nce_symbol(mx.sym, vocab, dim, num_neg)
    ex = sym.simple_bind(dev, data=(batch_size,),
                         cands=(batch_size, 1 + num_neg),
                         softmax_label=(batch_size, 1 + num_neg),
                         grad_req={"embed_weight": "write", "data": "null",
                                   "cands": "null", "softmax_label": "null"})
    rng = np.random.RandomState(1)
    ex.copy_params_from({"embed_weight": mx.nd.array(
        rng.uniform(-0.3, 0.3, (vocab, dim)).astype("f4"), ctx=dev)})
    losses = []
    for i, (center, cands, targets) in enumerate(
            nce_batches(pkg, vocab, batch_size, num_neg, steps)):
        ex.forward(is_train=True, data=mx.nd.array(center, ctx=dev),
                   cands=mx.nd.array(cands, ctx=dev),
                   softmax_label=mx.nd.array(targets, ctx=dev))
        pn = host(ex.outputs[0])
        eps = 1e-7
        losses.append(-np.mean(targets * np.log(pn + eps)
                               + (1 - targets) * np.log(1 - pn + eps)))
        ex.backward()
        if on_step is not None:
            on_step(i, ex)
        g = ex.grad_dict["embed_weight"]
        ex.arg_dict["embed_weight"] -= lr * g
    W = host(ex.arg_dict["embed_weight"])
    Wn = W / (np.linalg.norm(W, axis=1, keepdims=True) + 1e-8)
    sims = Wn @ Wn.T
    np.fill_diagonal(sims, -np.inf)
    hits = float(np.mean(sims.argmax(axis=1) == (np.arange(vocab) ^ 1)))
    if check:
        assert losses[-1] < losses[0] * 0.95, "NCE training did not improve"
        assert hits > 0.2, "embeddings did not capture co-occurrence"
    return losses, W, hits


# ---------------------------------------------------------- gluon_cnn.py
def cnn_net(gluon, prefix="cnn_"):
    net = gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gluon.nn.Conv2D(16, kernel_size=3, padding=1,
                                activation="relu"),
                gluon.nn.MaxPool2D(2),
                gluon.nn.Conv2D(32, kernel_size=3, padding=1,
                                activation="relu"),
                gluon.nn.GlobalAvgPool2D(),
                gluon.nn.Flatten(),
                gluon.nn.Dense(10))
    return net


def cnn_data(n=1024):
    """Class-dependent mean intensity (GAP-friendly) -> (X, y)."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n)
    X = rng.rand(n, 1, 16, 16).astype(np.float32) * 0.1
    for i in range(n):
        X[i] += (int(y[i]) + 1) * 0.25
    return X, y.astype(np.float32)


def cnn_train(pkg, net, X, y, batch_size=32, epochs=3, steps=None,
              on_step=None):
    """The example's loop over a shuffled ``DataLoader`` -> [(mean loss,
    accuracy)] an epoch. ``on_step(i, loss, out)`` runs after each
    step."""
    gluon, autograd = pkg.gluon, pkg.autograd
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, y),
                                   batch_size=batch_size, shuffle=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    hist, i = [], 0
    for _ in range(epochs):
        total = correct = 0
        cum_loss = 0.0
        for data, label in loader:
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(batch_size)
            loss_h, out_h, label_h = pkg.nd.asnumpy_all(loss, out, label)
            if on_step is not None:
                on_step(i, loss_h, out_h)
            cum_loss += float(loss_h.sum())
            correct += int((out_h.argmax(1) == label_h).sum())
            total += len(label)
            i += 1
            if steps is not None and i >= steps:
                return hist
        hist.append((cum_loss / total, correct / total))
    return hist


# ---------------------------------------------------------- train_dcgan.py
def dcgan_nets(gluon, ngf=32, ndf=32, nc=1, leak=0.2):
    """(generator z (N, nz, 1, 1) -> (N, nc, 32, 32), discriminator
    image -> logit (N, 1))."""
    gen = gluon.nn.HybridSequential(prefix="gen_")
    with gen.name_scope():
        gen.add(gluon.nn.Conv2DTranspose(ngf * 4, 4, strides=1, padding=0,
                                         use_bias=False))
        gen.add(gluon.nn.BatchNorm(), gluon.nn.Activation("relu"))
        gen.add(gluon.nn.Conv2DTranspose(ngf * 2, 4, strides=2, padding=1,
                                         use_bias=False))
        gen.add(gluon.nn.BatchNorm(), gluon.nn.Activation("relu"))
        gen.add(gluon.nn.Conv2DTranspose(ngf, 4, strides=2, padding=1,
                                         use_bias=False))
        gen.add(gluon.nn.BatchNorm(), gluon.nn.Activation("relu"))
        gen.add(gluon.nn.Conv2DTranspose(nc, 4, strides=2, padding=1,
                                         use_bias=False))
        gen.add(gluon.nn.Activation("tanh"))
    disc = gluon.nn.HybridSequential(prefix="disc_")
    with disc.name_scope():
        disc.add(gluon.nn.Conv2D(ndf, 4, strides=2, padding=1,
                                 use_bias=False))
        disc.add(gluon.nn.LeakyReLU(leak))
        disc.add(gluon.nn.Conv2D(ndf * 2, 4, strides=2, padding=1,
                                 use_bias=False))
        disc.add(gluon.nn.BatchNorm(), gluon.nn.LeakyReLU(leak))
        disc.add(gluon.nn.Conv2D(ndf * 4, 4, strides=2, padding=1,
                                 use_bias=False))
        disc.add(gluon.nn.BatchNorm(), gluon.nn.LeakyReLU(leak))
        disc.add(gluon.nn.Conv2D(1, 4, strides=1, padding=0,
                                 use_bias=False))
        disc.add(gluon.nn.Flatten())
    return gen, disc


def dcgan_images(n, rng):
    """Smooth blob images in [-1, 1]."""
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    imgs = np.empty((n, 1, 32, 32), np.float32)
    for i in range(n):
        cx, cy = rng.rand(2) * 0.6 + 0.2
        r = rng.rand() * 0.15 + 0.1
        img = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r)))
        imgs[i, 0] = img * 2.0 - 1.0
    return imgs


def dcgan_train(pkg, ctx, gen, disc, rng, real_images, batch_size=32,
                epochs=3, nz=64, lr=2e-4, steps=None, on_step=None):
    """The example's adversarial loop (one discriminator update, two
    generator updates a batch; noise from ``rng``) -> (d_loss, g_loss,
    fool rate) an epoch, and the example's collapse check on the last
    epoch when it ran whole. ``on_step(i, d_loss, g_loss)`` runs after
    each batch."""
    mx, gluon, autograd = pkg, pkg.gluon, pkg.autograd
    it = mx.io.NDArrayIter(real_images, batch_size=batch_size, shuffle=True)
    loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    g_tr = gluon.Trainer(gen.collect_params(), "adam",
                         {"learning_rate": lr, "beta1": 0.5})
    d_tr = gluon.Trainer(disc.collect_params(), "adam",
                         {"learning_rate": lr * 0.5, "beta1": 0.5})
    ones = mx.nd.ones((batch_size,), ctx=ctx)
    zeros = mx.nd.zeros((batch_size,), ctx=ctx)
    hist, i = [], 0
    for _ in range(epochs):
        it.reset()
        d_losses, g_losses, fooled = [], [], []
        for batch in it:
            real = batch.data[0].as_in_context(ctx)
            z = mx.nd.array(rng.randn(batch_size, nz, 1, 1)
                            .astype(np.float32), ctx=ctx)
            with autograd.record():
                out_real = disc(real).reshape((-1,))
                fake = gen(z)
                out_fake = disc(fake.detach()).reshape((-1,))
                d_loss = loss_fn(out_real, ones) + loss_fn(out_fake, zeros)
            d_loss.backward()
            d_tr.step(batch_size)
            for _ in range(2):
                with autograd.record():
                    out = disc(gen(z)).reshape((-1,))
                    g_loss = loss_fn(out, ones)
                g_loss.backward()
                g_tr.step(batch_size)
            d_h, g_h, f_h = mx.nd.asnumpy_all(
                d_loss.mean(), g_loss.mean(), (out.sigmoid() > 0.5).mean())
            d_losses.append(float(d_h))
            g_losses.append(float(g_h))
            fooled.append(float(f_h))
            if on_step is not None:
                on_step(i, float(d_h), float(g_h))
            i += 1
            if steps is not None and i >= steps:
                return hist
        hist.append((float(np.mean(d_losses)), float(np.mean(g_losses)),
                     float(np.mean(fooled))))
    d_final = hist[-1][0]
    if not np.isfinite(d_final) or d_final < 0.05:
        raise SystemExit("adversarial game collapsed: d_loss %.4f"
                         % d_final)
    return hist


# ------------------------------------------------------------ train_vae.py
def vae_net(gluon, n_hidden=128, n_latent=8, n_out=256, prefix="vae_"):
    """The example's ``VAE``: dense encoder to (mu, logvar), z = mu + eps
    * exp(logvar / 2) with eps drawn inside the call, dense decoder;
    returns (reconstruction, KL)."""
    class VAE(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.n_latent = n_latent
            with self.name_scope():
                self.enc = gluon.nn.HybridSequential()
                self.enc.add(gluon.nn.Dense(n_hidden, activation="relu"))
                self.enc.add(gluon.nn.Dense(n_latent * 2))
                self.dec = gluon.nn.HybridSequential()
                self.dec.add(gluon.nn.Dense(n_hidden, activation="relu"))
                self.dec.add(gluon.nn.Dense(n_out, activation="sigmoid"))

        def hybrid_forward(self, F, x):
            h = self.enc(x)
            mu = F.slice_axis(h, axis=1, begin=0, end=self.n_latent)
            logvar = F.slice_axis(h, axis=1, begin=self.n_latent, end=None)
            eps = F._random_normal_like(mu)
            z = mu + F.exp(0.5 * logvar) * eps
            y = self.dec(z)
            kl = -0.5 * F.sum(1 + logvar - mu * mu - F.exp(logvar), axis=1)
            return y, kl

    return VAE(prefix=prefix)


def vae_images(n, rng, side=16):
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / (side - 1)
    out = np.empty((n, side * side), np.float32)
    for i in range(n):
        cx, cy = rng.rand(2) * 0.6 + 0.2
        r = rng.rand() * 0.1 + 0.08
        img = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r)))
        out[i] = img.ravel()
    return out


def vae_train(pkg, ctx, net, X, batch_size=64, epochs=5, lr=1e-3,
              steps=None, on_step=None):
    """The example's loop -> the -ELBO of each epoch, checked to fall
    when it ran whole. ``on_step(i, loss)`` runs after each step."""
    gluon, autograd = pkg.gluon, pkg.autograd
    it = pkg.io.NDArrayIter(X, batch_size=batch_size, shuffle=True)
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})
    elbos, i = [], 0
    for _ in range(epochs):
        it.reset()
        losses = []
        for batch in it:
            x = batch.data[0].as_in_context(ctx)
            with autograd.record():
                y, kl = net(x)
                loss = (bce(y, x) * X.shape[1]) + kl
            loss.backward()
            trainer.step(batch_size)
            losses.append(float(loss.mean().asnumpy()))
            if on_step is not None:
                on_step(i, losses[-1])
            i += 1
            if steps is not None and i >= steps:
                return elbos
        elbos.append(float(np.mean(losses)))
    # decode fresh prior samples: the generative direction works
    z = pkg.nd.random.normal(shape=(4, net.n_latent), ctx=ctx)
    assert net.dec(z).shape == (4, X.shape[1])
    check_improved("-ELBO", elbos)
    return elbos
