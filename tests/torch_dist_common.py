"""The numpy laws of ``tests/dist_train_common.py`` (seeds 42 and 3) for
the port's multi-process workers: the same net, data and starting
weights, spelled over a package argument. numpy only; importing it
touches no device and no JAX."""
import numpy as np

PER_WORKER_BATCH = 16
N_SAMPLES_PER_WORKER = 32
EPOCHS = 2
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def make_net(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def full_data(nworker):
    rng = np.random.RandomState(42)
    n = N_SAMPLES_PER_WORKER * nworker
    X = rng.randn(n, 8).astype(np.float32)
    Y = rng.randint(0, 4, (n,)).astype(np.float32)
    return X, Y


def shard(X, Y, rank):
    """Rank ``rank``'s contiguous shard (the reference's SplitSampler)."""
    lo = rank * N_SAMPLES_PER_WORKER
    hi = (rank + 1) * N_SAMPLES_PER_WORKER
    return X[lo:hi], Y[lo:hi]


def fixed_params(sym_obj):
    """{name: numpy array}: seed 3, uniform(-0.1, 0.1), in the order of
    the net's arguments."""
    rng = np.random.RandomState(3)
    shapes, _, _ = sym_obj.infer_shape(data=(PER_WORKER_BATCH, 8))
    return {name: rng.uniform(-0.1, 0.1, shp).astype(np.float32)
            for name, shp in zip(sym_obj.list_arguments(), shapes)
            if name not in ("data", "softmax_label")}


def interleaved(X, nworker):
    """The order in which N workers' shards step together, as one
    process's full batch sees it."""
    return np.arange(len(X)).reshape(nworker, -1, PER_WORKER_BATCH) \
        .transpose(1, 0, 2).reshape(-1)
