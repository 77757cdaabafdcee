"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The port serves ResNet predict artifacts (the op registry, Symbol and
its JSON, the graph evaluator, the micro-batching server), their int8
post-training quantization beside the f32 model (``quant``), and GPT
generate artifacts (the decoder programs, continuous batching over a
paged KV cache, speculative decoding with an int8 draft) and recommend
artifacts (two-tower tables streamed through a hot-row cache on the
card, ``embed``), and trains symbolic models through ``Module.fit`` (the
executor's forward and backward, the fused train step with bf16
compute over f32 master weights, SGD with ``multi_precision`` and Adam,
learning-rate schedules, ``BucketingModule`` over the symbolic ``rnn``
cells), and trains eagerly through the NDArray,
``autograd`` and Gluon (``Block``, ``HybridBlock``, ``nn`` with the
convolution layers, ``rnn``, ``loss``, ``Trainer``, ``data``,
``model_zoo``)
layers, with the JAX package's random key chain (``random``), its
``.params`` files, row-sparse gradients (``nd.sparse``) and the
optimizers' lazy row updates. Its data pipeline reads RecordIO files
(``recordio``, ``io.ImageRecordIter``, the streaming tier ``data``):
JPEG records decoded by nvJPEG and augmented on the card, and staged K
steps ahead of ``Module.fit``. Training keeps the JAX package's loop
surface in one process: the key-value store (``kv``), atomic
checkpoints and resume (``checkpoint``, ``model.save_checkpoint``),
callbacks (``callback``), ``monitor`` and ``model.FeedForward``.
Object detection trains through the same ``Module.fit``: the box, ROI
and SSD ops, ``Proposal``, user Python operators (``operator``, the
``Custom`` op, run on the host mid-step) and ``image`` (the augmenters,
``ImageIter`` and ``ImageDetIter``).
Its kernel tier runs hand-written CUDA kernels: ``bn_act``,
``take_rows``, ``flash_attn``, ``flash_attn_paged``, ``scale_bias_act``,
the legacy flash forward ``flash_fwd``, the int8 epilogue
``int8_dequant`` and the image record augment ``image_aug``.

Importing does no device work and builds nothing. Entry points run on
``cuda:0`` unless the caller asks for the CPU (``device="cpu"`` or
``mxnet_tpu_torch.cpu()``); without a card they raise. The package
imports neither ``jax`` nor ``mxnet_tpu``.
"""
from . import config  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import Context, cpu, current_context, gpu  # noqa: F401
from . import ops  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import models  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import optimizer  # noqa: F401
from . import recordio  # noqa: F401
from . import io  # noqa: F401
from . import data  # noqa: F401
from . import metric  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import rnn  # noqa: F401
from . import parallel  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import checkpoint  # noqa: F401
from . import callback  # noqa: F401
from . import model  # noqa: F401
from . import monitor  # noqa: F401
from . import kernels  # noqa: F401
from . import serving  # noqa: F401
from . import embed  # noqa: F401
from . import profiler  # noqa: F401
from . import serve  # noqa: F401
from . import quant  # noqa: F401
from . import random  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import autograd  # noqa: F401
from . import gluon  # noqa: F401
from . import name  # noqa: F401
from . import operator  # noqa: F401
from . import image  # noqa: F401
