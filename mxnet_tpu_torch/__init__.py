"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The port serves ResNet predict artifacts (the op registry, Symbol and
its JSON, the graph evaluator, the micro-batching server) and GPT
generate artifacts (the decoder programs, continuous batching over a
paged KV cache), through the kernel tier with hand-written CUDA kernels:
``bn_act``, ``take_rows``, ``flash_attn`` and ``flash_attn_paged``.

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
from . import kernels  # noqa: F401
from . import serving  # noqa: F401
from . import serve  # noqa: F401
