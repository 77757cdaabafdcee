"""Data parallelism across processes and sequence-parallel attention
helpers: the process group on ``torch.distributed`` (``dist``), the
bucketed gradient all-reduce (``ddp``), heartbeats (``fault``), fault
injection (``faultinject``), parameter layouts for resharded checkpoints
(``layout``), the ``dist_async`` server (``async_server``), and the
single-device :func:`~.ring_attention.blockwise_attention`."""
from . import dist  # noqa: F401
from . import ddp  # noqa: F401
from . import fault  # noqa: F401
from . import faultinject  # noqa: F401
from . import layout  # noqa: F401
from . import async_server  # noqa: F401
from .ring_attention import blockwise_attention  # noqa: F401
