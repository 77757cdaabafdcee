"""Command-line tools of the port: ``python -m mxnet_tpu_torch.tools.launch``
(the multi-process launcher) and ``python -m mxnet_tpu_torch.tools.reshard``
(a checkpoint resharded to another world size)."""
