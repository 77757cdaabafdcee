"""Monitor: statistics of outputs and parameters (counterpart of
``mxnet_tpu/monitor.py``).

``install(exe)`` attaches to a symbolic Executor (its outputs and
arguments are read at ``toc``), ``install_block`` to a Gluon Block (a
forward hook on its outputs, its parameters at ``toc``); ``tic``/``toc``
bracket one iteration, active every ``interval`` iterations. Each
statistic is ``stat_func`` of a host numpy copy (default: the mean
absolute value).
"""
from __future__ import annotations

import re

import numpy as _np

from .ndarray.ndarray import asnumpy_all

__all__ = ["Monitor"]


def _host(v):
    return asnumpy_all(v)[0]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return _np.abs(x).mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.blocks = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe):
        """Attach to a symbolic Executor: its outputs and arguments are
        read at each active ``toc``."""
        self.exes.append(exe)

    def install_block(self, block):
        """Gluon: statistics of a Block's outputs (a forward hook) and
        parameters."""
        from .ndarray.ndarray import NDArray
        self.blocks.append(block)

        def hook(blk, inputs, outputs):
            if not self.activated:
                return
            outs = outputs if isinstance(outputs, (list, tuple)) \
                else [outputs]
            for i, o in enumerate(outs):
                if isinstance(o, NDArray):
                    name = "%s_output%d" % (blk.name, i)
                    if self.re_prog.match(name):
                        self.queue.append((self.step, name,
                                           self.stat_func(o.asnumpy())))
        block.register_forward_hook(hook)

    def tic(self):
        """Start collecting for this iteration."""
        if self.step % self.interval == 0:
            self.activated = True
        self.queue = []

    def toc(self):
        """End the iteration -> [(step, name, stat), ...]."""
        if not self.activated:
            self.step += 1
            return []
        for exe in self.exes:
            for name, arr in zip(exe._symbol.list_outputs(), exe.outputs):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(_host(arr))))
            for name, arr in zip(exe._symbol.list_arguments(),
                                 exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(_host(arr))))
        for block in self.blocks:
            for name, p in block.collect_params().items():
                if p._data is not None and self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(p.data().asnumpy())))
        self.activated = False
        self.step += 1
        res = self.queue
        if self.sort:
            res = sorted(res, key=lambda x: x[1])
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for step, name, stat in res:
            print("Batch: %7d %30s %s" % (step, name, str(stat)))
        return res
