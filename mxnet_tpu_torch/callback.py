"""Training callbacks: ``do_checkpoint``, ``module_checkpoint``,
``log_train_metric``, ``Speedometer`` and ``ProgressBar``.

Counterpart of ``mxnet_tpu/callback.py``, for ``Module.fit``'s
``batch_end_callback`` and ``epoch_end_callback``. The log lines are the
JAX package's (and MXNet's), which log parsers read.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "log_train_metric",
           "module_checkpoint"]


def do_checkpoint(prefix, period=1):
    """Save the symbol and parameters every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()

    return _callback


class Speedometer:
    """Logs samples per second (and the metric) every ``frequent``
    batches, timed over that window."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_start = None  # perf-counter at last report/epoch

    def _emit(self, param, speed):
        metric = param.eval_metric
        count = param.nbatch
        if metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
            return
        pairs = metric.get_name_value()
        if self.auto_reset:
            metric.reset_local()
        fmt = ("Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec"
               + "\t%s=%f" * len(pairs))
        flat = [v for pair in pairs for v in pair]
        logging.info(fmt, param.epoch, count - self.frequent, count,
                     speed, *flat)

    def __call__(self, param):
        now = time.perf_counter()
        if param.nbatch == 0 or self._window_start is None:
            self._window_start = now  # epoch boundary / first batch
            return
        if param.nbatch % self.frequent:
            return
        elapsed = now - self._window_start
        speed = (self.frequent * self.batch_size / elapsed) if elapsed \
            else float("inf")
        self._emit(param, speed)
        self._window_start = now


class ProgressBar:
    """A text progress bar over ``total`` batches, logged."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
