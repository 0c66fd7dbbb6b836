"""The Estimator's event handlers: the ``TrainBegin`` ... ``BatchEnd``
mixins and the stock handlers (``StoppingHandler``, ``MetricHandler``,
``ValidationHandler``, ``LoggingHandler``, ``CheckpointHandler``,
``EarlyStoppingHandler``).

Counterpart of ``mxnet_tpu/gluon/contrib/estimator/event_handler.py``,
the same code: it computes nothing on a device.
"""
import logging
import os
import time

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        """Return False to stop training."""
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        """Return False to stop training."""
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch/max_batch (ref: event_handler.py
    StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True
        return not self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True
        return not self.stop_training


class MetricHandler(EpochBegin, BatchEnd):
    """Reset metrics per epoch, update per batch (ref: event_handler.py
    MetricHandler)."""

    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.train_metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        from .... import metric as metric_mod
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for metric in self.train_metrics:
            if isinstance(metric, metric_mod.Loss):
                # the running-loss display metric consumes the loss
                # value; name-matching would misroute real metrics whose
                # names merely contain 'loss' (e.g. nll-loss)
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation on an interval (ref: event_handler.py
    ValidationHandler)."""

    def __init__(self, val_data, eval_fn, epoch_period=1,
                 batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                     BatchBegin, BatchEnd):
    """Periodic progress logging (ref: event_handler.py
    LoggingHandler)."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.time() - self.train_start
        self.logger.info("Train finished using %.3fs", t)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0
        self.processed_samples = 0

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.time() - self.epoch_start
        msg = f"[Epoch {self.current_epoch}] finished in {t:.3f}s: "
        for metric in self.metrics:
            name, value = metric.get()
            msg += f"{name}: {value:.4f} "
        self.logger.info(msg)
        self.current_epoch += 1

    def batch_end(self, estimator, *args, **kwargs):
        if isinstance(self.log_interval, int):
            batch = kwargs.get("batch")
            if batch is not None and hasattr(batch, "data"):
                self.processed_samples += batch.data[0].shape[0]
            self.batch_index += 1
            if self.batch_index % self.log_interval == 0:
                msg = (f"[Epoch {self.current_epoch}] "
                       f"batch {self.batch_index}: ")
                for metric in self.metrics:
                    name, value = metric.get()
                    msg += f"{name}: {value:.4f} "
                self.logger.info(msg)


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save params (+trainer states) periodically and track the best
    model by a monitored metric (ref: event_handler.py
    CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", epoch_period=1, max_checkpoints=5):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.mode = mode
        self.epoch_period = epoch_period
        self.max_checkpoints = max_checkpoints
        self.current_epoch = 0
        self.best = float("inf") if mode == "min" else -float("inf")
        self.saved = []

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.current_epoch % self.epoch_period:
            return
        path = os.path.join(
            self.model_dir,
            f"{self.model_prefix}-epoch{self.current_epoch}.params")
        estimator.net.save_parameters(path)
        self.saved.append(path)
        while len(self.saved) > self.max_checkpoints:
            old = self.saved.pop(0)
            try:
                os.unlink(old)
            except OSError:
                pass
        if self.monitor is not None:
            name, value = self.monitor.get()
            better = value < self.best if self.mode == "min" \
                else value > self.best
            if better:
                self.best = value
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stop when the monitored metric stops improving
    (ref: event_handler.py EarlyStoppingHandler)."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.wait = 0
        self.best = float("inf") if mode == "min" else -float("inf")
        self.stopped_epoch = None
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.current_epoch = 0
        self.best = float("inf") if self.mode == "min" else -float("inf")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        name, value = self.monitor.get()
        improved = (value < self.best - self.min_delta
                    if self.mode == "min"
                    else value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.wait = 0
            return True
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = self.current_epoch
            logging.getLogger("mxnet_tpu_torch.estimator").info(
                "Early stopping at epoch %d: %s did not improve for %d "
                "epochs", self.current_epoch, name, self.patience)
            return False
        return True
