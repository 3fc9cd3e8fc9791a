"""Training callbacks (the JAX package's ``hapi/callbacks.py``; ref
``python/paddle/hapi/callbacks.py``)."""

from __future__ import annotations

import numbers
import os
import time


def _scalar(v):
    """Printable float for a log value, or None to skip it.  Loss values
    from the compiled fit path arrive as 0-d device tensors (the host sync
    is deferred to print time, ``hapi/compiled.py``'s async-loss
    contract); 0-d tensors fetch here, non-scalars are skipped."""
    if isinstance(v, numbers.Number):
        return float(v)
    if getattr(v, "ndim", None) == 0 or getattr(v, "shape", None) == []:
        try:
            return float(v)
        except TypeError:
            return None
    return None


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    """Per-epoch progress printout (ref callbacks.py ProgBarLogger)."""

    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            msgs = [f"step {step}/{self.steps or '?'}"]
            for k, v in (logs or {}).items():
                s = _scalar(v)
                if s is not None:
                    msgs.append(f"{k}: {s:.4f}")
            print(f"Epoch {self.epoch + 1}/{self.epochs} - " + " - ".join(msgs))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            msgs = [f"{k}: {s:.4f}" for k, v in (logs or {}).items()
                    if (s := _scalar(v)) is not None]
            print(f"Epoch {epoch + 1}/{self.epochs} done ({dur:.1f}s) - "
                  + " - ".join(msgs))


class ModelCheckpoint(Callback):
    """Periodic save (ref callbacks.py ModelCheckpoint)."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class MetricsCallback(Callback):
    """Log/telemetry bridge for the metrics registry
    (``observability.MetricRegistry``) inside ``Model.fit``.

    Every ``log_freq`` train steps it samples the guarded device-health
    gauges and prints a compact line of the registry's key training
    series (step time p50, tokens/sec, compile events, input wait);
    ``on_train_end`` optionally writes the full ``registry.snapshot()``
    JSON to ``snapshot_path`` — the file ``tools/metrics_dump.py``
    pretty-prints and diffs."""

    def __init__(self, log_freq=100, snapshot_path=None, registry=None,
                 verbose=1):
        from ..observability import metrics as _obs
        self.registry = registry or _obs.get_registry()
        self.log_freq = max(int(log_freq), 1)
        self.snapshot_path = snapshot_path
        self.verbose = verbose
        self._begin = None

    def on_train_begin(self, logs=None):
        self._begin = self.registry.snapshot()

    def _line(self):
        reg = self.registry
        parts = []
        fam = reg.get("train_step_seconds")
        if fam is not None:
            for c in fam.children():
                if c.count:
                    parts.append(f"step_p50 {c.quantile(0.5) * 1e3:.1f}ms")
                    break
        tps = reg.total("train_tokens_per_sec")
        if tps:
            parts.append(f"tokens/s {tps:,.0f}")
        builds = reg.total("jit_builds_total")
        if builds:
            parts.append(f"jit_builds {builds:.0f}")
        fam = reg.get("input_wait_seconds")
        if fam is not None:
            for c in fam.children():
                if c.count:
                    parts.append(
                        f"input_wait_p90 {c.quantile(0.9) * 1e3:.1f}ms")
                    break
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if step % self.log_freq:
            return
        from ..observability import metrics as _obs
        _obs.record_device_memory(self.registry)
        if self.verbose:
            line = self._line()
            if line:
                print(f"[metrics] step {step} - {line}")

    def on_train_end(self, logs=None):
        from ..observability import metrics as _obs
        _obs.record_device_memory(self.registry)
        if self.snapshot_path:
            import json
            snap = self.registry.snapshot()
            if self._begin is not None:
                from ..observability.metrics import snapshot_delta
                snap["delta_from_train_begin"] = snapshot_delta(
                    self._begin, snap)["metrics"]
            with open(self.snapshot_path, "w") as f:
                json.dump(snap, f, indent=1)


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (ref EarlyStopping)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0

    def _better(self, cur, ref):
        if self.mode == "min":
            return cur < ref - self.min_delta
        return cur > ref + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"early stopping: no {self.monitor} improvement "
                          f"for {self.patience} evals")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler each epoch/step (ref LRScheduler
    callback)."""

    def __init__(self, by_step=False, by_epoch=True):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()
