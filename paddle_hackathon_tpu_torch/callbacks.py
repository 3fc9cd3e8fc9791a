"""paddle.callbacks (the JAX package's ``callbacks.py``; ref
``python/paddle/callbacks.py``): the hapi training callbacks."""

from .hapi.callbacks import (Callback, EarlyStopping,  # noqa: F401
                             LRScheduler, ModelCheckpoint, ProgBarLogger)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau"]


class VisualDL(Callback):
    """Scalar logger (ref callbacks VisualDL — visualdl isn't bundled, so
    scalars append to a jsonl the dashboard can tail)."""

    def __init__(self, log_dir):
        import os
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = None

    def on_train_begin(self, logs=None):
        import os
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def on_epoch_end(self, epoch, logs=None):
        import json
        if self._f and logs:
            rec = {"epoch": epoch}
            rec.update({k: float(v) for k, v in logs.items()
                        if isinstance(v, (int, float))})
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()


class ReduceLROnPlateau(Callback):
    """Reduce optimizer LR when a monitored metric stalls
    (ref callbacks ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0
        if mode == "auto":  # infer like the reference: acc/auc grow
            mode = ("max" if any(k in monitor for k in ("acc", "auc"))
                    else "min")
        self.mode = mode
        self._stepped_this_epoch = False

    def _better(self, cur, best):
        if self.mode == "max":
            return cur > best + self.min_delta
        return cur < best - self.min_delta

    def on_epoch_begin(self, epoch, logs=None):
        self._stepped_this_epoch = False

    def on_eval_end(self, logs=None):
        # eval metrics take priority over the train logs of the same epoch
        self._step(logs)
        self._stepped_this_epoch = True

    def on_epoch_end(self, epoch, logs=None):
        if not self._stepped_this_epoch:
            self._step(logs)

    def _step(self, logs):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
            return  # hold during cooldown
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(getattr(self, "model", None), "_optimizer", None)
            if opt is not None:
                lr = max(float(opt.get_lr()) * self.factor, self.min_lr)
                opt.set_lr(lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {lr}")
            self.wait = 0
            self.cooldown_counter = self.cooldown
