"""Keras-like high-level Model API (the JAX package's ``hapi/model.py``).

Ref ``python/paddle/hapi/model.py``: ``Model`` (:915), ``fit`` (:1574),
``train_batch`` (:1055), evaluate/predict, save/load.  ``fit`` runs the
eager tape (``train_batch``: forward, ``backward``, ``optimizer.step``)
or the K-step functional trainer of ``hapi/compiled.py``
(``jit_compile``), with the JAX package's choice between them.

Not ported: crash-safe fit checkpoints (``checkpoint=``) and the ZeRO
options (``zero_stage``, ``zero_offload``, ``grad_overlap``), ROADMAP
Queue 1 item 12, raise ``NotImplementedError``; the MoE aux loss needs
MoE layers, item 11 (the port's GPT raises for ``moe_num_experts > 0``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.autograd import no_grad
from ..core.tensor import Tensor, to_tensor
from ..metric import Metric
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_tensor(x):
    """A ``Tensor`` on the current place (a torch tensor is wrapped as it
    is)."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    return to_tensor(np.asarray(x))


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    # -- configuration ----------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        metrics = _to_list(metrics)
        for m in metrics:
            assert isinstance(m, Metric), (
                f"metrics must be paddle.metric.Metric instances, got {m}")
        self._metrics = metrics

    # -- single-batch ops (ref train_batch:1055) --------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = [_as_tensor(x) for x in _to_list(inputs)]
        labels = [_as_tensor(x) for x in _to_list(labels)]
        outputs = self.network(*inputs)
        outs = _to_list(outputs)
        losses = _to_list(self._loss(*(outs + labels)))
        total = losses[0]
        for l in losses[1:]:
            total = total + l
        self._moe_aux_tensor()
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        out_loss = [l.item() for l in losses]
        return (out_loss, metrics) if metrics else out_loss

    def _moe_aux_tensor(self):
        """The MoE load-balance aux the JAX package adds to the eager loss.
        The port has no MoE layer (ROADMAP Queue 1 item 11; its GPT raises
        for ``moe_num_experts > 0``): None, and a network carrying the aux
        side channel raises."""
        from .compiled import has_moe_layers
        if has_moe_layers(self.network):
            raise NotImplementedError(
                "Model.fit with MoE layers (the load-balance aux loss) is "
                "not ported yet: ROADMAP Queue 1 item 11")
        return None

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = [_as_tensor(x) for x in _to_list(inputs)]
        labels = [_as_tensor(x) for x in _to_list(labels)]
        with no_grad():
            outputs = self.network(*inputs)
            outs = _to_list(outputs)
            losses = _to_list(self._loss(*(outs + labels))) if self._loss else []
        metrics = self._update_metrics(outs, labels)
        out_loss = [l.item() for l in losses]
        return (out_loss, metrics) if metrics else out_loss

    def _update_metrics(self, outs, labels):
        metrics = []
        for m in self._metrics:
            # Metric protocol (ref hapi/model.py _update_metrics): compute()
            # turns (preds, labels) into the per-batch statistic update()
            # consumes; metrics without compute take raw outputs.
            if hasattr(m, "compute"):
                stat = m.compute(*(outs + labels))
                m.update(*[s_.numpy() if isinstance(s_, Tensor)
                           else np.asarray(s_) for s_ in _to_list(stat)])
            else:
                m.update(*[t.numpy() for t in outs + labels])
            metrics.append(m.accumulate())
        return metrics

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = [_as_tensor(x) for x in _to_list(inputs)]
        with no_grad():
            outputs = self.network(*inputs)
        return [o.numpy() for o in _to_list(outputs)]

    # -- loops (ref fit:1574) ---------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, jit_compile=None,
            steps_per_execution=1, prefetch_buffer=2, nan_policy="record",
            checkpoint=None, zero_stage=0, master_weights=False,
            zero_offload=False, grad_overlap=False):
        """Train loop.  ``jit_compile=None`` (default) tries the K-step
        trainer (``hapi/compiled.py``) and falls back to the eager
        ``train_batch`` loop when the network or configuration cannot take
        it (metrics, grad accumulation, a forward that reads device values
        on the host); ``True`` requires it, ``False`` forces eager.
        ``steps_per_execution=K`` runs K steps a call (losses come back
        per step; within a window the learning rate is read once, and a
        callback setting ``stop_training`` mid-window stops after the
        window's remaining updates already ran).  ``prefetch_buffer``
        batches are staged onto the device ahead of compute
        (``io.device_prefetch``).

        ``nan_policy``: the non-finite-loss watchdog, checked at the sync
        points the loop already pays (``log_freq`` loss fetches, epoch
        end).  A NaN/Inf loss increments ``train_nonfinite_total`` and
        records a flight-recorder event; ``"raise"`` also aborts.

        ``checkpoint=`` (crash-safe fit checkpoints), ``zero_stage>=1``,
        ``zero_offload`` and ``grad_overlap`` are ROADMAP Queue 1 item 12
        and raise ``NotImplementedError``; ``master_weights`` takes effect
        only with ZeRO and is ignored with a warning, as in the JAX
        package."""
        if checkpoint is not None:
            raise NotImplementedError(
                f"Model.fit(checkpoint=): crash-safe fit checkpoints "
                f"(parallel/checkpointing.py) {_DISTRIBUTED}")
        if int(zero_stage or 0) >= 1 or zero_offload or grad_overlap:
            raise NotImplementedError(
                f"Model.fit(zero_stage=, zero_offload=, grad_overlap=): the "
                f"ZeRO-sharded optimizer {_DISTRIBUTED}")
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = (self._to_loader(eval_data, batch_size, False, False,
                                       num_workers)
                       if eval_data is not None else None)
        cbks = _to_list(callbacks) or [ProgBarLogger(log_freq, verbose)]
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        cbk = CallbackList(cbks)
        cbk.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbk.set_params({"epochs": epochs, "steps": steps, "verbose": verbose})

        if nan_policy not in ("record", "raise"):
            raise ValueError(
                f"nan_policy must be 'record' or 'raise', got {nan_policy!r}")
        trainer = None
        if jit_compile is not False:
            from .compiled import CompiledTrainer, unsupported_reason
            reason = unsupported_reason(self, accumulate_grad_batches)
            if reason is None:
                trainer = CompiledTrainer(self, zero_stage=zero_stage,
                                          master_weights=master_weights,
                                          zero_offload=zero_offload,
                                          grad_overlap=grad_overlap)
            elif jit_compile:
                raise ValueError(
                    f"jit_compile=True, but the compiled fit path is "
                    f"unavailable: {reason}")
            else:
                self._log_fallback_once(
                    f"Model.fit: using the eager path ({reason})")
        self._fit_used_compiled = trainer is not None

        self.stop_training = False
        logs = {}   # epochs=0: on_train_end still needs a value
        try:
            cbk.on_train_begin()
            for epoch in range(epochs):
                cbk.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                if trainer is not None:
                    logs, trainer = self._run_compiled_epoch(
                        trainer, train_loader, cbk, log_freq, num_iters,
                        steps_per_execution, prefetch_buffer, nan_policy)
                    self._fit_used_compiled = trainer is not None
                else:
                    from ..observability import tracing as _tr
                    for step, batch in enumerate(train_loader):
                        if num_iters is not None and step >= num_iters:
                            break
                        cbk.on_train_batch_begin(step)
                        ins, lbs = self._split_batch(batch)
                        update = ((step + 1) % accumulate_grad_batches == 0)
                        res = self.train_batch(ins, lbs, update=update)
                        logs = self._pack_logs(res)
                        # eager losses are already host floats
                        # (train_batch float()s them): watch EVERY step —
                        # no log_freq=0 hole, no missed epoch tail
                        self._watch_nonfinite(logs.get("loss"), step,
                                              "hapi_eager", nan_policy)
                        # eager steps are host-synced, so each is a real
                        # liveness signal — without one a wedged eager
                        # fit never trips /healthz?max_age (an absent
                        # beacon passes; only a stale one alerts)
                        _tr.heartbeat("train.hapi_fit")
                        cbk.on_train_batch_end(step, logs)
                        if self.stop_training:
                            break
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, verbose=0,
                                              _callbacks=cbk)
                    logs.update({f"eval_{k}": v
                                 for k, v in eval_logs.items()})
                cbk.on_epoch_end(epoch, logs)
                if self.stop_training:
                    break
            cbk.on_train_end(logs)
            # clean completion: a finished fit must not leave a
            # forever-stale beacon 503ing /healthz?max_age (a crashed
            # fit keeps its beacon — going stale IS the alert)
            from ..observability import tracing as _tr_
            _tr_.remove_beacon("train.hapi_fit")
        except BaseException as e:
            # every crashed fit leaves a post-mortem: the flight ring
            # holds the recent step/telemetry events (and the watchdog's
            # nonfinite marks) that led up to the failure
            from ..observability import flight as _flight
            _flight.crash_dump("hapi.Model.fit", e)
            raise
        return logs

    def _log_fallback_once(self, msg):
        if not getattr(self, "_fallback_warned", False):
            self._fallback_warned = True
            import warnings
            warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def _watch_nonfinite(self, value, step, path, nan_policy):
        """Non-finite training watchdog (``fit(nan_policy=...)``): runs
        only at sync points where the loss is already on the host, so it
        never adds a device round trip.  Counts + flight-records every
        NaN/Inf; ``nan_policy='raise'`` aborts with a clear error."""
        import math
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if math.isfinite(v):
            return
        from ..observability import flight as _flight
        from ..observability import metrics as _obs
        _obs.get_registry().counter(
            "train_nonfinite_total",
            "non-finite (NaN/Inf) losses seen at fit sync points").labels(
                path=path).inc()
        _flight.get_flight_recorder().record(
            "train.nonfinite", path=path, step=int(step), loss=repr(v))
        if nan_policy == "raise":
            raise FloatingPointError(
                f"Model.fit: loss is non-finite ({v}) at step {step} — "
                "aborting instead of training on garbage (check the "
                "learning rate / data; nan_policy='record' continues "
                "and only counts)")

    def _run_compiled_epoch(self, trainer, loader, cbk, log_freq, num_iters,
                            k, prefetch_buffer, nan_policy="record"):
        """One epoch through the K-step trainer.  Returns ``(logs,
        trainer_or_None)``: None when the first superstep failed as the
        JAX package's first trace would (``HostReadInTrace``) and the epoch
        finished on the eager path instead.

        Telemetry rides the sync points the loop already pays (the
        ``log_freq`` loss fetch and the epoch-end fetch): on the card a
        CUDA event is recorded after each superstep, and at a fetch the
        window's device time is the elapsed time between the events
        bounding it, read once the fetch has synchronised; on the CPU the
        window is the host wall time.  A window counts the steps of the
        supersteps dispatched in it (a fetch inside a superstep closes the
        window after that whole superstep, whose event bounds it).  ``train_step_seconds``,
        ``train_tokens_per_sec``, ``train_phase_seconds_per_step``
        (dispatch = the Python call of each superstep, host_wait = the
        fetch stalls, device = the rest of the window) and ``train_mfu``
        (over ``cost_model.device_peak_flops``, left unset when the peak
        is unknown) are set per window; no synchronisation is added."""
        import itertools
        import time

        from ..cost_model import device_peak_flops, train_flops_per_token
        from ..io.dataloader import device_prefetch
        from ..observability import metrics as _obs
        from ..observability import tracing as _tr
        from .compiled import HostReadInTrace

        _reg = _obs.get_registry()
        _h_step = _reg.histogram(
            "train_step_seconds",
            "mean per-step time between loss fetches (device time between "
            "CUDA events on the card)", unit="s").labels(
                path="hapi_compiled")
        _g_tps = _reg.gauge(
            "train_tokens_per_sec",
            "training throughput between loss fetches "
            "(tokens = batch x seqlen; batch for 1-D samples)").labels(
                path="hapi_compiled")
        _phase_fam = _reg.gauge(
            "train_phase_seconds_per_step",
            "mean seconds per step attributed to each step phase over the "
            "last telemetry window (dispatch = Python superstep calls, "
            "host_wait = loss-fetch stalls, device = the remainder)",
            unit="s")
        _g_phase = {ph: _phase_fam.labels(path="hapi_compiled", phase=ph)
                    for ph in ("dispatch", "host_wait", "device")}
        # one card's peak: the trainer runs on the parameters' device
        _peak = device_peak_flops()
        _g_mfu = _reg.gauge(
            "train_mfu",
            "model FLOPs utilization between loss fetches "
            "(cost_model.train_flops_per_token x tokens/s over "
            "device_peak_flops; unset when the peak is unknown)").labels(
                path="hapi_compiled") if _peak else None
        cuda = trainer._device.type == "cuda"
        _flops_tok = None      # resolved lazily (needs the seqlen)
        _seqlen = None
        _t_mark = _ev_mark = _ev_last = None
        _steps_since = _tokens_since = 0
        _disp_ns = _fetch_ns = 0

        def _telemetry_tick():
            """Close the current telemetry window after a fetch; returns
            the phase/MFU attribution dict, or None on the first window
            (its first superstep's warm-up pollutes nothing)."""
            nonlocal _t_mark, _ev_mark, _steps_since, _tokens_since, \
                _disp_ns, _fetch_ns, _flops_tok
            _tr.heartbeat("train.hapi_fit")   # /healthz last-step recency
            now = time.perf_counter()
            out = None
            if _t_mark is not None and _steps_since:
                dt = now - _t_mark
                if cuda and _ev_mark is not None and _ev_last is not None:
                    dt = _ev_mark.elapsed_time(_ev_last) / 1e3
                if dt > 0:
                    per_step = dt / _steps_since
                    _h_step.observe(per_step)
                    tps = _tokens_since / dt
                    _g_tps.set(tps)
                    disp = _disp_ns / 1e9 / _steps_since
                    wait = _fetch_ns / 1e9 / _steps_since
                    dev = max(per_step - disp - wait, 0.0)
                    _g_phase["dispatch"].set(disp)
                    _g_phase["host_wait"].set(wait)
                    _g_phase["device"].set(dev)
                    out = {"steps": _steps_since,
                           "dispatch_ms_per_step": round(disp * 1e3, 3),
                           "host_wait_ms_per_step": round(wait * 1e3, 3),
                           "device_ms_per_step": round(dev * 1e3, 3)}
                    if _peak:
                        if _flops_tok is None:
                            _flops_tok = train_flops_per_token(
                                self.network, seqlen=_seqlen)
                        mfu = tps * _flops_tok / _peak
                        _g_mfu.set(mfu)
                        out["mfu"] = round(mfu, 4)
            _t_mark, _ev_mark = now, _ev_last
            _steps_since, _tokens_since = 0, 0
            _disp_ns = _fetch_ns = 0
            return out

        k = max(int(k), 1)
        it = iter(loader)
        pulled = 0
        if num_iters is not None:
            num_iters = max(int(num_iters), 0)

        def _leaf(v):
            return v._value if isinstance(v, Tensor) else np.asarray(v)

        def _stack(vals):
            if all(isinstance(v, np.ndarray) for v in vals):
                return np.stack(vals)
            return torch.stack([torch.as_tensor(v) for v in vals])

        def host_groups():
            nonlocal pulled
            while not self.stop_training:
                group = []
                while len(group) < k and (num_iters is None
                                          or pulled < num_iters):
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    pulled += 1
                    ins, lbs = self._split_batch(batch)
                    group.append((tuple(_leaf(v) for v in ins),
                                  tuple(_leaf(v) for v in lbs)))
                if not group:
                    return
                xs = tuple(_stack([g[0][i] for g in group])
                           for i in range(len(group[0][0])))
                ys = tuple(_stack([g[1][i] for g in group])
                           for i in range(len(group[0][1])))
                yield (xs, ys)

        step = 0
        last_watched = -1   # last step index the watchdog already saw
        logs = {}
        last = None
        groups = device_prefetch(host_groups(), size=prefetch_buffer,
                                 device=trainer._device)
        for xs, ys in groups:
            t0n = time.perf_counter_ns()
            try:
                losses = trainer.run(xs, ys)
            except HostReadInTrace as e:
                # the JAX package's trace failure: only the first
                # superstep runs under the guard, before any update reached
                # the live parameters, so the eager replay starts clean
                self._log_fallback_once(
                    "Model.fit: compiled trainer failed to trace "
                    f"({type(e).__name__}: {e}); falling back to eager")
                trainer.restore_eager()
                for exs, eys in itertools.chain([(xs, ys)], groups):
                    n = int(exs[0].shape[0])
                    for j in range(n):
                        cbk.on_train_batch_begin(step)
                        res = self.train_batch(
                            [_as_tensor(x[j]) for x in exs],
                            [_as_tensor(y[j]) for y in eys])
                        logs = self._pack_logs(res)
                        # host floats already: watch every replayed step
                        self._watch_nonfinite(logs.get("loss"), step,
                                              "hapi_eager", nan_policy)
                        _tr.heartbeat("train.hapi_fit")
                        cbk.on_train_batch_end(step, logs)
                        step += 1
                        if self.stop_training:
                            break
                    if self.stop_training:
                        break
                return logs, None
            if cuda:
                _ev_last = torch.cuda.Event(enable_timing=True)
                _ev_last.record()
            t1n = time.perf_counter_ns()
            n = int(losses.shape[0])
            if _tr.tracing_enabled():
                # the Python call of the K-step superstep (the device time
                # shows up in the loss_fetch spans instead)
                _tr.add_span("hapi.fit.superstep", t0n, t1n, step=step, k=k)
            lead = xs[0]   # (K, B, ...) stacked batches
            # tokens = B*S only for token batches (K, B, S); any other
            # rank counts samples
            _seqlen = int(lead.shape[2]) if lead.dim() == 3 else None
            _steps_since += n
            _tokens_since += n * int(lead.shape[1]) * (_seqlen or 1)
            _disp_ns += t1n - t0n
            for j in range(n):
                cbk.on_train_batch_begin(step)
                # the loss leaves the device only at log_freq boundaries;
                # other steps hand callbacks the 0-d device tensor
                v = losses[j]
                if log_freq and step % log_freq == 0:
                    tf0 = time.perf_counter_ns()
                    v = float(v)
                    tf1 = time.perf_counter_ns()
                    _fetch_ns += tf1 - tf0   # phase: host wait on fetch
                    phases = _telemetry_tick()
                    if _tr.tracing_enabled():
                        _tr.add_span("hapi.fit.loss_fetch", tf0, tf1,
                                     step=step, **(phases or {}))
                    self._watch_nonfinite(v, step, "hapi_compiled",
                                          nan_policy)
                    last_watched = step
                logs = {"loss": v}
                cbk.on_train_batch_end(step, logs)
                step += 1
                last = (losses, j)
                if self.stop_training:
                    break
            if self.stop_training:
                break
        if last is not None:
            # epoch-end fetch; report the loss of the last step callbacks
            # actually saw (a mid-window stop must not report past it)
            losses, j = last
            tf0 = time.perf_counter_ns()
            final = float(losses[j])
            tf1 = time.perf_counter_ns()
            _fetch_ns += tf1 - tf0
            phases = _telemetry_tick()
            if _tr.tracing_enabled():
                _tr.add_span("hapi.fit.loss_fetch", tf0, tf1,
                             step=step - 1, epoch_end=True,
                             **(phases or {}))
            logs = {"loss": final}
            if step - 1 != last_watched:
                # one bad step counts once, not twice
                self._watch_nonfinite(logs["loss"], step - 1,
                                      "hapi_compiled", nan_policy)
        trainer.sync_optimizer()
        return logs, trainer

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None,
                 _callbacks=None):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbk = _callbacks or CallbackList(_to_list(callbacks))
        for m in self._metrics:
            m.reset()
        cbk.on_eval_begin()
        logs = {}
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            cbk.on_eval_batch_begin(step)
            ins, lbs = self._split_batch(batch)
            res = self.eval_batch(ins, lbs)
            logs = self._pack_logs(res)
            cbk.on_eval_batch_end(step, logs)
        cbk.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, num_iters=None):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            ins, _ = self._split_batch(batch, has_labels=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # -- save / load (ref model.py save:1373) -----------------------------
    def save(self, path, training=True):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        from ..framework.io import save as fsave
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload
        self.network.set_state_dict(fload(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary
        return summary(self.network, input_size, dtypes=dtype)

    # -- helpers ----------------------------------------------------------
    def _to_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        from ..io.dataloader import DataLoader
        from ..io.dataset import Dataset
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data  # already a loader/iterable

    def _split_batch(self, batch, has_labels=True):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        n_in = len(_to_list(self._inputs))
        if not n_in:
            if has_labels and len(batch) > 1:
                n_in = len(batch) - 1
            else:
                # no inputs spec: cap at the network's forward arity so a
                # labelled dataset still works for predict()
                import inspect
                try:
                    sig = inspect.signature(self.network.forward)
                    n_pos = sum(
                        1 for p in sig.parameters.values()
                        if p.kind in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD))
                    n_in = min(len(batch), n_pos)
                except (TypeError, ValueError):
                    n_in = len(batch)
        ins = batch[:n_in]
        lbs = batch[n_in:] if has_labels else []
        return ins, lbs

    def _pack_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            losses, metrics = res
            for m, v in zip(self._metrics, metrics):
                name = m.name()
                logs[name if isinstance(name, str) else name[0]] = (
                    v if not isinstance(v, (list, tuple)) else v[0])
        else:
            losses = res
        logs["loss"] = losses[0] if isinstance(losses, list) else losses
        return logs
