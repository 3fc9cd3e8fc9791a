"""Continuous-batching serving engine: the port of the JAX package's
``inference/serving.py`` (its synchronous driver, FIFO admission, dense
and paged KV caches, and the prefix cache).

Each tick advances every occupied slot.  While some slot is prefilling,
the CHUNK tick runs one forward of up to ``chunk`` tokens per slot
(prompt chunks and width-1 decode feeds in one batch) and samples each
slot's next token at its last valid position.  When every slot decodes,
the MULTI tick runs ``decode_window`` width-1 steps with the sampled
token fed back on the device, and fetches the window's tokens once.  The
host side is a slot scheduler: admit from a FIFO into free slots, stage
each slot's next chunk, commit sampled tokens, retire finished requests.

``cache_mode="paged"`` keeps each layer's KV in a global page pool with
per-slot page tables (``inference/paged.py``): admission reserves a
request's actual page footprint instead of a ``max_len`` slot, the radix
prefix cache lets a request sharing a page-aligned prompt prefix map the
same pages and prefill only its suffix, and attention reads K/V through
the table with the paged-attention kernel
(``incubate/nn/kernels/paged_attention.py``) on the card.

The serving artifact: :func:`save_for_serving` writes ``{config.json,
params.npz}`` in the JAX package's format (optionally weight-only int8 or
fp8-e4m3 quantized), atomically; :func:`load_for_serving` rebuilds the
model on the card, with ``nn.quant.WeightOnlyLinear`` shells at the
quantized projections, whose forward runs the dequant-GEMM kernel K4
(``incubate/nn/kernels/quant_matmul.py``).  Artifacts move between the two
packages in both directions.

Speculative decoding (``spec_k``, ``drafter``): when every slot
decodes and one is greedy, the VERIFY tick runs one forward of width
``spec_k + 1`` over the drafter's proposals (``nn/decode.py``), through
the dense cache or the paged kernel's split decode, and commits each
slot's longest prefix matching the model's greedy argmax.

The engine reports through the port's ``observability/`` as the
reference does: ``serving_*`` counters (the ``stats`` view), latency and
tick histograms, gauges, spans and flight-recorder events.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the auto_run background loop, sessions, priorities/preemption,
deadlines, ``prefill_budget``, streaming ``on_token`` hooks, defrag, MoE
and pipeline-parallel ticks, request tracing (``trace_ctx``),
``introspect_requests``, ``load_report`` and ``slo_windows``.
``inference/predictor.py``'s ``create_predictor``, which also serves an
artifact directory, is not ported either.
"""

from __future__ import annotations

import collections
import collections.abc
import dataclasses
import glob
import itertools
import json
import os
import shutil
import threading
import time
import uuid
from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.random import default_generator
from ..models import gpt as _gpt
from ..nn.decode import accept_lengths, get_drafter
from ..nn.quant import weight_only as _wo
from ..observability import faults as _faults
from ..observability import flight as _flight
from ..observability import metrics as _obs
from ..observability import tracing as _tr
from ..observability.sanitizers import device_get, make_lock
from ..utils.convert import check_state, dtype_name, to_stored, to_tensor
from .paged import NULL_PAGE, PagePool, PrefixCache, pages_for

_ROADMAP = "ROADMAP Queue 1 item 10 (ServingEngine)"
_ENGINE_IDS = itertools.count()
_REQ_IDS = itertools.count()

# The reference's SLO priority classes: the engine registers a queue-depth
# series for each, and every request is "default" until priority classes
# are ported.
PRIORITY_RANK = {"interactive": 0, "default": 1, "batch": 2}


def _not_ported(what: str, item: str = _ROADMAP) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {item}")


class _EngineStats(collections.abc.Mapping):
    """Dict view over the engine's registry series: the reference's
    ``engine.stats`` keys read straight from the labelled
    ``serving_*_total`` counters, and the port's ``chunk_ticks`` /
    ``decode_ticks`` from the counts of the ``serving_tick_seconds``
    histogram's ``prefill`` and ``decode`` flavors."""

    _KEYS = ("ticks", "tokens", "requests",
             "spec_ticks", "spec_drafted", "spec_accepted",
             "prefix_hit_tokens", "prompt_tokens", "prefix_hit_rate",
             "session_resumes", "session_hit_tokens", "preemptions",
             "chunk_ticks", "decode_ticks")
    _TICKS = {"chunk_ticks": "prefill", "decode_ticks": "decode"}

    def __init__(self, counters, tick_hists):
        self._counters = counters      # key -> Counter child
        self._tick_hists = tick_hists  # flavor -> Histogram child

    def __getitem__(self, k):
        if k == "prefix_hit_rate":
            # prompt tokens the prefix cache saved re-prefilling over all
            # prompt tokens admitted (0.0 until any admit)
            pt = int(self._counters["prompt_tokens"].value)
            hit = int(self._counters["prefix_hit_tokens"].value)
            return hit / pt if pt else 0.0
        if k in self._TICKS:
            return int(self._tick_hists[self._TICKS[k]].count)
        return int(self._counters[k].value)

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def __repr__(self):
        return repr(dict(self))


class TornArtifactError(RuntimeError):
    """A serving artifact directory is incomplete: a crash mid-save by a
    writer that was not atomic, or a partial copy.  :func:`save_for_serving`
    commits atomically (tmp dir + rename), so a torn directory is always
    made elsewhere; :func:`load_for_serving` refuses to half-load it."""


def _fsync_dir(path: str) -> None:
    """fsync a directory, so a rename inside it is durable."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sweep_stale_saves(path: str) -> None:
    """Remove tmp dirs orphaned by a DEAD process's hard kill (each holds a
    full-model-size params.npz nothing else would delete).  A dir whose
    owner pid is alive (this process included: a concurrent thread's
    save) is left alone."""
    for stale in glob.glob(f"{path}.saving-*"):
        try:
            pid = int(stale.split(".saving-", 1)[1].split("-", 1)[0])
            os.kill(pid, 0)       # raises if the owner is gone
            continue              # owner alive: not ours to sweep
        except (ValueError, ProcessLookupError):
            pass                  # malformed name or dead owner: sweep
        except PermissionError:
            continue              # alive under another uid
        shutil.rmtree(stale, ignore_errors=True)


def _write_file(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_for_serving(model, path, quant=None):
    """Persist ``{config.json, params.npz}`` in the JAX package's format, so
    either package's :func:`load_for_serving` rebuilds the model.

    ATOMIC: both files land in a tmp directory (``params.npz`` first,
    ``config.json``, the manifest, last, both fsync'd), which is then
    renamed over ``path`` (the previous artifact waits at ``path.old``
    during the swap); a crash mid-save leaves the previous artifact (or
    nothing), never a torn directory.  Sidecar files next to the two
    (a tokenizer, say) are carried into the replacement.

    bf16 and fp8 store as ``uint16``/``uint8`` views with the dtype's name
    in ``config.json``'s ``param_dtypes``.  ``quant="int8"`` (or ``"fp8"``)
    quantizes the attention/MLP projection weights on the host at save
    time (``nn.quant.quantize_weights``: the JAX package's bits): int8 /
    fp8 values plus f32 per-output-channel ``<name>_scale`` entries, and
    ``{"quant": {"scheme", "params"}}`` in ``config.json``.  A model that
    already holds quantized layers records the same manifest without
    ``quant=``.  Embeddings, layer norms and the tied logits head stay in
    the float dtype."""
    # quantize and store from host copies: the bits do not depend on the
    # device the model sits on
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    scheme = None
    if quant is not None:
        scheme = _wo.resolve_scheme(quant)
        params, _ = _wo.quantize_weights(params, scheme)
    # manifest by inspection (covers both quant= and pre-quantized trees):
    # a weight with a `_scale` sibling is a quantized Linear the loader
    # must swap before loading state
    manifest = sorted(k for k in params if k + "_scale" in params)
    arrs = {k: to_stored(v) for k, v in params.items()}
    dtypes = {k: dtype_name(v.dtype) for k, v in params.items()}
    meta = {"model": type(model).__name__,
            "config": dataclasses.asdict(model.config),
            "param_dtypes": dtypes}
    if manifest:
        if scheme is None:
            scheme = ("int8" if dtypes[manifest[0]] == "int8"
                      else "fp8-e4m3")
        meta["quant"] = {"scheme": scheme, "params": manifest}
    path = os.fspath(path)
    # pid names the owner for the stale sweep; the uuid keeps concurrent
    # saves from threads of one process off each other's tmp dirs
    tmp = f"{path}.saving-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    old = f"{path}.old"
    _sweep_stale_saves(path)
    os.makedirs(tmp)
    try:
        _write_file(os.path.join(tmp, "params.npz"),
                    lambda f: np.savez(f, **arrs))
        _write_file(os.path.join(tmp, "config.json"),
                    lambda f: f.write(json.dumps(meta).encode()))
        # after a crash inside a swap window the live artifact is .old, so
        # the sidecars come from there
        side_src = path if os.path.isdir(path) else (
            old if os.path.isdir(old) else None)
        if side_src is not None:
            for n in os.listdir(side_src):
                if n in ("config.json", "params.npz"):
                    continue
                src, dst = os.path.join(side_src, n), os.path.join(tmp, n)
                if os.path.isdir(src):
                    shutil.copytree(src, dst)
                else:
                    shutil.copy2(src, dst)
        if os.path.isdir(path):
            # `path` is complete, so a stale .old is disposable; never
            # delete .old while it may be the only valid copy (`path`
            # missing after a crash in an earlier swap window)
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_for_serving(path, device=None):
    """Rebuild the model saved by either package's ``save_for_serving``,
    on ``device`` (``None``: the CUDA card; ``"cpu"`` for the plain path).

    Quantized projections get empty ``WeightOnlyLinear`` shells at the
    manifest paths BEFORE state loads, so the int8/fp8 weights land in the
    serving layers directly; every parameter comes back in its saved
    dtype.  A torn artifact (a missing or unparsable ``config.json``, a
    missing ``params.npz``) raises :class:`TornArtifactError`; a directory
    caught between the two renames of an atomic re-save falls back to the
    surviving ``.old`` artifact."""
    dev = resolve_device(device)
    path = os.fspath(path)
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"      # crash inside a save's swap window
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    cfg_p = os.path.join(path, "config.json")
    npz_p = os.path.join(path, "params.npz")
    for p in (cfg_p, npz_p):
        if not os.path.exists(p):
            raise TornArtifactError(
                f"serving artifact at {path} is torn: {os.path.basename(p)} "
                f"is missing (a crash mid-write by a writer that was not "
                f"atomic, or a partial copy); re-export with "
                f"save_for_serving")
    try:
        with open(cfg_p) as f:
            meta = json.load(f)
    except ValueError as e:
        raise TornArtifactError(
            f"serving artifact at {path} is torn: config.json does not "
            f"parse ({e}); re-export with save_for_serving") from e
    cls = getattr(_gpt, meta["model"], None)
    if cls is None:
        raise NotImplementedError(
            f"serving artifact model {meta['model']!r} is not ported yet: "
            f"ROADMAP Queue 1 item 11")
    model = cls(_gpt.GPTConfig(**meta["config"]), device=dev)
    model.eval()
    q = meta.get("quant")
    if q:
        _wo.apply_weight_only(model, q["scheme"], names=q["params"])
    dtypes = meta.get("param_dtypes", {})
    with np.load(npz_p) as z:
        state = {k: to_tensor(z[k], dtypes.get(k)) for k in z.files}
    params = check_state(model, state)
    with torch.no_grad():
        for k, t in state.items():
            # the saved dtype, as the JAX loader restores it (a name
            # without a recorded dtype takes the parameter's own)
            p = params[k]
            p.data = t.to(dev, t.dtype if k in dtypes else p.dtype)
    return model


class Request:
    """One in-flight generation request.  ``temperature``/``top_k``/
    ``top_p`` override the engine's sampling defaults (None = inherit).
    ``rid`` is the process-wide request id its spans and flight records
    carry; ``t_submit``/``t_first``/``t_finish`` are
    ``time.perf_counter()`` stamps."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature", "top_k",
                 "top_p", "tokens", "done", "error", "_event", "t_submit",
                 "t_first", "t_finish", "_span_queue", "_span_life")

    def __init__(self, prompt, max_new_tokens, temperature=None, top_k=None,
                 top_p=None):
        self.rid = next(_REQ_IDS)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = None if temperature is None else float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self.tokens: List[int] = []
        self.done = False
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_finish: Optional[float] = None
        # lifecycle spans (no-ops while tracing is disabled): queued =
        # submit->admit, life = submit->finish
        self._span_queue = self._span_life = _tr._NOOP

    @property
    def ttft_s(self) -> Optional[float]:
        """Seconds from submit to the first generated token."""
        return None if self.t_first is None else self.t_first - self.t_submit

    def wait(self, timeout=None):
        self._event.wait(timeout)
        return self.done

    def result(self):
        """Full sequence (prompt + generated), like ``model.generate``."""
        if self.error is not None:
            raise RuntimeError("request failed in the engine") from self.error
        if not self.done:
            raise RuntimeError("request not finished; wait() first")
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])


class _Slot:
    __slots__ = ("req", "off", "last", "seq")

    def __init__(self):
        self.req: Optional[Request] = None
        self.off = 0      # prefill-source tokens consumed
        self.last = 0     # last sampled token (decode feed)
        self.seq = None   # the slot's prefill source (the prompt)


class ServingEngine:
    """Slot-based continuous batching, driven synchronously by
    :meth:`step` / :meth:`run_until_idle`.

    Args (as in the JAX engine):
      model: a ``GPTForCausalLM`` (tied LM head); the engine runs on its
        device and dtype.
      max_slots: concurrent request capacity (the batch B of every tick).
      max_len: per-slot KV capacity; a request needs
        ``len(prompt) + max_new_tokens <= max_len - max(chunk, spec_k+1)``
        (headroom for the widest in-flight cache write).
      chunk: prefill chunk width per tick.
      temperature/top_k/top_p: engine-default sampling (0.0 = greedy,
        token-exact against ``model.generate(temperature=0.0)``);
        :meth:`submit` may override them per request.
      eos_token_id: optional early-stop token.
      decode_window: width-1 decode steps per multi tick (at most
        ``chunk``).
      spec_k: speculative decoding: when every active slot decodes and
        at least one is greedy, a VERIFY tick scores ``spec_k`` drafted
        tokens and the pending one in one forward of width
        ``spec_k + 1`` and commits the longest prefix that matches the
        model's greedy argmax (greedy output stays token-exact).
      drafter: ``"ngram"`` (prompt lookup), a small ``GPTForCausalLM``
        (``nn.decode.ModelDrafter``) or an object speaking the drafter
        interface (``nn/decode.py``).
      cache_mode: ``"dense"`` (per-slot ``max_slots x max_len`` regions) or
        ``"paged"`` (a global page pool with per-slot page tables).
      page_size: KV rows per page (paged mode).
      num_pages: pool size INCLUDING the reserved null page 0; default
        ``max_slots * ceil(max_len / page_size) + 1``.
      prefix_cache: keep finished prompts' full pages in a radix cache for
        later requests sharing a page-aligned prefix (paged mode).
    The reference's other parameters stand in its order and take its
    defaults; a value that needs a part not ported yet raises
    ``NotImplementedError`` (``prefill_budget``, ``slo_window_s``,
    ``session_ttl_s``/``max_sessions``, ``priority_aging_s``), and
    ``preempt``/``preempt_limit`` change nothing (no request is ever
    preempted without priority classes).  ``auto_run`` defaults to False
    here: the background loop is not ported (True raises).
    Temperature > 0 sampling draws from the device's default
    ``torch.Generator`` (``core/random.py``).

    The engine reports through ``observability/``, as the reference
    does: ``stats`` is a dict view over its ``serving_*_total`` counters
    in the process-wide registry (labelled ``engine=<engine_id>``),
    beside the TTFT / TPOT / e2e / tick-time histograms, the occupancy,
    queue and page gauges, ``serving_weight_bytes``, the ``serving.*``
    spans (while tracing is on) and the flight recorder's tick and
    request events.
    """

    def __init__(self, model, max_slots=8, max_len=512, chunk=16,
                 temperature=0.0, top_k=None, eos_token_id=None,
                 auto_run=False, decode_window=8, top_p=None, spec_k=0,
                 drafter="ngram", cache_mode="dense", page_size=16,
                 num_pages=None, prefix_cache=True, slo_window_s=60.0,
                 session_ttl_s=None, max_sessions=64,
                 priority_aging_s=30.0, prefill_budget=None,
                 preempt=True, preempt_limit=2):
        if auto_run:
            raise _not_ported("the auto_run background loop (drive the "
                              "engine with step()/run_until_idle())")
        if prefill_budget is not None:
            raise _not_ported("prefill_budget")
        if slo_window_s != 60.0:
            raise _not_ported("the SLO telemetry window (slo_window_s)")
        if session_ttl_s is not None or max_sessions != 64:
            raise _not_ported("multi-turn sessions (session_ttl_s, "
                              "max_sessions)")
        if priority_aging_s != 30.0:
            raise _not_ported("priority classes and aging "
                              "(priority_aging_s)")
        # preempt / preempt_limit only bound preemption, which needs
        # priority classes: with every request at the default priority
        # nothing is preempted, whatever their values
        if cache_mode not in ("dense", "paged"):
            raise ValueError(f"cache_mode must be 'dense' or 'paged', "
                             f"got {cache_mode!r}")
        model.eval()
        self.model = model
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.chunk = int(chunk)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self._decode_window = max(1, min(int(decode_window), self.chunk))
        self.spec_k = int(spec_k)
        # headroom past the last committed row for the widest in-flight
        # write (a prefill chunk, or the spec_k+1 wide verify block);
        # without it a tail write would land on committed rows
        self._reserve = max(self.chunk, self.spec_k + 1)
        cfg = model.config
        self._device = model.device
        self._gen = default_generator(self._device)

        self._lock = make_lock("serving.engine")
        self._pending = collections.deque()
        self._slots = [_Slot() for _ in range(self.max_slots)]
        self._lengths = np.zeros(self.max_slots, np.int32)
        self._closed = False
        self._tickno = 0
        # device copies of per-tick constants, restaged only when slot
        # membership (sampling) or the page tables change
        self._sampling_cache = None
        self._sampling_dev = None
        self._pt_dev = None
        self._init_metrics()
        # per-replica fault point name, precomputed (probed every tick)
        self._tick_fault_point = f"serving.tick[{self._engine_id}]"

        self._spec = None
        if self.spec_k > 0:
            self._spec = get_drafter(drafter, self.spec_k)
            self._spec.begin(self.max_slots, self.max_len)

        self.cache_mode = cache_mode
        self._paged = cache_mode == "paged"
        self._pool = self._prefix = None
        heads, head_dim = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        w = model.gpt.wte.weight
        if self._paged:
            self._page_size = int(page_size)
            if self._page_size < 1:
                raise ValueError("page_size must be >= 1")
            self._pages_per_slot = -(-self.max_len // self._page_size)
            if num_pages is None:
                num_pages = self.max_slots * self._pages_per_slot + 1
            self._pool = PagePool(int(num_pages), self._page_size)
            if prefix_cache:
                self._prefix = PrefixCache(self._pool)
            self._page_tables = np.zeros(
                (self.max_slots, self._pages_per_slot), np.int32)
            self._slot_pages = [[] for _ in range(self.max_slots)]
            self._g_pages_free.set(self._pool.free)
            shape = (self._pool.num_pages, self._page_size, heads, head_dim)
        else:
            shape = (self.max_slots, self.max_len, heads, head_dim)
        self._caches = [(w.new_zeros(shape), w.new_zeros(shape))
                        for _ in range(cfg.num_layers)]

    # ------------------------------------------------------------ metrics
    def _init_metrics(self):
        """Register this engine's series, as the reference engine does:
        one ``engine`` label per instance keeps concurrently-live engines
        from mixing series; ``self.stats`` is the dict-shaped view.  The
        families of stages not ported yet (sessions, defrag, preemption,
        priority classes) are registered and stay at 0."""
        reg = self._registry = _obs.get_registry()
        self._engine_id = f"e{next(_ENGINE_IDS)}"
        lbl = {"engine": self._engine_id}
        counters = {
            "ticks": reg.counter(
                "serving_ticks_total", "engine ticks run"),
            "tokens": reg.counter(
                "serving_tokens_total", "generated tokens committed"),
            "requests": reg.counter(
                "serving_requests_total", "requests submitted"),
            "spec_ticks": reg.counter(
                "serving_spec_ticks_total", "speculative verify ticks"),
            "spec_drafted": reg.counter(
                "serving_spec_drafted_total",
                "draft tokens proposed (capped at request budget)"),
            "spec_accepted": reg.counter(
                "serving_spec_accepted_total",
                "draft tokens accepted AND committed"),
            "prefix_hit_tokens": reg.counter(
                "serving_prefix_hit_tokens_total",
                "prompt tokens served from cached prefix pages "
                "(re-prefill skipped; paged cache mode only)"),
            "prompt_tokens": reg.counter(
                "serving_prompt_tokens_total",
                "prompt tokens of admitted requests (all cache modes)"),
            "completed_tokens": reg.counter(
                "serving_completed_tokens_total",
                "generated tokens of requests that finished"),
            "aborted_tokens": reg.counter(
                "serving_aborted_tokens_total",
                "generated tokens of requests that failed/aborted "
                "(work the caller never got)"),
            "session_resumes": reg.counter(
                "serving_session_resumes_total",
                "turns resumed from a retained session's KV pages"),
            "session_hit_tokens": reg.counter(
                "serving_session_hit_tokens_total",
                "prompt tokens served from retained session pages "
                "(re-prefill skipped; paged cache mode only)"),
            "sessions_evicted": reg.counter(
                "serving_sessions_evicted_total",
                "retained sessions evicted (TTL/LRU/admission "
                "pressure/drain/drop)"),
            "defrag_total": reg.counter(
                "serving_defrag_total",
                "KV page-pool compactions run"),
            "defrag_pages_moved": reg.counter(
                "serving_defrag_pages_moved_total",
                "KV pages relocated by pool compactions"),
            "preemptions": reg.counter(
                "serving_preemptions_total",
                "in-flight streams preempted by higher-priority "
                "admission (pages released/demoted, request re-queued)"),
            "preempt_replay_tokens": reg.counter(
                "serving_preempt_replay_tokens_total",
                "committed rows re-prefilled when a preempted stream "
                "resumed (rows the prefix/session cache did not cover "
                "— the preemption cost the cache could not absorb)"),
        }
        self._c = {k: fam.labels(**lbl) for k, fam in counters.items()}
        self._h_ttft = reg.histogram(
            "serving_ttft_seconds",
            "submit to first generated token", unit="s").labels(**lbl)
        self._h_tpot = reg.histogram(
            "serving_tpot_seconds",
            "mean inter-token latency past the first token",
            unit="s").labels(**lbl)
        self._h_e2e = reg.histogram(
            "serving_e2e_seconds",
            "submit to request completion", unit="s").labels(**lbl)
        tick_fam = reg.histogram(
            "serving_tick_seconds",
            "device tick wall time by program flavor", unit="s")
        self._h_tick = {f: tick_fam.labels(flavor=f, **lbl)
                        for f in ("prefill", "decode", "spec", "pp")}
        self._h_accept = reg.histogram(
            "serving_spec_accept_ratio",
            "per-spec-tick accepted/drafted ratio",
            buckets=_obs.RATIO_BUCKETS).labels(**lbl)
        self.stats = _EngineStats(self._c, self._h_tick)
        self._g_occupancy = reg.gauge(
            "serving_batch_occupancy",
            "slots holding an active request this tick").labels(**lbl)
        self._g_queue = reg.gauge(
            "serving_queue_depth", "requests waiting for a slot").labels(**lbl)
        cls_fam = reg.gauge(
            "serving_class_queue_depth",
            "queued requests per priority class")
        self._g_class_queue = {
            c: cls_fam.labels(**{"class": c}, **lbl) for c in PRIORITY_RANK}
        # the weight bytes a decode tick reads: every parameter (quant
        # scales included) and buffer of the model (the head ties wte)
        self._g_weight_bytes = reg.gauge(
            "serving_weight_bytes",
            "model weight bytes resident for the decode tick "
            "(params + quant scales + buffers)").labels(**lbl)
        self._g_weight_bytes.set(
            sum(t.numel() * t.element_size() for t in
                [*self.model.parameters(), *self.model.buffers()]))
        self._g_pages_used = reg.gauge(
            "serving_kv_pages_in_use",
            "KV pool pages currently allocated").labels(**lbl)
        self._g_pages_free = reg.gauge(
            "serving_kv_pages_free",
            "KV pool pages on the free list").labels(**lbl)
        self._g_sessions = reg.gauge(
            "serving_sessions_retained",
            "multi-turn KV sessions currently retained").labels(**lbl)
        self._g_session_pages = reg.gauge(
            "serving_session_pages_retained",
            "distinct KV pages pinned by retained sessions").labels(**lbl)
        self._flight = _flight.get_flight_recorder()

    @property
    def engine_id(self) -> str:
        """Stable per-process replica name (``e<N>``): the label on this
        engine's metric series, its liveness beacon (``serving.<id>``) and
        its per-replica fault point (``serving.tick[<id>]``)."""
        return self._engine_id

    def _set_pool_gauges_locked(self):
        self._g_pages_used.set(self._pool.allocated)
        self._g_pages_free.set(self._pool.free)

    def _set_queue_gauges_locked(self):
        # every request is in the default class until priority classes
        # are ported
        self._g_queue.set(len(self._pending))
        for c, g in self._g_class_queue.items():
            g.set(len(self._pending) if c == "default" else 0)

    # ------------------------------------------------------------ intake
    def submit(self, prompt, max_new_tokens=32, temperature=None,
               top_k=None, top_p=None, deadline_s=None, on_token=None,
               session=None, priority=None, trace_ctx=None) -> Request:
        """Queue a request; the engine serves it on later ticks."""
        if trace_ctx is not None:
            raise _not_ported("request tracing (submit(trace_ctx=))")
        if deadline_s is not None:
            raise _not_ported("submit(deadline_s=)")
        if on_token is not None:
            raise _not_ported("streaming submit(on_token=)")
        if session is not None:
            raise _not_ported("multi-turn sessions (submit(session=))")
        if priority not in (None, "default"):
            raise _not_ported("priority classes and preemption")
        req = Request(prompt, max_new_tokens, temperature=temperature,
                      top_k=top_k, top_p=top_p)
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len - self._reserve:
            raise ValueError(
                f"request needs {need} cache rows; capacity is "
                f"max_len-max(chunk,spec_k+1)="
                f"{self.max_len - self._reserve}")
        if self._paged:
            # page-granular footprint on the final row index: a reserve
            # window can straddle a page boundary (pages_for)
            npages = pages_for(need, self._reserve, self._page_size)
            if npages > self._pool.usable:
                raise ValueError(
                    f"request needs {npages} KV pages; the pool has "
                    f"{self._pool.usable} usable pages "
                    f"(num_pages={self._pool.num_pages}, "
                    f"page_size={self._page_size})")
        max_pos = self.model.config.max_position_embeddings
        if need > max_pos:
            raise ValueError(
                f"request needs {need} positions; the model's "
                f"max_position_embeddings is {max_pos}")
        # _tid=rid puts every span of one request on one trace lane
        req._span_life = _tr.start_span(
            "serving.request", _tid=req.rid, rid=req.rid,
            engine=self._engine_id, prompt_len=len(req.prompt),
            max_new=req.max_new_tokens)
        req._span_queue = _tr.start_span(
            "serving.request.queued", _tid=req.rid, rid=req.rid,
            engine=self._engine_id)
        self._flight.record(
            "req", phase="submit", rid=req.rid, engine=self._engine_id,
            prompt_len=len(req.prompt), max_new=req.max_new_tokens)
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is shut down")
            self._pending.append(req)
            self._c["requests"].inc()
            self._set_queue_gauges_locked()
        return req

    def generate(self, prompt, max_new_tokens=32):
        """Submit one request and drive the engine until it finishes."""
        req = self.submit(prompt, max_new_tokens)
        self.run_until_idle()
        return req.result()

    # --------------------------------------------------------- admission
    def _admit(self):
        """Move pending requests into free slots, FIFO.  Paged mode also
        needs the request's page footprint to fit the pool: a head that
        does not fit stays queued, and later requests wait behind it.

        Returns the prefix-hit drafter replays ``[(slot, skip,
        lengths_snapshot, seq)]`` for the caller to run after releasing
        the engine lock (the replay runs the drafter's ingest, device
        work that must not hold the lock); it lands before this tick's
        forward and its post-verify ingest, on the same thread."""
        replays = []
        free = [i for i, s in enumerate(self._slots) if s.req is None]
        while self._pending and free:
            req = self._pending[0]
            i = free[0]
            skip = 0
            if self._paged:
                skip = self._paged_admit_locked(i, req, req.prompt)
                if skip is None:
                    break
            free.pop(0)
            self._pending.popleft()
            slot = self._slots[i]
            slot.req = req
            slot.seq = req.prompt
            slot.off = skip   # prefix hit: those rows are already KV
            slot.last = 0
            self._lengths[i] = skip
            self._sampling_cache = None  # membership changed: restage
            self._c["prompt_tokens"].inc(len(req.prompt))
            if skip and self._spec is not None:
                replays.append((i, skip, self._lengths.copy(),
                                req.prompt))
            queue_s = time.perf_counter() - req.t_submit
            req._span_queue.end(slot=i)
            self._flight.record(
                "req", phase="admit", rid=req.rid, engine=self._engine_id,
                slot=i, prefix_hit=skip, queue_s=round(queue_s, 6))
        return replays

    def _paged_admit_locked(self, i, req, seq):
        """Reserve slot ``i``'s whole page footprint up front (prompt +
        max_new + the write-window reserve, in pages); cached prefix pages
        map shared (refcount++) and their tokens skip prefill.  Returns the
        skipped token count, or None when the pool cannot fit the request
        yet."""
        P = self._page_size
        total = pages_for(len(req.prompt) + req.max_new_tokens,
                          self._reserve, P)
        hit = self._prefix.match(seq) if self._prefix is not None else []
        fresh_n = total - len(hit)
        short = fresh_n - self._pool.free
        if short > 0:
            # evict only when eviction can cover the shortfall: flushing a
            # hot prefix cache for a head that still cannot admit gains
            # nothing
            cache_ev = (self._prefix.cached_only()
                        if self._prefix is not None else 0)
            if cache_ev < short:
                if hit:
                    self._pool.decref(hit)  # hand the matched refs back
                return None
            self._prefix.evict(short)
        fresh = self._pool.alloc(fresh_n)
        if fresh is None:
            if hit:
                self._pool.decref(hit)
            return None
        pages = hit + fresh
        self._slot_pages[i] = pages
        self._page_tables[i] = NULL_PAGE
        self._page_tables[i, :len(pages)] = pages
        self._pt_dev = None   # table changed: restage on next tick
        self._c["prefix_hit_tokens"].inc(len(hit) * P)
        self._set_pool_gauges_locked()
        return len(hit) * P

    def _replay_skipped_to_drafter(self, i, skip, lengths, seq):
        """A prefix-cache hit skips re-prefilling rows [0, skip), but the
        drafter's mirror only sees what the target tick feeds it: without
        this replay it would propose from a hole in its history (never
        wrong tokens, since verify rejects them, just a lower acceptance
        rate).  Replays in chunk-wide pieces; ``lengths`` is the
        committed-lengths snapshot ``_admit`` took under the lock (other
        slots replay zero tokens past their committed length: scratch
        the draft attention never reads)."""
        C = self.chunk
        for ofs in range(0, skip, C):
            n = min(C, skip - ofs)
            buf = np.zeros((self.max_slots, C), np.int32)
            buf[i, :n] = seq[ofs:ofs + n]
            starts = lengths.copy()
            starts[i] = ofs
            nvalid = np.zeros(self.max_slots, np.int32)
            nvalid[i] = n
            self._spec.ingest(buf, starts, nvalid)

    def _release_pages_locked(self, i):
        """Drop slot ``i``'s page references.  Pages the prefix cache also
        holds stay allocated for later hits; the rest return to the free
        list."""
        pages = self._slot_pages[i]
        if pages:
            self._pool.decref(pages)
            self._slot_pages[i] = []
        self._page_tables[i] = NULL_PAGE
        self._pt_dev = None
        self._set_pool_gauges_locked()

    def _check_write_windows_locked(self, starts):
        """Tripwire for the paged no-shared-writes invariant: no active
        slot's write window ``[start, start + reserve)`` may map a page
        with refcount > 1 (the prefix cache's round-down match guarantees
        it), so a violation is a refcount bug: fail the tick rather than
        serve KV another request can see corrupted."""
        P = self._page_size
        for i, slot in enumerate(self._slots):
            if slot.req is None:
                continue
            lo = int(starts[i]) // P
            hi = min((int(starts[i]) + self._reserve - 1) // P,
                     self._pages_per_slot - 1)
            for k in range(lo, hi + 1):
                pg = int(self._page_tables[i, k])
                if pg != NULL_PAGE and self._pool.refcount(pg) > 1:
                    raise RuntimeError(
                        f"paged KV invariant violated: slot {i} write "
                        f"window [{int(starts[i])}, "
                        f"{int(starts[i]) + self._reserve}) maps shared "
                        f"page {pg} (refcount {self._pool.refcount(pg)})")

    # ----------------------------------------------------------- staging
    def _stage(self):
        """(tokens, starts, nvalid, consumed, finishing) for a chunk tick.
        ``consumed[i]``: tokens written for slot i (its length advance);
        ``finishing[i]``: the tick's sample for slot i is a real next
        token."""
        B, C = self.max_slots, self.chunk
        tokens = np.zeros((B, C), np.int32)
        starts = self._lengths.copy()
        nvalid = np.ones(B, np.int32)
        consumed = np.zeros(B, np.int32)
        finishing = [False] * B
        for i, slot in enumerate(self._slots):
            if slot.req is None:
                continue
            if slot.off < len(slot.seq):
                w = min(C, len(slot.seq) - slot.off)
                tokens[i, :w] = slot.seq[slot.off:slot.off + w]
                nvalid[i] = w
                consumed[i] = w
                finishing[i] = slot.off + w >= len(slot.seq)
            else:
                tokens[i, 0] = slot.last
                consumed[i] = 1
                finishing[i] = True
        return tokens, starts, nvalid, consumed, finishing

    def _sampling_vectors(self):
        """Per-slot (skey, temperature, top_k, top_p): the engine defaults,
        overridden by each slot's request.  ``skey`` is False when no
        active request overrides anything (the tick then samples with the
        engine's scalar config), else ``(top_k_live, top_p_live)``.
        Cached until slot membership changes."""
        if self._sampling_cache is not None:
            return self._sampling_cache
        B = self.max_slots
        temps = np.full(B, self.temperature, np.float32)
        topks = np.full(B, 0 if self.top_k is None else int(self.top_k),
                        np.int32)
        topps = np.full(B, 1.0 if self.top_p is None else float(self.top_p),
                        np.float32)
        vec = False
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None:
                continue
            if req.temperature is not None:
                temps[i] = req.temperature
            if req.top_k is not None:
                topks[i] = req.top_k
            if req.top_p is not None:
                topps[i] = req.top_p
            vec = vec or (req.temperature is not None
                          or req.top_k is not None
                          or req.top_p is not None)
        skey = (bool((topks != 0).any()),
                bool((topps != 1.0).any())) if vec else False
        self._sampling_cache = (skey, temps, topks, topps)
        self._sampling_dev = None
        return self._sampling_cache

    # ------------------------------------------------------------- ticks
    def _sample(self, logits, sampling):
        skey = sampling[0]
        if skey is False:
            return self.model._sample(logits, self.temperature, self.top_k,
                                      self._gen, top_p=self.top_p)
        if self._sampling_dev is None:
            self._sampling_dev = tuple(torch.tensor(v, device=self._device)
                                       for v in sampling[1:4])
        temps, topks, topps = self._sampling_dev
        tk_on, tp_on = skey
        return self.model._sample(logits, temps, topks if tk_on else None,
                                  self._gen, top_p=topps if tp_on else None)

    def _page_table_dev(self):
        """The page table on the device (paged mode), restaged only after
        admission or release changed it; None in dense mode."""
        if not self._paged:
            return None
        if self._pt_dev is None:
            self._pt_dev = torch.tensor(self._page_tables,
                                        device=self._device)
        return self._pt_dev

    @torch.inference_mode()
    def _run_tick(self, tokens, starts, nvalid, sampling):
        """One forward over every slot (width 1 when nothing prefills,
        else ``chunk``); samples each slot at its last valid position."""
        dev = self._device
        width = 1 if int(nvalid.max()) <= 1 else self.chunk
        hidden, _ = self.model.gpt(
            torch.tensor(tokens[:, :width], device=dev),
            caches=self._caches,
            cache_pos=torch.tensor(starts, device=dev),
            page_table=self._page_table_dev())
        rows = torch.arange(self.max_slots, device=dev)
        last = hidden[rows, torch.tensor(nvalid - 1, device=dev).long()]
        logits = last @ self.model.gpt.wte.weight.T
        # the tick's one designed device->host fetch
        return device_get(self._sample(logits, sampling)[:, 0])

    @torch.inference_mode()
    def _run_tick_spec(self, tokens, starts, sampling):
        """The VERIFY tick: one forward of width ``spec_k + 1`` over every
        slot (the pending token and the drafts, through the dense or the
        paged cache).  Position 0 samples per slot (greedy slots: argmax,
        the committed bonus token); positions 1..K are the greedy
        references the host's acceptance compares the drafts against.
        Rejected tails need no cache rollback: the next forward rewrites
        ``[length, length + K]`` before any query can attend those rows
        (kpos <= qpos masking).  Returns the (B, K+1) tokens."""
        dev = self._device
        B, K = self.max_slots, self.spec_k
        hidden, _ = self.model.gpt(
            torch.tensor(tokens, device=dev), caches=self._caches,
            cache_pos=torch.tensor(starts, device=dev),
            page_table=self._page_table_dev())
        logits = hidden @ self.model.gpt.wte.weight.T     # (B, K+1, V)
        first = self._sample(logits[:, 0], sampling)
        ref = self.model._sample(logits[:, 1:].reshape(B * K, -1), 0.0,
                                 None).reshape(B, K)
        return device_get(torch.cat([first, ref], 1).to(torch.int32))

    @torch.inference_mode()
    def _run_tick_multi(self, last_toks, starts, sampling):
        """``decode_window`` width-1 steps with the sampled token fed back
        on the device; one fetch of the (B, window) tokens at the end."""
        dev = self._device
        cur = torch.tensor(last_toks, device=dev)
        starts_d = torch.tensor(starts, device=dev)
        pt = self._page_table_dev()
        wte = self.model.gpt.wte.weight
        out = []
        for t in range(self._decode_window):
            hidden, _ = self.model.gpt(cur[:, None], caches=self._caches,
                                       cache_pos=starts_d + t,
                                       page_table=pt)
            cur = self._sample(hidden[:, 0] @ wte.T,
                               sampling)[:, 0].to(torch.int32)
            out.append(cur)
        return device_get(torch.stack(out, 1))

    # ------------------------------------------------------------ commit
    def _finish(self, i, req):
        req.done = True
        req.t_finish = now = time.perf_counter()
        self._slots[i].req = None
        self._sampling_cache = None  # membership changed: restage
        self._lengths[i] = 0
        if self._paged:
            self._release_pages_locked(i)
        self._h_e2e.observe(now - req.t_submit)
        self._c["completed_tokens"].inc(len(req.tokens))
        if req.t_first is not None and len(req.tokens) > 1:
            self._h_tpot.observe((now - req.t_first)
                                 / (len(req.tokens) - 1))
        req._span_life.end(slot=i, tokens=len(req.tokens))
        self._flight.record(
            "req", phase="finish", rid=req.rid, engine=self._engine_id,
            slot=i, tokens=len(req.tokens),
            e2e_s=round(now - req.t_submit, 6))
        req._event.set()

    def _commit_token(self, i, tok):
        """Record slot i's sampled token; True if the request completed."""
        slot = self._slots[i]
        req = slot.req
        if not req.tokens:
            req.t_first = time.perf_counter()
            self._h_ttft.observe(req.t_first - req.t_submit)
        req.tokens.append(tok)
        slot.last = tok
        self._c["tokens"].inc()
        if (len(req.tokens) >= req.max_new_tokens
                or (self.eos_token_id is not None
                    and tok == self.eos_token_id)):
            self._finish(i, req)
            return True
        return False

    def step(self) -> bool:
        """One engine tick: stage under the lock, run the device work,
        commit under the lock.  Returns False when there was nothing to
        do.  An escaping exception writes the flight-recorder ring to
        disk first (``observability/flight.py``)."""
        try:
            return self._step_inner()
        except BaseException as e:
            _flight.crash_dump(f"serving.step[{self._engine_id}]", e)
            raise

    def _after_tick(self, flavor, t0n, t1n, committed, **extra):
        """Per-tick bookkeeping: the liveness beacon, the flight
        recorder's tick summary and, while tracing is on, the tick
        span."""
        _tr.heartbeat(f"serving.{self._engine_id}")
        self._flight.record(
            "tick", engine=self._engine_id, flavor=flavor,
            tickno=self._tickno, dur_us=(t1n - t0n) // 1000,
            committed=committed, **extra)
        if _tr.tracing_enabled():
            _tr.add_span(f"serving.tick.{flavor}", t0n, t1n,
                         engine=self._engine_id, tickno=self._tickno,
                         committed=committed, **extra)

    def _step_inner(self) -> bool:
        # fault-injection drill points (observability/faults.py): the
        # global one and this replica's
        _faults.point("serving.step")
        _faults.point(self._tick_fault_point)
        with self._lock:
            replays = self._admit()
            self._set_queue_gauges_locked()
            occ = sum(s.req is not None for s in self._slots)
            self._g_occupancy.set(occ)
            if not occ:
                return False
            sampling = self._sampling_vectors()
            active = np.asarray([s.req is not None for s in self._slots])
            if all(s.req is None or s.off >= len(s.seq)
                   for s in self._slots):
                last_toks = np.asarray([s.last for s in self._slots],
                                       np.int32)
                starts = self._lengths.copy()
                # speculate only when some active slot is greedy: an
                # all-sampling tick would pay the K+1-wide verify for one
                # token a slot where the multi window commits M
                mode = ("spec" if self._spec is not None
                        and bool((active & (sampling[1] == 0.0)).any())
                        else "multi")
            else:
                mode = "chunk"
                tokens, starts, nvalid, consumed, finishing = self._stage()
            if self._paged:
                self._check_write_windows_locked(starts)

        for i, skip, lengths, seq in replays:
            # deferred from _admit: the drafter's ingest runs outside the
            # engine lock, before this tick's forward
            self._replay_skipped_to_drafter(i, skip, lengths, seq)

        if mode == "spec":
            drafts, ndraft = self._spec.propose(last_toks, starts)
            # only active greedy slots draft; sampled slots advance one
            # token a tick with exact sampling
            ndraft = np.where(active & (sampling[1] == 0.0), ndraft,
                              0).astype(np.int32)
            if not ndraft.any():
                # nothing proposed: the verify would commit one token a
                # slot, and the multi window is strictly better
                mode = "multi"
        if mode == "spec":
            self._spec_tick(last_toks, starts, sampling, drafts, ndraft)
        elif mode == "multi":
            self._multi_tick(last_toks, starts, sampling, active)
        else:
            self._chunk_tick(tokens, starts, nvalid, consumed, finishing,
                             sampling)
        return True

    def _spec_tick(self, last_toks, starts, sampling, drafts, ndraft):
        toks = np.concatenate([last_toks[:, None], drafts], axis=1)
        t0n = time.perf_counter_ns()
        out = self._run_tick_spec(toks, starts, sampling)
        t1n = time.perf_counter_ns()
        self._h_tick["spec"].observe((t1n - t0n) / 1e9)
        acc = accept_lengths(drafts, ndraft, out)
        with self._lock:
            self._tickno += 1
            self._c["ticks"].inc()
            self._c["spec_ticks"].inc()
            tron = _tr.tracing_enabled()
            tick_drafted = tick_accepted = tick_committed = 0
            nvalid = np.zeros(self.max_slots, np.int32)
            for i, slot in enumerate(self._slots):
                if slot.req is None:
                    continue
                req = slot.req   # _commit_token may free the slot
                rem = req.max_new_tokens - len(req.tokens)
                adv = int(acc[i]) + 1
                nvalid[i] = adv
                self._lengths[i] += adv
                committed = 0
                for t in range(adv):
                    committed += 1
                    if self._commit_token(i, int(out[i, t])):
                        break  # freed; later accepted tokens discarded
                # count only what the commit loop could use: the budget
                # bounds the drafts, the commit count (EOS) the accepted
                d = min(int(ndraft[i]), rem)
                a = min(int(acc[i]), committed)
                self._c["spec_drafted"].inc(d)
                self._c["spec_accepted"].inc(a)
                tick_drafted += d
                tick_accepted += a
                tick_committed += committed
                if tron:
                    # each slot's share of the verify tick, on the
                    # request's lane
                    _tr.add_span("serving.spec_verify", t0n, t1n,
                                 _tid=req.rid, rid=req.rid, slot=i,
                                 drafted=d, accepted=a, committed=committed)
            if tick_drafted:
                self._h_accept.observe(tick_accepted / tick_drafted)
            self._after_tick("spec", t0n, t1n, tick_committed,
                             drafted=tick_drafted, accepted=tick_accepted)
        if getattr(self._spec, "ingest_after_verify", True):
            # self-ingesting drafters (ModelDrafter) already wrote these
            # rows into their own cache during propose()
            self._spec.ingest(toks, starts, nvalid)

    def _multi_tick(self, last_toks, starts, sampling, active):
        t0n = time.perf_counter_ns()
        out = self._run_tick_multi(last_toks, starts, sampling)
        t1n = time.perf_counter_ns()
        self._h_tick["decode"].observe((t1n - t0n) / 1e9)
        M = self._decode_window
        with self._lock:
            self._tickno += 1
            self._c["ticks"].inc()
            tron = _tr.tracing_enabled()
            tick_committed = 0
            for i, slot in enumerate(self._slots):
                if slot.req is None:
                    continue
                req = slot.req   # _commit_token may free the slot
                committed = 0
                self._lengths[i] += M
                for t in range(M):
                    committed += 1
                    if self._commit_token(i, int(out[i, t])):
                        break  # freed; later window tokens discarded
                tick_committed += committed
                if tron:
                    _tr.add_span("serving.decode", t0n, t1n, _tid=req.rid,
                                 rid=req.rid, slot=i, window=M,
                                 committed=committed)
            self._after_tick("decode", t0n, t1n, tick_committed, window=M)
        if self._spec is not None:
            # an all-sampling window can precede a greedy request: mirror
            # the M cache rows the window wrote so the drafter stays in
            # sync for later spec ticks
            chunk = np.concatenate([last_toks[:, None], out[:, :M - 1]],
                                   axis=1)
            self._spec.ingest(chunk, starts,
                              np.where(active, M, 0).astype(np.int32))

    def _chunk_tick(self, tokens, starts, nvalid, consumed, finishing,
                    sampling):
        t0n = time.perf_counter_ns()
        nxt = self._run_tick(tokens, starts, nvalid, sampling)
        t1n = time.perf_counter_ns()
        self._h_tick["prefill"].observe((t1n - t0n) / 1e9)
        with self._lock:
            self._tickno += 1
            self._c["ticks"].inc()
            tron = _tr.tracing_enabled()
            tick_committed = 0
            for i, slot in enumerate(self._slots):
                if slot.req is None:
                    continue
                req = slot.req   # _commit_token may free the slot
                was_prefill = slot.off < len(slot.seq)
                if was_prefill:
                    slot.off += int(consumed[i])
                    if (self._prefix is not None
                            and slot.off >= len(slot.seq)):
                        # prefill done: register its FULL pages for later
                        # requests sharing the prefix (before a same-tick
                        # finish releases the slot's refs)
                        self._prefix.insert(
                            slot.seq, self._page_tables[i],
                            len(slot.seq) // self._page_size)
                self._lengths[i] += int(consumed[i])
                if finishing[i]:
                    self._commit_token(i, int(nxt[i]))
                    tick_committed += 1
                if tron:
                    _tr.add_span(
                        "serving.prefill_chunk" if was_prefill
                        else "serving.decode",
                        t0n, t1n, _tid=req.rid, rid=req.rid, slot=i,
                        tokens=int(consumed[i]))
            self._after_tick("prefill", t0n, t1n, tick_committed)
        if self._spec is not None:
            # keep the drafter's mirror in sync with what the chunk tick
            # wrote (prefill chunks and the width-1 decode feeds alike)
            self._spec.ingest(tokens, starts, consumed)

    def run_until_idle(self, max_ticks=100000):
        """Drive the engine until no request is queued or in flight."""
        for _ in range(max_ticks):
            if not self.step():
                with self._lock:
                    if not self._pending:
                        # a drained engine leaves no stale liveness
                        # beacon
                        _tr.remove_beacon(f"serving.{self._engine_id}")
                return
        raise RuntimeError("engine did not drain in max_ticks")

    # --------------------------------------------------------- resources
    @property
    def kv_pages_in_use(self) -> int:
        """Allocated pool pages (0 in dense mode), including pages held only
        by the prefix cache; after :meth:`drop_prefix_cache` a drained
        engine reads 0."""
        return self._pool.allocated if self._paged else 0

    def drop_prefix_cache(self) -> int:
        """Release every cached prefix page; returns how many the cache
        held.  Pages a live slot still maps stay allocated until it
        frees."""
        with self._lock:
            if self._prefix is None:
                return 0
            n = self._prefix.drop()
            self._set_pool_gauges_locked()
            return n

    def shutdown(self):
        """Refuse further submits and free the KV caches.  Raises if a
        request is still queued or in flight (drive it with
        :meth:`run_until_idle` first).  Drops this engine's labelled
        series from the process-wide registry and its liveness beacon;
        ``stats`` holds its own counter handles and stays readable."""
        with self._lock:
            if self._pending or any(s.req is not None for s in self._slots):
                raise RuntimeError("requests still in flight: "
                                   "run_until_idle() before shutdown()")
            self._closed = True
            self._caches = None
            self._registry.drop_labels(engine=self._engine_id)
            _tr.remove_beacon(f"serving.{self._engine_id}")
