"""Continuous-batching serving engine: the port of the JAX package's
``inference/serving.py``.

Each tick advances every occupied slot.  While some slot is prefilling,
the CHUNK tick runs one forward of up to ``chunk`` tokens per slot
(prompt chunks and width-1 decode feeds in one batch) and samples each
slot's next token at its last valid position.  When every slot decodes,
the MULTI tick runs ``decode_window`` width-1 steps with the sampled
token fed back on the device, and fetches the window's tokens once.  The
host side is a slot scheduler: admit from the queue into free slots,
stage each slot's next chunk, commit sampled tokens, retire finished
requests.

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

The scheduler's stages, as the reference's: priority classes with aging
and preemption (``submit(priority=)``, ``priority_aging_s``, ``preempt``,
``preempt_limit``), the per-tick prefill budget (``prefill_budget``),
deadlines (``submit(deadline_s=)``), per-token streaming
(``submit(on_token=)``), multi-turn KV sessions (``submit(session=)``,
``session_ttl_s``, ``max_sessions``), page-pool compaction
(:meth:`ServingEngine.defrag`), the background driver (``auto_run``,
:meth:`ServingEngine.drain`, :meth:`ServingEngine.shutdown`) and the
reports (:meth:`ServingEngine.load_report`,
:meth:`ServingEngine.slo_windows`,
:meth:`ServingEngine.introspect_requests`), which ``observability/``'s
``/load`` and ``/debug/requests`` serve.

The engine reports through the port's ``observability/`` as the
reference does: ``serving_*`` counters (the ``stats`` view), latency and
tick histograms, gauges, spans and flight-recorder events.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the MoE tick and a serving artifact of a model other than GPT
(item 11), and the pipeline-parallel tick (item 12).
``inference/predictor.py``'s ``create_predictor`` serves the same
artifact directory, and ``inference/fleet.py`` routes over engines.
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
import weakref
import zlib
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
from ..observability.sanitizers import device_get, make_lock, share_object
from ..utils.convert import check_state, dtype_name, to_stored, to_tensor
from .paged import (NULL_PAGE, PagePool, PrefixCache, pages_for,
                    tokens_admittable)

_ENGINE_IDS = itertools.count()
_REQ_IDS = itertools.count()

# SLO priority classes (submit(priority=)): lower rank schedules first.
# Aging (ServingEngine priority_aging_s) promotes a waiting request one
# rank per interval, so batch work cannot starve under a sustained
# interactive load.
PRIORITY_RANK = {"interactive": 0, "default": 1, "batch": 2}


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


class DeadlineExceededError(RuntimeError):
    """A request went past its ``submit(deadline_s=)`` budget, still
    queued or mid-decode, and was aborted: waiting longer could only
    return an answer the caller has already given up on.  Its generated
    tokens count into ``serving_aborted_tokens_total`` and its lifecycle
    record reads ``where="deadline"`` (also in ``/debug/requests`` under
    ``recent_aborts``)."""


class EngineDraining(RuntimeError):
    """:meth:`ServingEngine.submit` was called on a draining engine:
    :meth:`ServingEngine.drain` stops admission while queued and in-flight
    requests run to completion.  A router reads it as "place elsewhere",
    not as a replica failure."""


class Request:
    """One in-flight generation request.  ``temperature``/``top_k``/
    ``top_p`` override the engine's sampling defaults (None = inherit).
    ``rid`` is the process-wide request id its spans and flight records
    carry; ``t_submit``/``t_first``/``t_finish`` are
    ``time.perf_counter()`` stamps.

    ``lifecycle`` is the request's SLO record, one flat dict stamped at
    each stage (submit, admit, first token, finish or abort) with the
    derived durations (``queue_s``/``ttft_s``/``tpot_s``/``e2e_s``) beside
    the stamps; ``trace_ctx``'s ``fleet_rid`` and ``attempt`` land there
    as ``fleet_rid`` and ``dispatch_attempt``.

    ``on_token`` is the per-token stream: the engine calls it with each
    committed token id, then once with ``None`` at the request's terminal
    (finish, abort or loop failure), on the ticking thread after the
    engine lock is released.  ``session`` is a multi-turn KV session key,
    ``priority`` one of :data:`PRIORITY_RANK`'s classes."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature", "top_k",
                 "top_p", "tokens", "done", "error", "_event", "t_submit",
                 "t_first", "t_finish", "_span_queue", "_span_life",
                 "lifecycle", "_tick_mark", "deadline_s", "on_token",
                 "session", "priority", "_prank", "_preempts", "_t_queued",
                 "trace_ctx")

    def __init__(self, prompt, max_new_tokens, temperature=None, top_k=None,
                 top_p=None, deadline_s=None, on_token=None, session=None,
                 priority=None, trace_ctx=None):
        self.rid = next(_REQ_IDS)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = None if temperature is None else float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.on_token = on_token
        self.session = session
        self.priority = "default" if priority is None else priority
        if self.priority not in PRIORITY_RANK:
            raise ValueError(
                f"priority must be one of {sorted(PRIORITY_RANK)}, "
                f"got {priority!r}")
        self._prank = PRIORITY_RANK[self.priority]
        self._preempts = 0   # times this request was preempted (the cap)
        self.tokens: List[int] = []
        self.done = False
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self.t_submit = time.perf_counter()
        # the last time the request entered the queue (submit, or a
        # preemption's re-queue): what the queue-wait windows measure;
        # deadlines and aging count from t_submit
        self._t_queued = self.t_submit
        self.t_first: Optional[float] = None
        self.t_finish: Optional[float] = None
        # (last commit time, tokens then): the per-tick TPOT sample base
        self._tick_mark: Optional[tuple] = None
        self.lifecycle = {"rid": self.rid,
                          "prompt_len": int(self.prompt.shape[0]),
                          "max_new_tokens": self.max_new_tokens,
                          "t_submit": self.t_submit,
                          "priority": self.priority}
        if self.deadline_s is not None:
            self.lifecycle["deadline_s"] = self.deadline_s
        # the fleet trace context (fleet id, fleet-wide request id,
        # dispatch attempt), stamped into the lifecycle record
        self.trace_ctx = dict(trace_ctx) if trace_ctx else None
        if self.trace_ctx is not None:
            if self.trace_ctx.get("fleet_rid") is not None:
                self.lifecycle["fleet_rid"] = self.trace_ctx["fleet_rid"]
            if self.trace_ctx.get("attempt") is not None:
                self.lifecycle["dispatch_attempt"] = \
                    self.trace_ctx["attempt"]
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


class _LoadDebugSource:
    """Publishes an engine's :meth:`ServingEngine.load_report` through the
    ``/debug/requests`` registry (as ``"<engine>.load"``).  The engine
    holds the strong reference; the registry holds it weakly, and it holds
    the engine weakly (no cycle keeps a dropped engine's KV caches on the
    card until the collector runs)."""

    __slots__ = ("_engine", "__weakref__")

    def __init__(self, engine):
        self._engine = weakref.ref(engine)

    def introspect_requests(self) -> dict:
        return self._engine().load_report()


class _Slot:
    __slots__ = ("req", "off", "last", "seq", "resume")

    def __init__(self):
        self.req: Optional[Request] = None
        self.off = 0      # prefill-source tokens consumed
        self.last = 0     # last sampled token (decode feed)
        # the prefill source: the prompt, or for a request resuming after
        # preemption prompt + committed tokens but the last one (the last
        # committed token is the decode feed)
        self.seq = None
        # resume: the final prefill chunk's sample is not committed (it
        # would re-predict a committed token); decode restarts from last
        self.resume = False


class _Session:
    """One retained multi-turn KV session (``submit(session=)``).

    ``tokens`` is the conversation so far (prompt + generated), ``pages``
    its page chain (paged mode; the session holds the refs a slot drops at
    release) and ``kv_len`` the rows of that chain holding the KV of
    ``tokens[:kv_len]``: a returning turn whose prompt extends the
    conversation resumes from that tail.  ``digests`` are the crc32 chain
    digests of the full retained pages, published through ``/load``.
    While a resumed turn is in flight (``busy``) its refs live on its slot
    and only its owner's finish installs the next state."""

    __slots__ = ("sid", "tokens", "pages", "kv_len", "digests",
                 "last_used", "busy", "owner")

    def __init__(self, sid):
        self.sid = sid
        self.tokens = np.zeros(0, np.int32)
        self.pages: List[int] = []
        self.kv_len = 0
        self.digests: List[int] = []
        self.last_used = time.perf_counter()
        self.busy = False
        self.owner: Optional[int] = None   # owning request's rid


def _usage_error(msg: str) -> RuntimeError:
    """A misuse of the single-driver contract: ``step`` writes no crash
    dump for it."""
    err = RuntimeError(msg)
    err._pht_usage_error = True
    return err


class ServingEngine:
    """Slot-based continuous batching, driven by a background loop
    (``auto_run=True``, the reference's default: ``submit`` starts it and
    it idles out when nothing is queued or in flight) or synchronously by
    :meth:`step` / :meth:`run_until_idle` (``auto_run=False``).

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
      auto_run: drive the engine from a background thread.
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
      slo_window_s: span of the rolling TTFT/TPOT/e2e/queue-wait windows
        :meth:`load_report` publishes.
      session_ttl_s: idle lifetime of a retained session (None: no TTL
        sweep; sessions live until LRU or admission-pressure eviction,
        :meth:`drain` or :meth:`drop_sessions`).
      max_sessions: LRU cap on retained sessions.
      priority_aging_s: seconds of queue wait that promote a request one
        priority class (None: strict class order).
      prefill_budget: prefill tokens staged per tick across slots, granted
        in priority order (None: unbounded; values below 1 count as 1).
      preempt: let admission pressure preempt a strictly lower-priority
        in-flight stream (its pages released or donated to the prefix or
        session cache, the request re-queued; re-admission replays its
        committed tokens: token-exact for greedy requests).  Off while
        draining.
      preempt_limit: preemptions of one request at most.
    Temperature > 0 sampling draws from the device's default
    ``torch.Generator`` (``core/random.py``).

    The engine reports through ``observability/``, as the reference
    does: ``stats`` is a dict view over its ``serving_*_total`` counters
    in the process-wide registry (labelled ``engine=<engine_id>``),
    beside the TTFT / TPOT / e2e / tick-time histograms, the occupancy,
    queue, page and session gauges, ``serving_weight_bytes``, the
    ``serving.*`` spans (while tracing is on), the flight recorder's tick
    and request events, and the ``/load`` and ``/debug/requests`` reports.
    """

    # radix-cache chain digests the /load report's prefix_digest block
    # carries at most
    PREFIX_DIGEST_LIMIT = 64

    def __init__(self, model, max_slots=8, max_len=512, chunk=16,
                 temperature=0.0, top_k=None, eos_token_id=None,
                 auto_run=True, decode_window=8, top_p=None, spec_k=0,
                 drafter="ngram", cache_mode="dense", page_size=16,
                 num_pages=None, prefix_cache=True, slo_window_s=60.0,
                 session_ttl_s=None, max_sessions=64,
                 priority_aging_s=30.0, prefill_budget=None,
                 preempt=True, preempt_limit=2):
        cfg = model.config
        if getattr(cfg, "moe_num_experts", 0) > 0:
            raise NotImplementedError(
                "the engine's MoE tick is not ported yet: ROADMAP Queue 1 "
                "item 11")
        if self._ambient_pp() > 1:
            raise NotImplementedError(
                "the engine's pipeline-parallel tick is not ported yet: "
                "ROADMAP Queue 1 item 12")
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
        self.auto_run = bool(auto_run)
        self._decode_window = max(1, min(int(decode_window), self.chunk))
        self.spec_k = int(spec_k)
        self._aging_s = (None if priority_aging_s is None
                         else float(priority_aging_s))
        # >= 1 so the best prefilling slot always makes progress
        self._prefill_budget = (None if prefill_budget is None
                                else max(1, int(prefill_budget)))
        self._preempt = bool(preempt)
        self._preempt_limit = max(0, int(preempt_limit))
        # headroom past the last committed row for the widest in-flight
        # write (a prefill chunk, or the spec_k+1 wide verify block);
        # without it a tail write would land on committed rows
        self._reserve = max(self.chunk, self.spec_k + 1)
        self._device = model.device
        self._gen = default_generator(self._device)

        self._lock = make_lock("serving.engine")
        self._pending = collections.deque()
        self._slots = [_Slot() for _ in range(self.max_slots)]
        self._lengths = np.zeros(self.max_slots, np.int32)
        self._closed = False
        self._tickno = 0
        # drain(): submit refuses, queued + in-flight requests finish
        self._draining = False
        # the loop's crash, which a drain in progress must report
        self._crashed = None
        self._running = False
        self._loop_thread = None
        # (req, token | None) pairs appended under the lock by the commit
        # and abort paths, delivered by _flush_streams on the ticking
        # thread after the lock is released
        self._stream_emit = []
        # where recently aborted requests died, for /debug/requests
        self._recent_aborts = collections.deque(maxlen=32)
        # queued requests with a deadline: the expiry sweep runs only
        # while some are
        self._deadline_queued = 0
        # device copies of per-tick constants, restaged only when slot
        # membership (sampling) or the page tables change
        self._sampling_cache = None
        self._sampling_dev = None
        self._pt_dev = None
        self._slo_window_s = float(slo_window_s)
        # weight-only quantized serving, for the /load modes block
        self._quantized = any(type(m).__name__ == "WeightOnlyLinear"
                              for m in model.modules())
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
        # multi-turn sessions: sid -> _Session (dense mode keeps the
        # conversation only, paged mode also its page chain)
        self._sessions = {}
        self._session_ttl_s = (None if session_ttl_s is None
                               else float(session_ttl_s))
        self._max_sessions = int(max_sessions)
        # set while a compaction's device copy runs: admission must not
        # hand out pages the move plan treats as free
        self._defrag_busy = False
        self._defrag_fn = None
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
            self._defrag_fn = self._build_defrag_fn()
            shape = (self._pool.num_pages, self._page_size, heads, head_dim)
        else:
            shape = (self.max_slots, self.max_len, heads, head_dim)
        self._caches = [(w.new_zeros(shape), w.new_zeros(shape))
                        for _ in range(cfg.num_layers)]
        # shared between the callers' threads and the ticking one, for the race
        # sanitizer (no cost while it is off).  atomic: _tickno is bumped
        # under the lock by its only writer, the ticking thread; _caches,
        # _sampling_dev and _pt_dev are that thread's device staging,
        # touched lock-free on the tick path and invalidated under the
        # lock by admission and release (the single-driver guard
        # serialises every driver, and a handoff between drivers goes
        # through _lock/_running)
        share_object(self, f"serving.engine[{self._engine_id}]",
                     atomic=("_tickno", "_caches", "_sampling_dev",
                             "_pt_dev"))

    @staticmethod
    def _ambient_pp() -> int:
        """The pipeline degree of the ambient mesh (``parallel.set_mesh``),
        which the reference serves with its interleaved-wave tick."""
        from ..parallel.api import _mesh_shape, get_mesh
        return _mesh_shape(get_mesh()).get("pp", 1)

    # ------------------------------------------------------------ metrics
    def _init_metrics(self):
        """Register this engine's series, as the reference engine does:
        one ``engine`` label per instance keeps concurrently-live engines
        from mixing series; ``self.stats`` is the dict-shaped view.  The
        engine registers itself as a ``/load`` and ``/debug/requests``
        source (held weakly) and keeps rolling SLO windows, overall and by
        priority class."""
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
        _tr.register_introspection_source(self._engine_id, self)
        # rolling SLO windows (per-engine working state, not registry
        # families): queue_wait at admit, ttft at the first token, tpot
        # per decode tick, e2e at finish; ttft and queue wait by class too
        self._slo = {k: _obs.SlidingWindowHistogram(
            window_s=self._slo_window_s)
            for k in ("ttft", "tpot", "e2e", "queue_wait")}
        self._slo_cls = {c: {k: _obs.SlidingWindowHistogram(
            window_s=self._slo_window_s) for k in ("ttft", "queue_wait")}
            for c in PRIORITY_RANK}
        _tr.register_load_source(self._engine_id, self)
        self._load_debug = _LoadDebugSource(self)
        _tr.register_introspection_source(f"{self._engine_id}.load",
                                          self._load_debug)

    @property
    def engine_id(self) -> str:
        """Stable per-process replica name (``e<N>``): the label on this
        engine's metric series, its ``/load`` and ``/debug/requests``
        registrations, its liveness beacon (``serving.<id>``) and its
        per-replica fault point (``serving.tick[<id>]``)."""
        return self._engine_id

    @property
    def draining(self) -> bool:
        return self._draining

    def _set_pool_gauges_locked(self):
        self._g_pages_used.set(self._pool.allocated)
        self._g_pages_free.set(self._pool.free)

    def _set_queue_gauges_locked(self):
        self._g_queue.set(len(self._pending))
        counts = dict.fromkeys(PRIORITY_RANK, 0)
        for r in self._pending:
            counts[r.priority] += 1
        for c, g in self._g_class_queue.items():
            g.set(counts[c])

    # ------------------------------------------------------------ intake
    def submit(self, prompt, max_new_tokens=32, temperature=None,
               top_k=None, top_p=None, deadline_s=None, on_token=None,
               session=None, priority=None, trace_ctx=None) -> Request:
        """Queue a request; the engine serves it on later ticks (an
        ``auto_run`` engine starts its loop here).

        ``deadline_s`` bounds the request's whole wall time from submit:
        past it, queued or decoding, the request is aborted with
        :class:`DeadlineExceededError` (``req.error``; ``result()``
        raises).  ``on_token`` streams committed tokens (see
        :class:`Request`).  ``session`` (any hashable key) makes this turn
        part of a multi-turn session: at finish the conversation (and in
        paged mode its page chain) is retained under the key, and a later
        turn whose prompt extends it resumes from the retained rows.
        ``priority`` (``"interactive"``, ``"default"``, ``"batch"``) is
        the request's class: best effective class first, FIFO within one,
        and admission pressure may preempt a strictly lower class.
        ``trace_ctx`` (a dict minted by a fleet router: ``fleet``,
        ``fleet_rid``, ``attempt``) lands in the lifecycle record and on
        the request's lifecycle spans.  A draining engine refuses with
        :class:`EngineDraining`."""
        req = Request(prompt, max_new_tokens, temperature=temperature,
                      top_k=top_k, top_p=top_p, deadline_s=deadline_s,
                      on_token=on_token, session=session,
                      priority=priority, trace_ctx=trace_ctx)
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
        # the fleet trace context rides the lifecycle spans only (they
        # carry both ids); the per-tick spans stay as they are
        fleet = ({"fleet_rid": req.trace_ctx["fleet_rid"]}
                 if req.trace_ctx is not None
                 and req.trace_ctx.get("fleet_rid") is not None else {})
        # _tid=rid puts every span of one request on one trace lane
        req._span_life = _tr.start_span(
            "serving.request", _tid=req.rid, rid=req.rid,
            engine=self._engine_id, prompt_len=len(req.prompt),
            max_new=req.max_new_tokens, **fleet)
        req._span_queue = _tr.start_span(
            "serving.request.queued", _tid=req.rid, rid=req.rid,
            engine=self._engine_id, **fleet)
        self._flight.record(
            "req", phase="submit", rid=req.rid, engine=self._engine_id,
            prompt_len=len(req.prompt), max_new=req.max_new_tokens, **fleet)
        with self._lock:
            if self._closed:
                if self._draining:
                    # drained, then shut down: still the router's "place
                    # elsewhere", as the JAX engine answers after drain()
                    raise EngineDraining(
                        f"engine {self._engine_id} is draining and shut "
                        f"down: admission is closed")
                raise RuntimeError("engine is shut down")
            draining = self._draining
            if not draining:
                self._pending.append(req)
                if req.deadline_s is not None:
                    self._deadline_queued += 1
                self._c["requests"].inc()
                self._set_queue_gauges_locked()
                if self.auto_run and not self._running:
                    # a new burst supersedes a past crash: a later drain
                    # judges this backlog
                    self._crashed = None
                    self._running = True
                    t = threading.Thread(target=self._loop, daemon=True,
                                         name=f"serving.{self._engine_id}")
                    self._loop_thread = t
                    t.start()
        if draining:
            req._span_queue.end(error="EngineDraining")
            req._span_life.end(error="EngineDraining")
            self._flight.record(
                "req", phase="reject", rid=req.rid,
                engine=self._engine_id, error="EngineDraining")
            raise EngineDraining(
                f"engine {self._engine_id} is draining: admission is "
                f"closed while queued + inflight requests finish "
                f"(drain(); shutdown() completes removal)")
        return req

    def generate(self, prompt, max_new_tokens=32, timeout=None):
        """Submit one request and wait for it (``timeout`` seconds at
        most: ``TimeoutError`` past it).  Thread-safe on an ``auto_run``
        engine; an engine without the loop is driven here, synchronously."""
        req = self.submit(prompt, max_new_tokens)
        if not self.auto_run:
            self.run_until_idle()
        finished = req.wait(timeout)
        if req.error is not None:
            return req.result()   # raises, from the engine's error
        if not finished:
            raise TimeoutError("generation did not finish in time")
        return req.result()

    # --------------------------------------------------------- admission
    def _eff_rank_locked(self, req, now):
        """Effective class of a waiting request: its rank, promoted one
        class per ``priority_aging_s`` since SUBMIT (a preempted request
        keeps its age).  Any batch request eventually reaches rank 0 and,
        being older, outranks fresh interactive arrivals."""
        r = req._prank
        if r and self._aging_s is not None:
            r -= int((now - req.t_submit) / self._aging_s)
            if r < 0:
                r = 0
        return r

    def _next_pending_idx_locked(self, now):
        """Index of the request admission tries next: the best effective
        class, FIFO within it (an all-default queue is plain FIFO)."""
        best_i, best_k = 0, None
        for i, req in enumerate(self._pending):
            k = (self._eff_rank_locked(req, now), i)
            if best_k is None or k < best_k:
                best_i, best_k = i, k
        return best_i

    def _pick_victim_locked(self, cand, now):
        """Slot to preempt so ``cand`` can admit, or None.  A victim is of
        a strictly lower effective class (a preempted stream can never
        evict its evictor back) and under its preemption cap; among
        victims the lowest class first, then the least work to replay,
        then the highest slot."""
        if not self._preempt or self._draining or not self._preempt_limit:
            return None
        ce = self._eff_rank_locked(cand, now)
        best = None
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None or req._preempts >= self._preempt_limit:
                continue
            ve = self._eff_rank_locked(req, now)
            if ve <= ce:
                continue
            key = (-ve, int(self._lengths[i]), -i)
            if best is None or key < best[0]:
                best = (key, i)
        return None if best is None else best[1]

    def _preempt_slot_locked(self, i, now):
        """Preempt slot ``i``'s stream: keep its committed KV where a
        cache can hold it (the session for a session stream, else the
        prefix cache), release the slot and re-queue the request at the
        front.  Nothing terminal happens: re-admission replays the
        committed tokens and decode continues from the last one."""
        slot = self._slots[i]
        req = slot.req
        if self._paged:
            if req.session is not None:
                # demoted to session-retained: re-admission resumes it
                self._session_install_locked(i, req)
            elif self._prefix is not None:
                # donate the committed rows' full pages keyed by their
                # tokens: re-admission matches them back, and admission
                # pressure can still evict them
                kv_len = min(int(self._lengths[i]),
                             len(req.prompt) + max(0, len(req.tokens) - 1))
                if kv_len >= self._page_size:
                    seq = np.concatenate(
                        [req.prompt, np.asarray(req.tokens, np.int32)])
                    self._prefix.insert(seq[:kv_len], self._page_tables[i],
                                        kv_len // self._page_size)
            self._release_pages_locked(i)
        slot.req = None
        slot.seq = None
        slot.resume = False
        self._sampling_cache = None  # membership changed: restage
        self._lengths[i] = 0
        req._preempts += 1
        req._t_queued = now
        self._pending.appendleft(req)
        if req.deadline_s is not None:
            self._deadline_queued += 1
        self._c["preemptions"].inc()
        req.lifecycle["preemptions"] = req._preempts
        req._span_queue = _tr.start_span(
            "serving.request.queued", _tid=req.rid, rid=req.rid,
            engine=self._engine_id, preempted=True)
        self._flight.record(
            "req", phase="preempt", rid=req.rid, engine=self._engine_id,
            slot=i, tokens=len(req.tokens), preempts=req._preempts)

    def _admit(self):
        """Move pending requests into free slots, best effective class
        first and FIFO within a class.  Paged mode also needs the
        request's page footprint to fit the pool.  When the pick cannot
        admit (no slot, or pages short) admission may preempt a strictly
        lower-priority stream and retry; otherwise it stops, and later
        requests wait behind the pick.

        A re-admitted (preempted) request resumes: its slot prefills
        ``prompt + tokens[:-1]`` with the final chunk's sample discarded,
        and decode restarts from the last committed token.

        Returns the prefix-hit drafter replays ``[(slot, req, skip,
        lengths_snapshot, seq)]`` for the caller to run after releasing
        the lock (the drafter's ingest is device work)."""
        if self._defrag_busy:
            # a compaction's copy is in flight: its destinations are free
            # pages admission must not hand out until the commit
            return []
        self._expire_queued_locked()
        self._sweep_sessions_locked()
        replays = []
        free = [i for i, s in enumerate(self._slots) if s.req is None]
        while self._pending:
            now = time.perf_counter()
            idx = self._next_pending_idx_locked(now)
            req = self._pending[idx]
            if not free:
                v = self._pick_victim_locked(req, now)
                if v is None:
                    break
                self._preempt_slot_locked(v, now)
                free.append(v)
                continue   # re-pick: the victim joined the queue
            i = min(free)
            resume = bool(req.tokens)
            seq = (np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
                if resume else req.prompt)
            skip = 0
            if self._paged:
                skip = self._paged_admit_locked(i, req, seq, resume)
                if skip is None:
                    v = self._pick_victim_locked(req, now)
                    if v is None:
                        break
                    self._preempt_slot_locked(v, now)
                    free.append(v)
                    continue
            free.remove(i)
            del self._pending[idx]
            slot = self._slots[i]
            slot.req = req
            if req.deadline_s is not None:
                self._deadline_queued -= 1
            self._sampling_cache = None  # membership changed: restage
            slot.seq = seq
            slot.resume = resume
            slot.off = skip   # cache hit: those rows are already KV
            slot.last = int(req.tokens[-1]) if resume else 0
            self._lengths[i] = skip
            self._c["prompt_tokens"].inc(len(seq))
            if resume:
                self._c["preempt_replay_tokens"].inc(max(0, len(seq) - skip))
            if skip and self._spec is not None:
                replays.append((i, req, skip, self._lengths.copy(), seq))
            queue_s = now - req._t_queued
            req.lifecycle.update(t_admit=now, queue_s=queue_s, slot=i)
            self._slo["queue_wait"].observe(queue_s)
            self._slo_cls[req.priority]["queue_wait"].observe(queue_s)
            req._span_queue.end(slot=i)
            self._flight.record(
                "req", phase="admit", rid=req.rid, engine=self._engine_id,
                slot=i, prefix_hit=skip, queue_s=round(queue_s, 6))
        return replays

    # --------------------------------------------------------- deadlines
    def _expire_queued_locked(self):
        """Abort queued requests past their ``deadline_s`` (every admit;
        one int check while no queued request carries a deadline)."""
        if not self._deadline_queued:
            return
        now = time.perf_counter()
        keep = collections.deque()
        for req in self._pending:
            wait_s = now - req.t_submit
            if req.deadline_s is None or wait_s <= req.deadline_s:
                keep.append(req)
                continue
            self._deadline_queued -= 1
            req.error = DeadlineExceededError(
                f"request {req.rid} queued {wait_s:.3f}s, past its "
                f"deadline_s={req.deadline_s}; aborted un-admitted")
            self._c["aborted_tokens"].inc(len(req.tokens))
            req.lifecycle.update(
                t_abort=now, aborted=True, tokens=len(req.tokens),
                where="deadline", error="DeadlineExceededError")
            req._span_queue.end(error="DeadlineExceededError")
            req._span_life.end(error="DeadlineExceededError")
            self._flight.record(
                "req", phase="abort", rid=req.rid,
                engine=self._engine_id, where="deadline",
                wait_s=round(wait_s, 6), error="DeadlineExceededError")
            self._record_abort_locked(req, "deadline",
                                      "DeadlineExceededError", now)
            if req.on_token is not None:
                self._stream_emit.append((req, None))
            req._event.set()
        self._pending = keep

    def _expire_slots_locked(self):
        """Abort requests still decoding past their ``deadline_s`` (their
        slots free this tick); the clock is read only when some slot
        carries a deadline."""
        now = None
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None or req.deadline_s is None:
                continue
            if now is None:
                now = time.perf_counter()
            if now - req.t_submit <= req.deadline_s:
                continue
            self._abort_slot_locked(
                i, req, DeadlineExceededError(
                    f"request {req.rid} ran {now - req.t_submit:.3f}s, "
                    f"past its deadline_s={req.deadline_s}; aborted "
                    f"mid-decode after {len(req.tokens)} tokens"),
                "deadline", now)

    def _abort_slot_locked(self, i, req, err, where, now):
        """Terminal abort of an admitted request: free the slot as
        :meth:`_finish` does, count its tokens as aborted work, and stamp
        the abort on the lifecycle record, the flight ring and the
        ``recent_aborts`` ring."""
        req.error = err
        if req.session is not None:
            # keep what decoded: the next turn resumes from it
            self._session_install_locked(i, req)
        self._slots[i].req = None
        self._sampling_cache = None  # membership changed: restage
        self._lengths[i] = 0
        if self._paged:
            self._release_pages_locked(i)
        self._c["aborted_tokens"].inc(len(req.tokens))
        req.lifecycle.update(
            t_abort=now, aborted=True, tokens=len(req.tokens),
            where=where, error=type(err).__name__)
        req._span_life.end(error=type(err).__name__)
        self._flight.record(
            "req", phase="abort", rid=req.rid, engine=self._engine_id,
            slot=i, where=where, tokens=len(req.tokens),
            error=type(err).__name__)
        self._record_abort_locked(req, where, type(err).__name__, now)
        if req.on_token is not None:
            self._stream_emit.append((req, None))
        req._event.set()

    def _record_abort_locked(self, req, where, error, now):
        """One row of the bounded ``recent_aborts`` ring: where an aborted
        request died, for ``/debug/requests``."""
        self._recent_aborts.append(
            {"rid": req.rid, "where": where, "error": error,
             "tokens": len(req.tokens), "t_abort": round(now, 6)})

    # ------------------------------------------------------------- pages
    def _paged_admit_locked(self, i, req, seq, resume):
        """Reserve slot ``i``'s whole page footprint up front (prompt +
        max_new + the write-window reserve, in pages); a retained session
        or cached prefix pages map shared and their tokens skip prefill.
        ``seq`` is the prefill source (the prompt, or ``prompt +
        tokens[:-1]`` when ``resume``).  Returns the skipped token count,
        or None when the pool cannot fit the request yet."""
        P = self._page_size
        total = pages_for(len(req.prompt) + req.max_new_tokens,
                          self._reserve, P)
        if req.session is not None:
            # a returning turn of a retained session resumes from its
            # chain (a busy session falls through to normal admission); a
            # preempt-resume may take back every retained row
            sess = self._sessions.get(req.session)
            if sess is not None and not sess.busy and sess.pages:
                n = min(sess.kv_len, len(seq) - (0 if resume else 1))
                diff = np.nonzero(sess.tokens[:n] != seq[:n])[0]
                common = int(diff[0]) if len(diff) else int(n)
                if common > 0:
                    # None: the pool cannot cover the resume even after
                    # eviction; normal admission could not either
                    return self._session_resume_locked(i, req, sess, total,
                                                       common)
        hit = (self._prefix.match(seq, allow_full=resume)
               if self._prefix is not None else [])
        fresh_n = total - len(hit)
        short = fresh_n - self._pool.free
        if short > 0:
            # evict only when eviction can cover the shortfall (cache-only
            # prefix pages, then idle sessions' own pages): flushing a hot
            # cache for a head that still cannot admit gains nothing
            cache_ev = (self._prefix.cached_only()
                        if self._prefix is not None else 0)
            if cache_ev + self._session_evictable_pages_locked() < short:
                if hit:
                    self._pool.decref(hit)  # hand the matched refs back
                return None
            if cache_ev:
                short -= self._prefix.evict(min(short, cache_ev))
            if short > 0:
                self._evict_sessions_for_locked(short)
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

    def _replay_skipped_to_drafter(self, i, req, skip, lengths, seq):
        """A cache hit skips re-prefilling rows [0, skip), but the
        drafter's mirror only sees what the target tick feeds it: without
        this replay it would propose from a hole in its history (never
        wrong tokens, since verify rejects them, just a lower acceptance
        rate).  ``seq`` is the slot's prefill source (on a preempt-resume
        the prompt and the committed tokens).  Replays in chunk-wide
        pieces; ``lengths`` is the committed-lengths snapshot ``_admit``
        took under the lock (other slots replay zero tokens past their
        committed length: scratch the draft attention never reads)."""
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

    # ---------------------------------------------------------- sessions
    def _session_resume_locked(self, i, req, sess, total, common):
        """Admit slot ``i`` by resuming session ``sess``: the first
        ``common`` conversation tokens' rows are resident in the retained
        chain, so the slot takes those pages over (the session's refs
        move) and prefills only the suffix.  A partial tail page that is
        shared forks copy-on-write (``PagePool.cow``) and its rows are
        re-prefilled, so no write window maps a shared page.  Returns the
        skipped token count, or None when the pool cannot cover the
        resume even after evicting idle sessions and cached prefix pages
        (nothing was changed)."""
        P = self._page_size
        kept_n = -(-common // P)          # pages holding [0, common)
        keep = sess.pages[:kept_n]
        fresh_n = total - kept_n
        tail_shared = (common % P != 0
                       and self._pool.refcount(keep[-1]) > 1)
        short = fresh_n + (1 if tail_shared else 0) - self._pool.free
        if short > 0:
            short -= self._evict_sessions_for_locked(short, exclude=sess.sid)
            if short > 0:
                if (self._prefix is None
                        or self._prefix.cached_only() < short):
                    return None
                self._prefix.evict(short)
        # the allocations below cannot fail: the free pages were counted
        # above under the same lock hold
        extra = sess.pages[kept_n:]
        if extra:
            # rows past the common prefix are a dead branch of the
            # conversation: the transfer takes all of the session's refs
            self._pool.decref(extra)
        pages = list(keep)
        skip = common
        if common % P:
            page, forked = self._pool.cow(pages[-1])
            pages[-1] = page
            if forked:
                # the shared tail forked to a private page: its rows are
                # re-prefilled
                skip = (common // P) * P
        pages += self._pool.alloc(fresh_n)
        sess.busy = True
        sess.owner = req.rid
        sess.pages = []               # the refs live on the slot now
        self._slot_pages[i] = pages
        self._page_tables[i] = NULL_PAGE
        self._page_tables[i, :len(pages)] = pages
        self._pt_dev = None   # table changed: restage on next tick
        self._c["session_resumes"].inc()
        self._c["session_hit_tokens"].inc(skip)
        self._set_pool_gauges_locked()
        self._update_session_gauges_locked()
        self._flight.record(
            "session", phase="resume", rid=req.rid,
            engine=self._engine_id, slot=i, hit_tokens=skip,
            kept_pages=kept_n)
        return skip

    def _session_install_locked(self, i, req):
        """Retain a finishing (or aborting, or preempted) request's state
        as its session, before the slot's lengths are zeroed and its pages
        released (the install takes the refs the release would drop).  A
        session busy under another owner is left alone; otherwise the
        last finisher wins."""
        sid = req.session
        sess = self._sessions.get(sid)
        if sess is not None and sess.busy and sess.owner != req.rid:
            return
        if sess is None:
            if len(self._sessions) >= self._max_sessions:
                self._evict_lru_session_locked()
            sess = self._sessions[sid] = _Session(sid)
        sess.tokens = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        kv_len = 0
        if self._paged:
            # rows holding exact KV: the last generated token is never fed
            # back, and lengths can run past the commits in the multi and
            # spec modes, so rows [0, p + N - 1) are the valid ones
            kv_len = min(int(self._lengths[i]),
                         len(req.prompt) + max(0, len(req.tokens) - 1))
            if sess.pages:
                self._pool.decref(sess.pages)
                sess.pages = []
            n_keep = -(-kv_len // self._page_size)
            pages = self._slot_pages[i]
            sess.pages = pages[:n_keep]
            extra = pages[n_keep:]
            if extra:
                self._pool.decref(extra)   # the write-window slack pages
            self._slot_pages[i] = []       # the refs moved to the session
            P = self._page_size
            crc, digs = 0, []
            for k in range(kv_len // P):
                crc = zlib.crc32(sess.tokens[k * P:(k + 1) * P].tobytes(),
                                 crc)
                digs.append(crc)
            sess.digests = digs
        sess.kv_len = kv_len
        sess.busy = False
        sess.owner = None
        sess.last_used = time.perf_counter()
        self._update_session_gauges_locked()

    def _evict_session_locked(self, sid, donate=True):
        """Evict one idle session.  ``donate`` (TTL, drain) hands its full
        pages to the prefix cache first, so a re-admitted turn replays
        from the cache; without it (admission pressure, drop) the refs are
        dropped outright."""
        sess = self._sessions.pop(sid)
        if sess.pages:
            if donate and self._prefix is not None:
                self._prefix.insert(sess.tokens, sess.pages,
                                    sess.kv_len // self._page_size)
            self._pool.decref(sess.pages)
            self._set_pool_gauges_locked()
        self._c["sessions_evicted"].inc()
        self._flight.record(
            "session", phase="evict", engine=self._engine_id,
            donated=bool(donate and sess.pages is not None))
        self._update_session_gauges_locked()

    def _evict_lru_session_locked(self):
        cands = [s for s in self._sessions.values() if not s.busy]
        if cands:
            self._evict_session_locked(
                min(cands, key=lambda s: s.last_used).sid)

    def _evict_sessions_for_locked(self, need, exclude=None):
        """Evict least recently used idle sessions (dropping, not
        donating) until ``need`` pages came free or none is left; returns
        the pages freed."""
        freed = 0
        while freed < need:
            cands = [s for s in self._sessions.values()
                     if not s.busy and s.sid != exclude]
            if not cands:
                break
            victim = min(cands, key=lambda s: s.last_used)
            before = self._pool.free
            self._evict_session_locked(victim.sid, donate=False)
            freed += self._pool.free - before
        return freed

    def _session_evictable_pages_locked(self):
        """Pages evicting every idle session would free now: those whose
        only reference is a session (disjoint from the prefix cache's
        ``cached_only``)."""
        if not self._paged:
            return 0
        return sum(1 for s in self._sessions.values() if not s.busy
                   for p in s.pages if self._pool.refcount(p) == 1)

    def _sweep_sessions_locked(self):
        """TTL sweep (every admit): evict idle sessions unused past
        ``session_ttl_s``."""
        if self._session_ttl_s is None or not self._sessions:
            return
        now = time.perf_counter()
        for sid in [sid for sid, s in self._sessions.items()
                    if not s.busy
                    and now - s.last_used > self._session_ttl_s]:
            self._evict_session_locked(sid)

    def _update_session_gauges_locked(self):
        self._g_sessions.set(len(self._sessions))
        if self._paged:
            pages = set()
            for s in self._sessions.values():
                pages.update(s.pages)
            self._g_session_pages.set(len(pages))

    def drop_sessions(self) -> int:
        """Evict every idle retained session without donating to the
        prefix cache; returns how many were dropped."""
        with self._lock:
            n = 0
            for sid in list(self._sessions):
                if not self._sessions[sid].busy:
                    self._evict_session_locked(sid, donate=False)
                    n += 1
            return n

    # ------------------------------------------------------------ defrag
    # A long-lived pool fragments: freed pages scatter over the id range
    # while the allocated count stays small.  Compaction moves every
    # allocated page to the low end: plan under the lock (at a quiet
    # point, with _defrag_busy keeping admission out), copy on the device
    # without it, commit under it (apply_moves revalidates each pair, then
    # the prefix cache, the sessions and the page tables remap).
    def defrag(self) -> int:
        """Compact the paged KV pool; returns pages moved (0 in dense
        mode, or when the pool is packed or not quiet: a live slot or a
        queued request).  Raises while the ``auto_run`` loop drives (it
        compacts on idle ticks itself)."""
        if not self._paged:
            return 0
        with self._lock:
            if self._running and \
                    threading.current_thread() is not self._loop_thread:
                raise _usage_error(
                    "engine is being driven by its auto_run loop; defrag() "
                    "from another thread would move pages under a tick; "
                    "the loop compacts on idle ticks itself")
        return self._defrag_impl()

    def _maybe_defrag(self):
        """Idle-tick compaction (driver thread), only when the touched
        id range is over twice the live page count."""
        with self._lock:
            if (self._pool is None or self._defrag_busy
                    or self._pool.highest_allocated()
                    <= 2 * self._pool.allocated):
                return 0
        return self._defrag_impl()

    def _defrag_impl(self) -> int:
        moves = None
        try:
            with self._lock:
                if self._defrag_busy:
                    return 0
                if (self._pending
                        or any(s.req is not None for s in self._slots)):
                    return 0
                moves = self._pool.compaction_plan()
                if not moves:
                    return 0
                self._defrag_busy = True
            self._dispatch_defrag_moves(moves)
            with self._lock:
                applied = self._pool.apply_moves(moves)
                remap = dict(applied)
                if self._prefix is not None:
                    self._prefix.remap_pages(remap)
                for sess in self._sessions.values():
                    sess.pages = [remap.get(p, p) for p in sess.pages]
                self._pt_dev = None   # tables restage from the remap
                self._c["defrag_total"].inc()
                self._c["defrag_pages_moved"].inc(len(applied))
                self._set_pool_gauges_locked()
                self._flight.record(
                    "defrag", phase="commit", engine=self._engine_id,
                    moved=len(applied),
                    high=self._pool.highest_allocated())
                return len(applied)
        finally:
            if moves:
                with self._lock:
                    self._defrag_busy = False

    def _build_defrag_fn(self):
        """The compaction copy: every moving page's K and V rows src ->
        dst, one ``index_select`` + ``index_copy_`` per layer's K and V
        pool (sources and destinations are disjoint by the plan)."""
        @torch.inference_mode()
        def move(caches, srcs, dsts):
            for k, v in caches:
                k.index_copy_(0, dsts, k.index_select(0, srcs))
                v.index_copy_(0, dsts, v.index_select(0, srcs))
        return move

    def _dispatch_defrag_moves(self, moves):
        idx = torch.tensor(moves, dtype=torch.long).T.contiguous()
        idx = idx.to(self._device)
        self._defrag_fn(self._caches, idx[0], idx[1])

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
        token.  A resume slot's final replay chunk stages with
        ``finishing`` False (its sample would re-predict a committed
        token).

        ``prefill_budget`` bounds the prefill tokens staged a tick (decode
        feeds are never deferred): chunks are granted in class order and
        may be narrowed; a slot past the budget stages a scratch row at
        its length with ``consumed`` 0, which the real chunk rewrites
        before any query attends it."""
        B, C = self.max_slots, self.chunk
        tokens = np.zeros((B, C), np.int32)
        starts = self._lengths.copy()
        nvalid = np.ones(B, np.int32)
        consumed = np.zeros(B, np.int32)
        finishing = [False] * B
        prefilling = [i for i, s in enumerate(self._slots)
                      if s.req is not None and s.off < len(s.seq)]
        rem = self._prefill_budget
        if rem is not None:
            prefilling.sort(key=lambda i: (self._slots[i].req._prank, i))
        for i in prefilling:
            slot = self._slots[i]
            w = min(C, len(slot.seq) - slot.off)
            if rem is not None:
                w = min(w, rem)
                rem -= w
            if w <= 0:
                continue   # budget spent: deferred (scratch, no advance)
            tokens[i, :w] = slot.seq[slot.off:slot.off + w]
            nvalid[i] = w
            consumed[i] = w
            finishing[i] = (not slot.resume
                            and slot.off + w >= len(slot.seq))
        for i, slot in enumerate(self._slots):
            if slot.req is None or slot.off < len(slot.seq):
                continue
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
        admission, release or a compaction changed it; None in dense
        mode."""
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
        if req.session is not None:
            # keep the finished turn as its session before the release
            # below drops the slot's refs
            self._session_install_locked(i, req)
        self._slots[i].req = None
        self._sampling_cache = None  # membership changed: restage
        self._lengths[i] = 0
        if self._paged:
            self._release_pages_locked(i)
        req.t_finish = now = time.perf_counter()
        e2e = now - req.t_submit
        self._h_e2e.observe(e2e)
        self._slo["e2e"].observe(e2e)
        self._c["completed_tokens"].inc(len(req.tokens))
        req.lifecycle.update(t_finish=now, e2e_s=e2e,
                             tokens=len(req.tokens), aborted=False)
        if req.t_first is not None and len(req.tokens) > 1:
            tpot = (now - req.t_first) / (len(req.tokens) - 1)
            self._h_tpot.observe(tpot)
            req.lifecycle["tpot_s"] = tpot
        req._span_life.end(slot=i, tokens=len(req.tokens))
        self._flight.record(
            "req", phase="finish", rid=req.rid, engine=self._engine_id,
            slot=i, tokens=len(req.tokens), e2e_s=round(e2e, 6))
        if req.on_token is not None:
            # the end of the stream, after this tick's tokens
            self._stream_emit.append((req, None))
        req._event.set()

    def _tick_progress(self, req, t_ns):
        """Per-tick TPOT sample for one request: the tokens this tick
        committed since the last mark, over the time since it.  The tick
        that produced the first token only plants the mark (its latency
        is TTFT's)."""
        if req.t_first is None:
            return
        t = t_ns / 1e9   # perf_counter_ns and perf_counter share a clock
        n = len(req.tokens)
        mark = req._tick_mark
        if mark is not None:
            t_prev, n_prev = mark
            if n > n_prev and t > t_prev:
                self._slo["tpot"].observe((t - t_prev) / (n - n_prev))
        req._tick_mark = (t, n)

    def _commit_token(self, i, tok):
        """Record slot i's sampled token; True if the request completed."""
        slot = self._slots[i]
        req = slot.req
        if not req.tokens:
            req.t_first = time.perf_counter()
            ttft = req.t_first - req.t_submit
            req.lifecycle.update(t_first_token=req.t_first, ttft_s=ttft)
            self._h_ttft.observe(ttft)
            self._slo["ttft"].observe(ttft)
            self._slo_cls[req.priority]["ttft"].observe(ttft)
        req.tokens.append(tok)
        slot.last = tok
        self._c["tokens"].inc()
        if req.on_token is not None:
            # delivered by _flush_streams after the lock is released
            self._stream_emit.append((req, tok))
        if (len(req.tokens) >= req.max_new_tokens
                or (self.eos_token_id is not None
                    and tok == self.eos_token_id)):
            self._finish(i, req)
            return True
        return False

    # ------------------------------------------------------------ driver
    def step(self) -> bool:
        """One engine tick: stage under the lock, run the device work,
        commit under the lock.  Returns False when there was nothing to
        do.  While the ``auto_run`` loop is live only its thread may tick
        (another driver raises).  An escaping exception writes the
        flight-recorder ring to disk first (``observability/flight.py``),
        unless it is that usage error."""
        try:
            return self._step_impl()
        except BaseException as e:
            if not getattr(e, "_pht_usage_error", False):
                _flight.crash_dump(f"serving.step[{self._engine_id}]", e)
            raise

    def _step_impl(self) -> bool:
        """A tick, then the stream flush (tokens and terminals buffered
        under the lock go to their ``on_token`` hooks here, on the ticking
        thread, lock-free), then on an idle paged engine the compaction
        check."""
        busy = self._step_inner()
        self._flush_streams()
        if not busy and self._paged:
            self._maybe_defrag()
        return busy

    def _flush_streams(self):
        """Deliver buffered ``on_token`` calls (driver thread, no lock
        held).  A hook that raises is dropped with a flight mark: the
        stream's consumer is the broken party, not the other requests."""
        with self._lock:
            if not self._stream_emit:
                return
            buf, self._stream_emit = self._stream_emit, []
        for req, tok in buf:
            try:
                req.on_token(tok)
            except Exception as e:  # noqa: BLE001 — the consumer's bug
                self._flight.record(
                    "stream", phase="hook_error", rid=req.rid,
                    engine=self._engine_id, error=type(e).__name__)

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
            if self._running and \
                    threading.current_thread() is not self._loop_thread:
                raise _usage_error(
                    "engine is being driven by its auto_run loop; "
                    "step()/run_until_idle() from another thread would "
                    "tick beside it; wait for the loop to drain "
                    "(drain() or shutdown()) instead")
            replays = self._admit()
            # the decode half of the deadline budget
            self._expire_slots_locked()
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

        for i, req, skip, lengths, seq in replays:
            # deferred from _admit: the drafter's ingest runs outside the
            # engine lock, before this tick's forward
            self._replay_skipped_to_drafter(i, req, skip, lengths, seq)

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
                self._tick_progress(req, t1n)
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
                self._tick_progress(req, t1n)
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
                        # prefill source consumed: register its FULL
                        # pages for later requests sharing the prefix (or
                        # this stream's re-admission after a preemption),
                        # before a same-tick finish releases the refs
                        self._prefix.insert(
                            slot.seq, self._page_tables[i],
                            len(slot.seq) // self._page_size)
                self._lengths[i] += int(consumed[i])
                if finishing[i]:
                    self._commit_token(i, int(nxt[i]))
                    tick_committed += 1
                    self._tick_progress(req, t1n)
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

    def _loop(self):
        """The ``auto_run`` driver: ticks until nothing is queued or in
        flight.  The thread enters the engine's device (the kernels launch
        on the current device's stream) and inference mode itself: both
        are per thread in PyTorch.  If a tick raises, every queued and
        in-flight request fails with the cause, their pages and the
        retained sessions are freed, the beacon is pinned (going stale is
        the alert) and the flight recorder writes a crash dump."""
        if self._device.type == "cuda" and self._device.index is not None:
            torch.cuda.set_device(self._device)
        with torch.inference_mode():
            while True:
                try:
                    # not step(): the crash dump below comes after the
                    # fail-all marks, so the dump holds them
                    busy = self._step_impl()
                except BaseException as e:  # noqa: BLE001
                    self._fail_all(e)
                    raise
                if not busy:
                    with self._lock:
                        if (not self._pending
                                and all(s.req is None for s in self._slots)):
                            self._running = False
                            # a clean idle exit drops the beacon; the next
                            # burst's first tick adds it again
                            _tr.remove_beacon(f"serving.{self._engine_id}")
                            return

    def _fail_all(self, e):
        """The loop's crash path (see :meth:`_loop`)."""
        with self._lock:
            def fail(req, where):
                req.error = e
                self._c["aborted_tokens"].inc(len(req.tokens))
                now = time.perf_counter()
                req.lifecycle.update(
                    t_abort=now, aborted=True, tokens=len(req.tokens),
                    where=where, error=type(e).__name__)
                self._record_abort_locked(req, where, type(e).__name__, now)
                if req.on_token is not None:
                    # the terminal after any tokens already buffered
                    self._stream_emit.append((req, None))
                req._span_queue.end(error=type(e).__name__)
                req._span_life.end(error=type(e).__name__)
                self._flight.record(
                    "req", phase="fail", rid=req.rid,
                    engine=self._engine_id, where=where,
                    error=type(e).__name__)
                req._event.set()
            for req in list(self._pending):
                fail(req, "pending")
            self._pending.clear()
            self._deadline_queued = 0
            for i, slot in enumerate(self._slots):
                if slot.req is not None:
                    fail(slot.req, "slot")
                    slot.req = None
                    if self._paged:
                        self._release_pages_locked(i)
            # retained sessions die with the engine's run (busy sessions
            # hold no refs: their pages were on the slots)
            for sess in list(self._sessions.values()):
                if self._paged and sess.pages:
                    self._pool.decref(sess.pages)
            self._sessions.clear()
            if self._paged:
                self._set_pool_gauges_locked()
            self._update_session_gauges_locked()
            self._running = False
            self._crashed = e
        # a streaming consumer blocked on its queue learns of the failure
        self._flush_streams()
        _tr.pin_beacon(f"serving.{self._engine_id}")
        if not getattr(e, "_pht_usage_error", False):
            _flight.crash_dump(f"serving.step[{self._engine_id}]", e)

    def run_until_idle(self, max_ticks=100000):
        """Drive the engine until no request is queued or in flight.
        Raises while the ``auto_run`` loop drives (see :meth:`step`)."""
        for _ in range(max_ticks):
            if not self.step():
                with self._lock:
                    if (not self._pending
                            and all(s.req is None for s in self._slots)):
                        # a drained engine leaves no stale liveness
                        # beacon
                        _tr.remove_beacon(f"serving.{self._engine_id}")
                return
        raise RuntimeError("engine did not drain in max_ticks")

    # ----------------------------------------------------------- reports
    def introspect_requests(self) -> dict:
        """The slot table for ``/debug/requests``: one row per slot
        (request id, prompt progress, tokens generated, cache depth,
        class, preemptions, pages) beside the queue depth and the
        ``recent_aborts`` ring; one snapshot under the engine lock."""
        with self._lock:
            slots = []
            for i, slot in enumerate(self._slots):
                req = slot.req
                if req is None:
                    slots.append(None)
                    continue
                row = {
                    "rid": req.rid, "slot": i,
                    "prompt_len": int(len(req.prompt)),
                    "prompt_consumed": int(slot.off),
                    "generated": len(req.tokens),
                    "max_new_tokens": req.max_new_tokens,
                    "cache_len": int(self._lengths[i]),
                    "priority": req.priority,
                    "preempted": req._preempts,
                }
                if self._paged:
                    row["pages"] = len(self._slot_pages[i])
                slots.append(row)
            out = {"engine": self._engine_id, "tickno": self._tickno,
                   "running": self._running,
                   "draining": self._draining,
                   "pending": len(self._pending), "slots": slots,
                   "recent_aborts": list(self._recent_aborts),
                   "sessions": len(self._sessions)}
            if self._paged:
                out["kv_pages_in_use"] = self._pool.allocated
                out["kv_pages_free"] = self._pool.free
                out["prefix_cached_pages"] = (
                    len(self._prefix) if self._prefix is not None else 0)
            return out

    def slo_windows(self) -> dict:
        """The live rolling SLO windows (``{"ttft", "tpot", "e2e",
        "queue_wait"} -> SlidingWindowHistogram``) behind
        :meth:`load_report`'s ``slo`` block, for in-process aggregation
        (``metrics.merged_percentiles``)."""
        return dict(self._slo)

    def load_report(self) -> dict:
        """The load and capacity report the ``/load`` endpoint serves and
        a least-loaded router polls (version 1), one snapshot under the
        engine lock (host state only):

        - ``slots``/``queue``: free capacity, the longest wait since the
          last enqueue, and the same by priority class (``classes``);
        - ``admission``: the largest ``prompt + max_new`` that would admit
          now (page-exact in paged mode through ``tokens_admittable``,
          counting the pages eviction would free), and the pool's pages;
        - ``modes``: cache mode, spec_k, weight-only quantization, MoE, pp;
        - ``slo``: rolling TTFT/TPOT/e2e/queue-wait percentiles over the
          last ``slo_window_s`` seconds, and TTFT/queue wait by class
          (None without traffic);
        - ``goodput``: completed and aborted generated tokens and their
          ratio (None before any token);
        - ``sessions``, ``scheduler`` and, with a prefix cache,
          ``prefix_digest`` (retained sessions' chain digests first, then
          the cache's, ``PREFIX_DIGEST_LIMIT`` at most)."""
        reserve = self._reserve
        with self._lock:
            now = time.perf_counter()
            active = sum(s.req is not None for s in self._slots)
            free_slots = self.max_slots - active
            oldest = max((now - r._t_queued for r in self._pending),
                         default=0.0)
            cls_q = {c: {"depth": 0, "oldest_wait_s": 0.0}
                     for c in PRIORITY_RANK}
            for r in self._pending:
                row = cls_q[r.priority]
                row["depth"] += 1
                w = round(now - r._t_queued, 6)
                if w > row["oldest_wait_s"]:
                    row["oldest_wait_s"] = w
            completed = int(self._c["completed_tokens"].value)
            aborted = int(self._c["aborted_tokens"].value)
            report = {
                "version": 1,
                "engine": self._engine_id,
                "ts": time.time(),
                "running": self._running,
                "draining": self._draining,
                "tickno": self._tickno,
                "slots": {"max": self.max_slots, "active": active,
                          "free": free_slots},
                "queue": {"depth": len(self._pending),
                          "oldest_wait_s": round(oldest, 6),
                          "classes": cls_q},
                "modes": {"cache": self.cache_mode,
                          "spec_k": self.spec_k,
                          "quant": self._quantized,
                          "moe": False,
                          "pp": 1},
                "slo": {"window_s": self._slo_window_s,
                        **{k: h.percentiles()
                           for k, h in self._slo.items()},
                        "classes": {c: {k: h.percentiles()
                                        for k, h in hs.items()}
                                    for c, hs in self._slo_cls.items()}},
                "scheduler": {
                    "preemptions": int(self._c["preemptions"].value),
                    "preempt_replay_tokens": int(
                        self._c["preempt_replay_tokens"].value),
                    "preempt": self._preempt,
                    "preempt_limit": self._preempt_limit,
                    "prefill_budget": self._prefill_budget,
                    "priority_aging_s": self._aging_s},
                "goodput": {
                    "completed_tokens": completed,
                    "aborted_tokens": aborted,
                    "ratio": (completed / (completed + aborted)
                              if completed + aborted else None)},
            }
            admission = {"reserve_tokens": reserve}
            # the per-slot caps every request faces: max_len less the
            # write-window reserve, and the model's position table
            slot_cap = min(self.max_len - reserve,
                           int(self.model.config.max_position_embeddings))
            sess_pages = set()
            for s in self._sessions.values():
                sess_pages.update(s.pages)
            sess_evictable = self._session_evictable_pages_locked()
            report["sessions"] = {
                "count": len(self._sessions),
                "retained_pages": len(sess_pages),
                "evictable_pages": sess_evictable}
            if self._paged:
                # admission evicts cache-only prefix pages and idle
                # sessions' own pages to cover a shortfall, so they count
                evictable = (self._prefix.cached_only()
                             if self._prefix is not None else 0)
                headroom = min(
                    tokens_admittable(
                        self._pool.free + evictable + sess_evictable,
                        reserve, self._page_size),
                    slot_cap)
                admission.update(
                    kv_pages_free=self._pool.free,
                    kv_pages_evictable=evictable,
                    kv_pages_in_use=self._pool.allocated,
                    page_size=self._page_size,
                    # pages alone do not admit when every slot is taken
                    headroom_tokens=headroom if free_slots else 0)
            else:
                admission["headroom_tokens"] = (slot_cap if free_slots
                                                else 0)
            report["admission"] = admission
            if self._prefix is not None:
                digs = []
                seen = set()
                for s in self._sessions.values():
                    for d in s.digests:
                        if d not in seen:
                            seen.add(d)
                            digs.append(d)
                for d in self._prefix.digests(self.PREFIX_DIGEST_LIMIT):
                    if d not in seen:
                        seen.add(d)
                        digs.append(d)
                report["prefix_digest"] = {
                    "algo": "crc32-pages",
                    "page_size": self._page_size,
                    "digests": digs[:self.PREFIX_DIGEST_LIMIT]}
            return report

    # --------------------------------------------------------- resources
    @property
    def kv_pages_in_use(self) -> int:
        """Allocated pool pages (0 in dense mode), including pages held
        only by the prefix cache or by retained sessions; after
        :meth:`drop_prefix_cache` and :meth:`drop_sessions` a drained
        engine reads 0."""
        return self._pool.allocated if self._paged else 0

    @property
    def kv_pages_free(self) -> int:
        return self._pool.free if self._paged else 0

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

    def drain(self, timeout=60.0):
        """Graceful removal: stop admitting (``submit`` raises
        :class:`EngineDraining`), let queued and in-flight requests run to
        completion, donate the retained sessions to the prefix cache and
        drop the liveness beacon; the engine keeps answering its reports
        until :meth:`shutdown`.  An engine whose loop is not running is
        driven here.  Idempotent; ``TimeoutError`` if the backlog outlives
        ``timeout``, ``RuntimeError`` (from the crash) if the loop crashed
        instead of draining."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                running = self._running
                crashed = self._crashed
                idle = (not self._pending
                        and all(s.req is None for s in self._slots))
            if crashed is not None and not running:
                raise RuntimeError(
                    f"engine {self._engine_id} crashed while draining "
                    f"({type(crashed).__name__}): its queued + inflight "
                    f"requests were FAILED, not completed — this is not "
                    f"a clean removal") from crashed
            if idle and not running:
                with self._lock:
                    for sid in list(self._sessions):
                        if not self._sessions[sid].busy:
                            self._evict_session_locked(sid, donate=True)
                _tr.remove_beacon(f"serving.{self._engine_id}")
                return
            if running:
                time.sleep(0.005)   # the auto_run loop is finishing it
            else:
                self.step()         # no loop: drain ticks it
        raise TimeoutError(
            f"engine {self._engine_id} did not drain in {timeout}s")

    def shutdown(self, timeout=60.0):
        """Wait for the background loop to stop (``TimeoutError`` past
        ``timeout``), then refuse further submits and free the KV caches.
        Raises if a request is still queued or in flight on an engine no
        loop drives (drive it with :meth:`run_until_idle` or
        :meth:`drain` first).  Drops this engine's labelled series from
        the process-wide registry, its ``/load`` and ``/debug/requests``
        registrations and its liveness beacon; ``stats`` holds its own
        counter handles and stays readable."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if not self._running:
                    if self._pending or any(s.req is not None
                                            for s in self._slots):
                        raise RuntimeError(
                            "requests still in flight: run_until_idle() "
                            "before shutdown()")
                    self._closed = True
                    self._caches = None
                    self._registry.drop_labels(engine=self._engine_id)
                    _tr.unregister_introspection_source(self._engine_id)
                    _tr.unregister_load_source(self._engine_id)
                    _tr.unregister_introspection_source(
                        f"{self._engine_id}.load")
                    _tr.remove_beacon(f"serving.{self._engine_id}")
                    return
            if time.monotonic() >= deadline:
                raise TimeoutError("engine loop did not drain before "
                                   "timeout")
            time.sleep(0.005)
