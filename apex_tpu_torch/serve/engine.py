"""Continuous-batching decode engine over the paged KV cache, as
``apex_tpu/serve/engine.py``.

Each :meth:`ServeEngine.step` admits and evicts at the step boundary,
then runs ONE decode step over every slot:

1. embed every slot's pending token at its own position (per-slot rope
   tables);
2. per layer: layer norm (the CUDA kernel on the card), qkv projection,
   rope, the paged cache write at ``(layer, page_table[slot, t // bs],
   t % bs)`` — inactive slots write to the trash block — and attention of
   the one-token query against the page-table-gathered caches under the
   per-slot validity mask (:func:`apex_tpu_torch.serve.paged.
   paged_attention`, the math of solo decode);
3. per-slot sampling (:mod:`apex_tpu_torch.serve.sampling`); the host
   reads back the ``(S,)`` token ids it streams.

Admission prefills a prompt in ``prefill_chunk``-token chunks through
the slot's page-table row (:func:`chunk_prefill_math`), so a request
joins mid-stream.  The pools are updated in place.  With
``ServeConfig(kv_dtype="int8")`` the pools are int8 beside fp32 scale
pools: every cache write quantizes its tokens
(:func:`apex_tpu_torch.quant.int8.quantize_kv`), the attention folds the
gathered scales in (:func:`apex_tpu_torch.serve.paged.paged_attention`),
and each admission sets the gauge ``serve_kv_quant_error`` (the last
chunk's relative quantization error, read with the first token).  PyTorch runs eagerly,
so there is no compiled step to keep shape-stable; the kernels' launch
counters (:func:`apex_tpu_torch.ops.cuda.launch_counts`) show which
kernels a step ran.

Observability, as the JAX engine's: each decode step runs in the span
``serve/decode_step`` and each prefill chunk in ``serve/prefill_chunk``
(:mod:`apex_tpu_torch.obs.spans`); with ``tracer=`` (a
:class:`~apex_tpu_torch.obs.reqtrace.RequestTracer`) the engine records
each request's ``enqueue``, ``cow_fork``, ``prefix_hit``,
``prefill_chunk``, ``admit``, ``decode_step``, ``preempt`` and ``retire``
under its ``trace_name``.  With ``profiler=`` (a
:class:`~apex_tpu_torch.obs.contprof.ContinuousProfiler`, usually from
:func:`~apex_tpu_torch.obs.contprof.serve_profiler`) each step drives its
``step_begin`` / ``step_end`` hooks; a step inside a capture window
records its wall into ``serve_profiled_step_seconds`` INSTEAD of
``serve_decode_step_seconds``, a window that an admission dispatch
(a prefill chunk, a copy-on-write fork, a fleet's KV install) entered is
discarded, and a failing step aborts the window.  The speculative
engine overrides
:meth:`ServeEngine._run_prefill` and calls
:meth:`ServeEngine._admit_and_evict` and
:meth:`ServeEngine._observe_step_wall` from its own step; the fleet's
prefill worker calls :meth:`ServeEngine._run_prefill` for one request.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.generate import (
    _check_model_device,
    _ln,
    block_tail,
    qkv_rotated,
)
from apex_tpu_torch.models.gpt import GPTBlock, GPTConfig, GPTModel
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.obs import spans
from apex_tpu_torch.obs.stepclass import DECODE_RANGES
from apex_tpu_torch.ops import DeviceLike, resolve_device
from apex_tpu_torch.ops.rope import rope_tables
from apex_tpu_torch.quant.int8 import dequantize_int8, quantize_kv
from apex_tpu_torch.serve import paged, sampling
from apex_tpu_torch.serve.paged import TRASH_BLOCK
from apex_tpu_torch.serve.scheduler import Request, SlotScheduler
from apex_tpu_torch.utils.profiling import profile_range


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Shapes of the serving state.  ``num_blocks`` includes the trash
    block, so ``num_blocks - 1`` are usable; a slot's context is
    ``max_blocks_per_slot * block_size`` tokens.  ``kv_dtype=None``
    stores KV in the model's dtype; ``"int8"`` (or ``torch.int8``) the
    int8 format (:attr:`int8_kv`).  ``prefix_cache`` turns on
    cross-request prefix sharing (the scheduler's docstring has the
    model)."""

    num_slots: int = 4
    block_size: int = 16
    num_blocks: int = 33
    max_blocks_per_slot: int = 8
    prefill_chunk: int = 16
    kv_dtype: Optional[Any] = None
    prefix_cache: bool = True

    @property
    def int8_kv(self) -> bool:
        """Whether ``kv_dtype`` selects the int8 format: int8 pools
        beside fp32 per-position scale pools, quantized on write, the
        scales folded into the attention read."""
        if self.kv_dtype is None:
            return False
        if isinstance(self.kv_dtype, str):
            return self.kv_dtype == "int8"
        return self.kv_dtype == torch.int8


def _quant_error(k: torch.Tensor, v: torch.Tensor, qk, sk, qv, sv
                 ) -> torch.Tensor:
    """The relative int8 quantization error of one write of ``k`` / ``v``
    ``(N, H, D)``: the mean absolute error of both over their mean
    magnitude (a 0-d fp32 tensor on the device)."""
    kf, vf = k.float(), v.float()
    num = (kf - dequantize_int8(qk, sk[:, None, None])).abs().mean() \
        + (vf - dequantize_int8(qv, sv[:, None, None])).abs().mean()
    return num / (kf.abs().mean() + vf.abs().mean() + 1e-12)


def _paged_block(x: torch.Tensor, blk: GPTBlock, cfg: GPTConfig,
                 kc: torch.Tensor, vc: torch.Tensor, layer_i: int, cos,
                 sin, blocks: torch.Tensor, offs: torch.Tensor,
                 table: torch.Tensor, valid: torch.Tensor,
                 scale: float, ks: Optional[torch.Tensor] = None,
                 vs: Optional[torch.Tensor] = None,
                 with_err: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block over ``x (B, Lq, E)`` reading and writing the paged
    pools in place: the math of solo decode's block, with the cache
    write at the flattened ``blocks``/``offs`` ``(B * Lq,)`` and
    ``valid (B, Lq, M)`` the causal-vs-cache mask.  The decode step
    calls it at ``(num_slots, 1)``, a prefill chunk at ``(1, chunk)``.
    ``ks`` / ``vs``: the int8 format's scale pools (None: dense); with
    ``with_err`` (int8 only) the write's quantization error comes back
    beside the output, else None."""
    b, lq = x.shape[0], x.shape[1]
    q, k, v = qkv_rotated(x, blk, cfg, cos, sin)
    n, h, d = b * lq, cfg.num_heads, cfg.head_dim
    k, v = k.reshape(n, h, d), v.reshape(n, h, d)
    kg_scale = vg_scale = err = None
    with profile_range(DECODE_RANGES["kv_write"]):
        if ks is not None:
            qk, sk = quantize_kv(k)
            qv, sv = quantize_kv(v)
            if with_err:
                err = _quant_error(k, v, qk, sk, qv, sv)
            kc[layer_i, blocks, offs] = qk
            vc[layer_i, blocks, offs] = qv
            ks[layer_i, blocks, offs] = sk
            vs[layer_i, blocks, offs] = sv
        else:
            kc[layer_i, blocks, offs] = k.to(kc.dtype)
            vc[layer_i, blocks, offs] = v.to(vc.dtype)
    if ks is not None:
        kg_scale = paged.gather_slot_scales(ks[layer_i], table)
        vg_scale = paged.gather_slot_scales(vs[layer_i], table)
    kg = paged.gather_slot_kv(kc[layer_i], table)
    vg = paged.gather_slot_kv(vc[layer_i], table)
    o = paged.paged_attention(q, kg, vg, valid, scale, k_scale=kg_scale,
                              v_scale=vg_scale)
    return block_tail(x, o, blk, cfg), err


def chunk_prefill_math(cfg: GPTConfig, block_size: int,
                       max_blocks_per_slot: int, model: GPTModel,
                       kc: torch.Tensor, vc: torch.Tensor,
                       table_row: torch.Tensor, chunk_ids: torch.Tensor,
                       start: int, n_valid: int,
                       ks: Optional[torch.Tensor] = None,
                       vs: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``(1, C)`` prompt chunk written through a slot's page-table
    row at positions ``start..``; returns ``(logits (1, V) of the last
    valid token, kv_err)``, ``kv_err`` the layers' mean relative int8
    quantization error of the chunk's writes (0 for a dense cache;
    ``ks`` / ``vs`` the int8 format's scale pools).  Rows past
    ``n_valid`` are padding: their writes go to the trash block and
    their outputs are never read."""
    bs, mb = block_size, max_blocks_per_slot
    lq = chunk_ids.shape[1]
    m = mb * bs
    dev = chunk_ids.device
    x = model.tok_emb.embedding[chunk_ids]                   # (1, C, E)
    pos = start + torch.arange(lq, device=dev)               # (C,)
    cos, sin = rope_tables(pos[None, :], cfg.head_dim, cfg.rope_theta)
    in_chunk = torch.arange(lq, device=dev) < n_valid
    blocks = torch.where(in_chunk,
                         table_row[torch.clamp(pos // bs, 0, mb - 1)],
                         torch.full_like(pos, TRASH_BLOCK))
    offs = pos % bs
    # cache slots <= the row's position: history and in-chunk causality
    valid = (torch.arange(m, device=dev)[None, :] <= pos[:, None])[None]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    esum = torch.zeros((), dtype=torch.float32, device=dev)
    for i, blk in enumerate(model.blocks):
        x, err = _paged_block(x, blk, cfg, kc, vc, i, cos, sin, blocks,
                              offs, table_row[None], valid, scale, ks=ks,
                              vs=vs, with_err=ks is not None)
        if err is not None:
            esum = esum + err
    x_last = _ln(x[:, n_valid - 1:n_valid], model.ln_f, cfg.layer_norm_eps)
    return x_last[:, 0] @ model.lm_head.kernel, esum / cfg.num_layers


class ServeEngine:
    """Continuous-batching serving of a :class:`GPTModel` (as built by
    :func:`apex_tpu_torch.convert.params_from_jax`).

    >>> eng = ServeEngine(model, cfg, ServeConfig())
    >>> eng.submit(Request("a", prompt_ids, max_new_tokens=16))
    >>> outputs = eng.run()          # {"a": generated token ids}

    ``device`` defaults to the card (raising when there is none); the
    model must live there.  ``tracer`` (a :class:`~apex_tpu_torch.obs.
    reqtrace.RequestTracer`, None = off) records each request's events
    under ``trace_name`` (``"prefill"``, ``"replica0"``, ... in a fleet).
    ``profiler`` (None = off): the continuous profiler the module
    docstring describes.
    """

    def __init__(self, model: GPTModel, cfg: GPTConfig,
                 serve_cfg: ServeConfig,
                 registry: Optional[obs_metrics.Registry] = None,
                 device: DeviceLike = None,
                 tracer: Optional[Any] = None,
                 trace_name: str = "engine",
                 profiler: Optional[Any] = None):
        self.device = resolve_device(device)
        _check_model_device(model, self.device)
        self.model = model
        self.cfg = cfg
        self.scfg = serve_cfg
        self.tracer = tracer
        self.trace_name = trace_name
        #: the continuous profiler whose hooks ``step()`` drives
        self.profiler = profiler
        #: admission dispatches into this engine's pools (prefill chunks,
        #: copy-on-write forks, and the fleet's KV installs, which
        #: ``DecodeReplica.admit_shipment`` counts): the profiler's
        #: contamination marker
        self._admission_dispatches = 0
        self.metrics = registry if registry is not None \
            else obs_metrics.DEFAULT
        self._m_step_s = self.metrics.histogram(
            "serve_decode_step_seconds",
            "wall seconds per decode step (launch + token fetch)")
        self._m_profiled_s = None
        self._m_tokens = self.metrics.counter(
            "serve_tokens_total", "tokens generated (active slots x "
            "decode steps + prefill first-tokens)")
        self._m_prefill = self.metrics.counter(
            "serve_prefill_chunks_total", "prefill chunks run")
        self._m_cow = None
        if serve_cfg.prefix_cache:
            self._m_cow = self.metrics.counter(
                "serve_prefix_cow_copies_total",
                "copy-on-write forks of a shared full-prompt-match block")
        self.sched = SlotScheduler(
            num_slots=serve_cfg.num_slots,
            num_blocks=serve_cfg.num_blocks,
            block_size=serve_cfg.block_size,
            max_blocks_per_slot=serve_cfg.max_blocks_per_slot,
            registry=self.metrics,
            prefix_cache=serve_cfg.prefix_cache)
        int8 = serve_cfg.int8_kv
        self.kc, self.vc = paged.make_pools(
            cfg.num_layers, serve_cfg.num_blocks, serve_cfg.block_size,
            cfg.num_heads, cfg.head_dim,
            torch.int8 if int8 else model.dtype, self.device)
        #: the int8 format's scale pools (None for a dense cache)
        self.ks = self.vs = None
        self._m_kv_err = None
        if int8:
            self.ks, self.vs = paged.make_scale_pools(
                cfg.num_layers, serve_cfg.num_blocks, serve_cfg.block_size,
                self.device)
            self._m_kv_err = self.metrics.gauge(
                "serve_kv_quant_error",
                "relative int8 KV quantization error of the latest "
                "admission's last prefill chunk")
        #: one generator per slot; a slot's is replaced at admission
        self.generators: List[torch.Generator] = [
            sampling.make_generator(0) for _ in range(serve_cfg.num_slots)]
        #: decode steps run (speculative rounds in the spec engine): the
        #: tracer's ``step`` index
        self.steps = 0
        self._outputs: Dict[str, np.ndarray] = {}

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @property
    def pools(self) -> Dict[str, torch.Tensor]:
        """The cache pools by name: ``kc``, ``vc``, and the int8 format's
        ``ks``, ``vs``."""
        return {n: t for n, t in (("kc", self.kc), ("vc", self.vc),
                                  ("ks", self.ks), ("vs", self.vs))
                if t is not None}

    # -- device work -------------------------------------------------

    def _decode(self) -> torch.Tensor:
        """One decode step over every slot, in the span
        ``serve/decode_step``; returns the ``(S,)`` next tokens (an
        inactive slot keeps its pending token)."""
        with spans.span("serve/decode_step", registry=self.metrics):
            return self._decode_math()

    def _decode_math(self) -> torch.Tensor:
        c, s = self.cfg, self.sched
        bs = self.scfg.block_size
        tokens = self._t(s.last_tok).long()
        lengths = self._t(s.lengths).long()
        active = self._t(s.active)
        page_table = self._t(s.page_table).long()
        m = self.scfg.max_blocks_per_slot * bs
        with profile_range(DECODE_RANGES["param_read"]):
            x = self.model.tok_emb.embedding[tokens][:, None]   # (S, 1, E)
        cos, sin = rope_tables(lengths[:, None], c.head_dim, c.rope_theta)
        blocks, offs = paged.token_write_coords(lengths, page_table, bs,
                                                active)
        # cache positions <= the fed token's position are attendable;
        # inactive lanes mask out
        valid = (torch.arange(m, device=self.device)[None, :]
                 <= lengths[:, None]) & active[:, None]
        valid = valid[:, None, :]                                # (S, 1, M)
        scale = 1.0 / math.sqrt(c.head_dim)
        for i, blk in enumerate(self.model.blocks):
            x, _ = _paged_block(x, blk, c, self.kc, self.vc, i, cos, sin,
                                blocks, offs, page_table, valid, scale,
                                ks=self.ks, vs=self.vs)
        x = _ln(x[:, -1:], self.model.ln_f, c.layer_norm_eps)
        with profile_range(DECODE_RANGES["param_read"]):
            logits = x[:, 0] @ self.model.lm_head.kernel         # (S, V)
        toks = sampling.sample_tokens(
            logits, self.generators, self._t(s.temperature),
            self._t(s.top_k), self._t(s.top_p))
        return torch.where(active, toks, tokens)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy block ``src`` into block ``dst`` in both pools, and in
        both scale pools under the int8 format."""
        for pool in (self.kc, self.vc, self.ks, self.vs):
            if pool is not None:
                pool[:, dst] = pool[:, src]

    # -- host loop ---------------------------------------------------

    def submit(self, req: Request) -> None:
        self.sched.submit(req)
        if self.tracer is not None:
            self.tracer.record("enqueue", req.uid, self.trace_name,
                               queue_depth=len(self.sched.queue))

    def _run_prefill(self, slot: int, req: Request) -> None:
        """Admission of ``req`` into ``slot`` (blocks and tables already
        set): the prompt's chunks (after any prefix-cache match), then the
        first token's sample, then the slot armed; a request done at its
        first token retires here."""
        c = self.scfg.prefill_chunk
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        # prefix-cache skip: tokens covered by shared blocks are never
        # prefilled.  A full-prompt match forks its last block
        # copy-on-write, then re-runs exactly ONE token (position n - 1:
        # the first-token logits need its forward pass, and its KV
        # rewrite must land in the private fork)
        s = self.sched.slots[slot]
        resume = 0
        if s.cow_src is not None:
            src = s.cow_src
            dst = int(self.sched.page_table[slot,
                                            (n - 1) // self.scfg.block_size])
            self._cow_copy(src, dst)
            self.sched.finish_cow(slot)
            self._m_cow.inc()
            self._admission_dispatches += 1
            resume = n - 1
            if self.tracer is not None:
                self.tracer.record("cow_fork", req.uid, self.trace_name,
                                   src_block=src, dst_block=dst)
        elif s.prefix_len:
            resume = s.prefix_len
        if resume and self.tracer is not None:
            self.tracer.record("prefix_hit", req.uid, self.trace_name,
                               matched_tokens=s.prefix_len, prompt_len=n)
        rest = n - resume
        padded = np.zeros(-(-rest // c) * c, np.int64)
        padded[:rest] = prompt[resume:]
        padded = self._t(padded)
        table_row = self._t(self.sched.page_table[slot]).long()
        logits = kv_err = None
        for j in range(0, padded.shape[0], c):
            n_valid = min(c, rest - j)
            with spans.span("serve/prefill_chunk", registry=self.metrics):
                logits, kv_err = chunk_prefill_math(
                    self.cfg, self.scfg.block_size,
                    self.scfg.max_blocks_per_slot, self.model, self.kc,
                    self.vc, table_row, padded[None, j:j + c], resume + j,
                    n_valid, ks=self.ks, vs=self.vs)
            self._m_prefill.inc()
            self._admission_dispatches += 1
            if self.tracer is not None:
                self.tracer.record("prefill_chunk", req.uid,
                                   self.trace_name, start=resume + j,
                                   n_valid=n_valid)
        if req.resume_key is not None:
            gen = torch.Generator()
            gen.set_state(torch.as_tensor(req.resume_key, dtype=torch.uint8))
        else:
            gen = sampling.make_generator(req.seed)
        tok = sampling.sample_tokens(
            logits, [gen],
            self._t(np.full(1, req.temperature, np.float32)),
            self._t(np.full(1, req.top_k, np.int64)),
            self._t(np.full(1, req.top_p, np.float32)))
        self.generators[slot] = gen
        if self._m_kv_err is not None:
            # the gauge rides the first token's read-back: one copy
            got = torch.stack([tok[0].double(), kv_err.double()]).cpu()
            first = int(got[0])
            self._m_kv_err.set(float(got[1]))
        else:
            first = int(tok[0])
        self.sched.arm(slot, first, n)
        self._m_tokens.inc(1)          # the prefill's sampled token
        if self.tracer is not None:
            self.tracer.record("admit", req.uid, self.trace_name,
                               slot=slot, first_token=first, prompt_len=n,
                               tokens=1)
        # a 1-token budget (or an immediate EOS) finishes on the prefill
        # sample itself
        if req.max_new_tokens <= 1 or (
                req.eos_id is not None and first == req.eos_id):
            uid, out = self.sched.retire(slot)
            self._outputs[uid] = out
            self._trace_retire(uid, out)

    def _trace_retire(self, uid: str, out: np.ndarray) -> None:
        if self.tracer is not None:
            self.tracer.record("retire", uid, self.trace_name,
                               tokens_out=int(out.shape[0]))

    def _admit_and_evict(self) -> None:
        """The step boundary's admissions and evictions, as the
        scheduler plans them."""
        while True:
            plan = self.sched.plan()
            if plan is None:
                return
            if plan[0] == "evict":
                slot = plan[1]
                uid = self.sched.slots[slot].request.uid
                state = self.generators[slot].get_state().numpy().copy()
                self.sched.preempt(slot, state)
                if self.tracer is not None:
                    self.tracer.record("preempt", uid, self.trace_name,
                                       slot=slot)
            else:
                _, slot, req = plan
                self._run_prefill(slot, req)

    def _profiler_begin(self) -> bool:
        """The profiler's hook before a step dispatch; True = this step is
        captured.  The step's own admissions ran before it; the marker
        catches later admissions landing inside the window."""
        if self.profiler is None:
            return False
        return self.profiler.step_begin(marker=self._admission_dispatches)

    def _profiler_abort(self, in_window: bool) -> None:
        """A step that failed inside a window ends the window unjudged."""
        if in_window:
            self.profiler.abort_window()

    def _observe_step_wall(self, dt: float, in_window: bool = False
                           ) -> None:
        """One step's wall seconds (launches + the token read-back) into
        exactly one of ``serve_decode_step_seconds`` and (a captured
        step) ``serve_profiled_step_seconds``, then the profiler's
        closing hook: the base and speculative steps' one observer."""
        if in_window:
            if self._m_profiled_s is None:
                self._m_profiled_s = self.metrics.histogram(
                    "serve_profiled_step_seconds",
                    "wall seconds of decode steps inside a "
                    "continuous-profiler capture window — EXCLUDED from "
                    "serve_decode_step_seconds so latency gates and SLO "
                    "burn rates never judge a profiled step")
            self._m_profiled_s.observe(dt)
        else:
            self._m_step_s.observe(dt)
        if self.profiler is not None:
            self.profiler.step_end(dt, marker=self._admission_dispatches)

    @torch.inference_mode()
    def step(self) -> Dict[str, np.ndarray]:
        """One step boundary: admit/evict, then one decode step over
        every slot; returns the requests that FINISHED this step
        (``{uid: generated token ids}``)."""
        self._admit_and_evict()
        sched = self.sched
        if not sched.active.any():
            return {}
        n_act = int(sched.active.sum())
        in_window = self._profiler_begin()
        t0 = time.perf_counter()
        try:
            toks = self._decode().cpu().numpy()
        except BaseException:
            self._profiler_abort(in_window)
            raise
        self._observe_step_wall(time.perf_counter() - t0, in_window)
        self._m_tokens.inc(n_act)
        self.steps += 1
        finished: Dict[str, np.ndarray] = {}
        for slot in range(sched.num_slots):
            if not sched.active[slot]:
                continue
            if self.tracer is not None:
                self.tracer.record(
                    "decode_step", sched.slots[slot].request.uid,
                    self.trace_name, step=self.steps,
                    token=int(toks[slot]), batch=n_act, tokens=1)
            if sched.record_token(slot, int(toks[slot])):
                uid, out = sched.retire(slot)
                finished[uid] = out
                self._trace_retire(uid, out)
        self._outputs.update(finished)
        self.metrics.tick()
        return finished

    def run(self, max_steps: int = 100_000) -> Dict[str, np.ndarray]:
        """Drain the queue and every slot; returns ``{uid: generated
        token ids}`` for every request submitted (the prompt is not
        repeated)."""
        steps = 0
        try:
            while not self.sched.idle():
                before = self.sched.n_active() + len(self.sched.queue)
                self.step()
                steps += 1
                if steps > max_steps:
                    raise RuntimeError(
                        f"serve loop exceeded {max_steps} steps with "
                        f"{before} request(s) outstanding")
        finally:
            if self.profiler is not None:
                # a window still open at drain would leak the process's
                # capture into the next loop
                self.profiler.abort_window()
        return dict(self._outputs)
