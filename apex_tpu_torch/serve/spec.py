"""Speculative decoding for the serve engine, as ``apex_tpu/serve/spec.py``:
a draft model proposes ``k`` tokens a slot, the target scores all of them
in one ``(S, k + 1)`` forward, and each slot keeps the prefix of the
proposals that the target's own draws confirm, plus the target's draw at
the first rejection.  Every accepted token saves one decode step of the
target.

**Exactness.**  Each slot's generator advances exactly one draw per
emitted token (:mod:`apex_tpu_torch.serve.sampling`), so the verifier
knows every draw the plain engine would make: row ``i`` of the verified
block is sampled with the slot's generator after ``n + i`` draws, through
the same :func:`~apex_tpu_torch.serve.sampling.sample_tokens` on one
``(S, V)`` row at a time.  The verifier draws the ``k + 1`` rows in turn,
keeping the generators' states after each draw, and leaves each active
slot's generator at the state after its last EMITTED draw.  A proposal is
accepted when it equals the target's draw at its position; at the first
mismatch the target's draw is the emitted token.  So the streams are the
plain engine's, token for token: greedy streams equal solo
:func:`~apex_tpu_torch.models.generate.generate` and sampled streams equal
the plain engine's.  A poor draft costs acceptance, never correctness.
The draft samples from clones of the slots' generators, so it never moves
a slot's chain.

**KV rollback without copies.**  The verifier writes the target's KV for
all ``k + 1`` fed tokens at positions ``L .. L + k`` through the paged
pools; when ``j <= k`` proposals are accepted the slot's length rewinds
to ``L + j + 1``.  The positions beyond hold rejected tokens' KV, which
the validity mask (cache position <= the row's position) hides and the
next round overwrites.  Writes at positions past the slot's reach
(``max_blocks_per_slot * block_size``) go to the trash block: the
page-table coordinates would otherwise wrap onto live history.

The draft shares the target's page-table geometry: its pools are
``(L_draft, num_blocks, block_size, H_draft, D_draft)`` read through the
SAME page-table rows, so the scheduler's one allocator keeps the books.
They stay dense under an int8 target cache: the draft only guesses, so
its cache precision buys acceptance, not correctness.
:func:`truncated_draft` builds the self-speculative draft: the target's
first ``n`` blocks with its embedding, final norm and head.

Each round runs ``k + 1`` single-token draft steps (the last one only for
its cache write at ``L + k``: a fully accepted round moves the slot to
``L + k + 1``), in the span ``serve/spec_draft``, then the verifier in
``serve/spec_verify``; the draft's prompt prefill runs in
``serve/spec_draft_prefill``.  A continuous profiler
(:func:`apex_tpu_torch.obs.contprof.serve_profiler`) captures whole
rounds under the base engine's contract; its classifier buckets the
verify round and leaves the draft's launches in ``other``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from apex_tpu_torch.models.generate import _check_model_device, _ln
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.obs import spans
from apex_tpu_torch.obs.stepclass import DECODE_RANGES
from apex_tpu_torch.ops import DeviceLike
from apex_tpu_torch.ops.rope import rope_tables
from apex_tpu_torch.serve import paged, sampling
from apex_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    _paged_block,
    chunk_prefill_math,
)
from apex_tpu_torch.serve.paged import TRASH_BLOCK
from apex_tpu_torch.utils.profiling import profile_range

__all__ = ["SpecConfig", "SpecEngine", "truncated_draft"]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """``k`` proposals a round: each round emits between 1 (immediate
    rejection: the plain engine's rate) and ``k + 1`` (all accepted plus
    the target's draw) tokens an active slot."""

    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k={self.k}; speculative decoding needs "
                             f">= 1 draft proposal per round")


def truncated_draft(model: GPTModel, cfg: GPTConfig, num_layers: int):
    """``(draft_model, draft_cfg)``: a :class:`GPTModel` of the target's
    first ``num_layers`` blocks with the target's embedding, final norm
    and head (the self-speculative, layer-skip draft).  The draft shares
    the target's modules, and so their tensors: nothing is copied."""
    if not 1 <= num_layers < cfg.num_layers:
        raise ValueError(
            f"truncated draft needs 1 <= num_layers < {cfg.num_layers}; "
            f"got {num_layers}")
    dcfg = dataclasses.replace(cfg, num_layers=num_layers)
    draft = GPTModel(dcfg, dtype=model.dtype, device="meta")
    draft.tok_emb = model.tok_emb
    for i in range(num_layers):
        setattr(draft, f"block_{i}", getattr(model, f"block_{i}"))
    draft.ln_f = model.ln_f
    draft.lm_head = model.lm_head
    return draft, dcfg


def _clone(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


class SpecEngine(ServeEngine):
    """The serve engine with speculative decoding: the same scheduler,
    paged pools and ``submit`` / ``run``; :meth:`step` runs one draft
    round and one verify round instead of one decode step.

    >>> draft, dcfg = truncated_draft(model, cfg, 1)
    >>> eng = SpecEngine(model, cfg, ServeConfig(), draft, dcfg,
    ...                  SpecConfig(k=4))
    >>> eng.submit(Request("a", prompt_ids, max_new_tokens=16))
    >>> outputs = eng.run()
    """

    def __init__(self, model: GPTModel, cfg: GPTConfig,
                 serve_cfg: ServeConfig, draft_model: GPTModel,
                 draft_cfg: GPTConfig,
                 spec_cfg: Optional[SpecConfig] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 device: DeviceLike = None,
                 tracer: Optional[Any] = None,
                 trace_name: str = "engine"):
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: proposals would not be token ids "
                f"of the target's vocabulary")
        super().__init__(model, cfg, serve_cfg, registry=registry,
                         device=device, tracer=tracer,
                         trace_name=trace_name)
        _check_model_device(draft_model, self.device)
        self.spec = spec_cfg or SpecConfig()
        self.draft = draft_model
        self.dcfg = draft_cfg
        # dense in the draft's dtype, whatever the target's kv_dtype
        self.dkc, self.dvc = paged.make_pools(
            draft_cfg.num_layers, serve_cfg.num_blocks,
            serve_cfg.block_size, draft_cfg.num_heads, draft_cfg.head_dim,
            draft_model.dtype, self.device)
        self._m_rounds = self.metrics.counter(
            "serve_spec_rounds_total",
            "draft+verify speculative rounds run")
        self._m_draft_steps = self.metrics.counter(
            "serve_spec_draft_steps_total",
            "draft single-token steps (k + 1 per round: k proposals + "
            "the cache-fill step for the last proposal's KV)")
        self._m_proposed = self.metrics.counter(
            "serve_spec_proposed_total",
            "draft tokens proposed (k x active slots per round)")
        self._m_accepted = self.metrics.counter(
            "serve_spec_accepted_total",
            "draft tokens the target's own draws confirmed")
        self._m_accept_rate = self.metrics.gauge(
            "serve_spec_acceptance_rate",
            "accepted / proposed over the engine's whole history "
            "(tokens per verify round = 1 + k x this)")

    # -- device work -------------------------------------------------

    def _draft_round(self, tokens, lengths, active, page_table, temp,
                     top_k, top_p) -> torch.Tensor:
        """``k + 1`` single-token paged decode steps of the draft over
        its own pools (the target's page tables and masks), sampling from
        clones of the slots' generators; returns the ``(S, k)``
        proposals (step ``k``'s token is discarded: that step runs for
        its cache write at ``L + k``)."""
        with spans.span("serve/spec_draft", registry=self.metrics):
            c = self.dcfg
            bs = self.scfg.block_size
            m = self.scfg.max_blocks_per_slot * bs
            scale = 1.0 / math.sqrt(c.head_dim)
            gens = [_clone(g) for g in self.generators]
            cache_pos = torch.arange(m, device=self.device)[None, :]
            tok, proposals = tokens, []
            for i in range(self.spec.k + 1):
                pos = lengths + i
                x = self.draft.tok_emb.embedding[tok][:, None]
                cos, sin = rope_tables(pos[:, None], c.head_dim,
                                       c.rope_theta)
                # writes past the slot's reach go to the trash block
                blocks, offs = paged.token_write_coords(
                    pos, page_table, bs, active & (pos < m))
                valid = ((cache_pos <= pos[:, None])
                         & active[:, None])[:, None, :]
                for li, blk in enumerate(self.draft.blocks):
                    x, _ = _paged_block(x, blk, c, self.dkc, self.dvc, li,
                                        cos, sin, blocks, offs, page_table,
                                        valid, scale)
                x = _ln(x[:, -1:], self.draft.ln_f, c.layer_norm_eps)
                logits = x[:, 0] @ self.draft.lm_head.kernel
                nxt = sampling.sample_tokens(logits, gens, temp, top_k,
                                             top_p)
                tok = torch.where(active, nxt, tok)
                proposals.append(tok)
            return torch.stack(proposals[:self.spec.k], dim=1)

    def _verify_round(self, proposals, tokens, lengths, active,
                      page_table, temp, top_k, top_p):
        """The ``(S, k + 1)`` verifier: feed every slot ``[last_tok,
        d_1 .. d_k]`` at positions ``L .. L + k`` through the chunked
        cached path (KV written for every row, causal-against-cache mask
        a row), draw the target's token at every position in turn, accept
        the longest proposal prefix the draws confirm.  Returns host
        ``(candidates (S, k + 1), n_emit (S,))``: a slot emits
        ``candidates[s, :n_emit[s]]``.  Each active slot's generator is
        left after its last emitted draw, an inactive one as it was."""
        with spans.span("serve/spec_verify", registry=self.metrics):
            c = self.cfg
            bs = self.scfg.block_size
            mb = self.scfg.max_blocks_per_slot
            k = self.spec.k
            m = mb * bs
            s_ = tokens.shape[0]
            scale = 1.0 / math.sqrt(c.head_dim)
            dev = self.device
            q_tokens = torch.cat([tokens[:, None], proposals], dim=1)
            positions = lengths[:, None] + torch.arange(k + 1, device=dev)
            with profile_range(DECODE_RANGES["param_read"]):
                x = self.model.tok_emb.embedding[q_tokens]  # (S, k+1, E)
            cos, sin = rope_tables(positions, c.head_dim, c.rope_theta)
            flat_pos = positions.reshape(-1)                 # (S (k+1),)
            rows = torch.arange(s_, device=dev).repeat_interleave(k + 1)
            blocks = page_table[rows, torch.clamp(flat_pos // bs, 0,
                                                  mb - 1)]
            # rows past the reach write to the trash block: the clamped
            # coordinate would wrap onto a live position that this very
            # step's rows attend to (writes land before the gather); such
            # rows are never emitted, the budget retires the slot first
            keep = active.repeat_interleave(k + 1) & (flat_pos < m)
            blocks = torch.where(keep, blocks,
                                 torch.full_like(blocks, TRASH_BLOCK))
            offs = flat_pos % bs
            valid = (torch.arange(m, device=dev)[None, None, :]
                     <= positions[:, :, None]) & active[:, None, None]
            for li, blk in enumerate(self.model.blocks):
                x, _ = _paged_block(x, blk, c, self.kc, self.vc, li, cos,
                                    sin, blocks, offs, page_table, valid,
                                    scale, ks=self.ks, vs=self.vs)
            x = _ln(x, self.model.ln_f, c.layer_norm_eps)
            with profile_range(DECODE_RANGES["param_read"]):
                logits = x @ self.model.lm_head.kernel       # (S, k+1, V)
            gens = self.generators
            before = [g.get_state() for g in gens]
            cand, ladder = [], []
            for i in range(k + 1):
                cand.append(sampling.sample_tokens(logits[:, i], gens, temp,
                                                   top_k, top_p))
                ladder.append([g.get_state() for g in gens])
            cand = torch.stack(cand, dim=1)                  # (S, k+1)
            accepted = (cand[:, :k] == proposals).long().cumprod(1).sum(1)
            n_emit = torch.where(active, accepted + 1,
                                 torch.zeros_like(accepted))
            host = torch.cat([cand, n_emit[:, None]], dim=1).cpu().numpy()
            cand_h, n_h = host[:, :k + 1], host[:, k + 1]
            for s in range(s_):
                gens[s].set_state(ladder[n_h[s] - 1][s] if n_h[s] > 0
                                  else before[s])
            return cand_h, n_h

    # -- host loop ---------------------------------------------------

    def _run_prefill(self, slot: int, req) -> None:
        """Admission: prefill the DRAFT pools over the prompt's chunks,
        then the target's prefill and first-token sample as the base
        engine does (continuations after a preemption or a replica's
        death take the same path, so the draft cache is rebuilt wherever
        the target's is)."""
        cpc = self.scfg.prefill_chunk
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        padded = np.zeros(-(-n // cpc) * cpc, np.int64)
        padded[:n] = prompt
        padded = self._t(padded)
        table_row = self._t(self.sched.page_table[slot]).long()
        for j in range(0, padded.shape[0], cpc):
            with spans.span("serve/spec_draft_prefill",
                            registry=self.metrics):
                chunk_prefill_math(
                    self.dcfg, self.scfg.block_size,
                    self.scfg.max_blocks_per_slot, self.draft, self.dkc,
                    self.dvc, table_row, padded[None, j:j + cpc], j,
                    min(cpc, n - j))
        super()._run_prefill(slot, req)

    @torch.inference_mode()
    def step(self) -> Dict[str, np.ndarray]:
        """One speculative step boundary: admit / evict, one draft round,
        one verify round, then 1 .. k + 1 tokens an active slot through
        the scheduler's per-token bookkeeping (budget and EOS checked a
        token at a time, so a finish inside the block retires as the
        plain engine would)."""
        self._admit_and_evict()
        sched = self.sched
        if not sched.active.any():
            return {}
        # the base step's profiler contract: a captured round (draft +
        # verify) records into serve_profiled_step_seconds
        in_window = self._profiler_begin()
        t0 = time.perf_counter()
        try:
            args = (self._t(sched.last_tok).long(),
                    self._t(sched.lengths).long(), self._t(sched.active),
                    self._t(sched.page_table).long(),
                    self._t(sched.temperature), self._t(sched.top_k),
                    self._t(sched.top_p))
            proposals = self._draft_round(*args)
            cand, n_emit = self._verify_round(proposals, *args)
        except BaseException:
            self._profiler_abort(in_window)
            raise
        self._observe_step_wall(time.perf_counter() - t0, in_window)
        n_act = int(sched.active.sum())
        k = self.spec.k
        self._m_rounds.inc()
        self._m_draft_steps.inc(k + 1)
        self._m_proposed.inc(k * n_act)
        self._m_accepted.inc(int((n_emit - 1)[n_emit > 0].sum()))
        if self._m_proposed.value:
            self._m_accept_rate.set(
                self._m_accepted.value / self._m_proposed.value)
        self.steps += 1
        finished: Dict[str, np.ndarray] = {}
        emitted = 0
        for slot in range(sched.num_slots):
            if not sched.active[slot]:
                continue
            uid = sched.slots[slot].request.uid
            slot_emitted = 0
            retired = None
            for t in range(int(n_emit[slot])):
                emitted += 1
                slot_emitted += 1
                if sched.record_token(slot, int(cand[slot, t])):
                    retired = sched.retire(slot)
                    break
            if self.tracer is not None:
                self.tracer.record("spec_draft", uid, self.trace_name,
                                   step=self.steps, proposed=k)
                self.tracer.record("spec_verify", uid, self.trace_name,
                                   step=self.steps,
                                   accepted=int(n_emit[slot]) - 1,
                                   tokens=slot_emitted)
            if retired is not None:
                finished[retired[0]] = retired[1]
                self._trace_retire(*retired)
        self._m_tokens.inc(emitted)
        self._outputs.update(finished)
        self.metrics.tick()
        return finished

