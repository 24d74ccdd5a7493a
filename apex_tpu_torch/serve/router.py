"""Disaggregated prefill / decode serving: separate slices behind one
KV-shipping router, as ``apex_tpu/serve/router.py``.

The monolithic engine (:mod:`apex_tpu_torch.serve.engine`) interleaves
prefill chunks and decode steps on one device, so a long prompt's
admission stalls every decode behind it.  Here the two phases run on
different engines:

- the **prefill worker** (:class:`PrefillWorker`) is a
  :class:`~apex_tpu_torch.serve.engine.ServeEngine` on the prefill slice,
  used only for its chunked paged prefill and first-token sample; the
  slot's KV is gathered into a fixed-shape
  :class:`~apex_tpu_torch.serve.transfer.KVShipment` and the slot freed at
  once;
- each **decode replica** (:class:`DecodeReplica`) is an engine on its
  own slice; a shipment installs into its pools and the replica decodes
  as the monolithic engine would;
- the **router** (:class:`DisaggRouter`) admits off the gauges the
  engines export — per-replica queue depth, slot occupancy, block
  utilization, decode p99 — and ships finished prefills to the
  least-loaded eligible replica (``transfer="ship"``), or hands the
  original request to the replica to prefill itself
  (``transfer="recompute"``, the fallback on a miss).  It sends a
  request whose prompt a replica's prefix index covers straight to that
  replica, takes a replica that violates its SLO objectives
  (``RouterConfig.slo``) out of admission, and recovers from a replica's
  death (:meth:`DisaggRouter.kill_replica`) by rebuilding its requests
  from their streamed tokens and prefilling them elsewhere: greedy
  streams stay equal to solo ``generate()``, and sampled requests resume
  their exact generator chain
  (:func:`~apex_tpu_torch.serve.sampling.advance_key`).

Every router metric is a host number recorded at a step boundary.
Replicas on one device share the weights; each keeps its own pools.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.ops import same_device
from apex_tpu_torch.serve import transfer
from apex_tpu_torch.serve.engine import ServeConfig, ServeEngine
from apex_tpu_torch.serve.paged import PoolExhausted
from apex_tpu_torch.serve.sampling import advance_key
from apex_tpu_torch.serve.scheduler import Request, validate_request
from apex_tpu_torch.serve.transfer import (
    FleetSlices,
    KVShipment,
    placement,
    slice_fleet,
)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Fleet shape and policy.  ``transfer``: ``"ship"`` moves prefilled
    blocks device to device, ``"recompute"`` re-prefills on the decode
    replica (the miss fallback, runnable as the whole policy).
    ``admit_block_util``: a replica whose block-utilization gauge is at
    or over it takes no new admission even with a free slot.
    ``incident_path``: where :meth:`DisaggRouter.kill_replica` writes its
    incident record (None: none; the flight recorder notes either way).
    ``slo``: a tuple of :class:`apex_tpu_torch.obs.slo.SLObjective`
    judged per replica over its own registry at every fleet step
    boundary; a replica with a violated objective takes no admission
    until its window recovers (None: ranking only).  ``contprof`` (an
    :class:`apex_tpu_torch.obs.contprof.ContProfConfig`, None = off):
    every decode replica gets its own continuous profiler, capture phases
    staggered across replicas (the capture is process-wide: a colliding
    window is skipped, not queued), and its own
    :class:`~apex_tpu_torch.obs.contprof.DriftSentinel` (band
    ``contprof_band``, confirmation count ``contprof_k``) over the
    replica's registry.  A confirmed drift flips the replica's
    ``serve_profile_drift`` gauge (and the router's
    ``serve_replica{i}_profile_drift``), notes the flight recorder,
    writes a ``profile-drift`` incident to ``incident_path`` and ranks
    the replica LAST in admission (never blocked: a fleet whose every
    replica drifted still serves)."""

    n_decode_replicas: int = 2
    n_prefill_devices: int = 1
    devices_per_replica: int = 1
    transfer: str = "ship"
    admit_block_util: float = 0.97
    incident_path: Optional[str] = None
    slo: Optional[tuple] = None
    contprof: Optional[Any] = None
    contprof_band: float = 0.03
    contprof_k: int = 2

    def __post_init__(self):
        if self.transfer not in ("ship", "recompute"):
            raise ValueError(
                f"transfer={self.transfer!r}; pick 'ship' (KV block "
                f"shipment) or 'recompute' (re-prefill on the decode "
                f"replica)")
        if not 0.0 < self.admit_block_util <= 1.0:
            raise ValueError(
                f"admit_block_util={self.admit_block_util} outside "
                f"(0, 1]")


class PrefillWorker:
    """The prefill slice: a :class:`ServeEngine` that never decodes.
    :meth:`prefill` runs the chunked paged prefill and first-token sample
    of ONE request, gathers the slot's KV through its page table into the
    shipment shape, frees the slot and returns the shipment — or the
    finished output when the request ends at its first token."""

    def __init__(self, model: GPTModel, cfg: GPTConfig,
                 serve_cfg: ServeConfig, devices: Sequence[torch.device],
                 registry: Optional[obs_metrics.Registry] = None,
                 tracer: Optional[Any] = None):
        # one slot and one slot's blocks (+ trash); block_size,
        # max_blocks_per_slot and kv_dtype are the replicas', so a
        # shipment always fits its destination.  No prefix cache: the
        # pool holds one transient slot, and the router sends prefix hits
        # straight to a replica
        self.scfg = dataclasses.replace(
            serve_cfg, num_slots=1,
            num_blocks=serve_cfg.max_blocks_per_slot + 1,
            prefix_cache=False)
        self.devices = tuple(devices)
        self.placement = placement(self.devices)
        self.eng = ServeEngine(model, cfg, self.scfg,
                               registry=registry or obs_metrics.Registry(),
                               device=self.placement, tracer=tracer,
                               trace_name="prefill")
        self._gather = transfer.make_gather(list(self.eng.pools))

    @torch.inference_mode()
    def prefill(self, req: Request):
        """``("done", tokens)`` when the request finished at its first
        sample, else ``("kv", KVShipment)`` with the slot already freed
        (the worker holds nothing between calls)."""
        eng, sched = self.eng, self.eng.sched
        # only the PROMPT's blocks: the generation budget's footprint
        # belongs to the decode slice
        need = -(-len(req.prompt) // sched.block_size)
        blocks = sched.allocator.alloc(need, req)
        sched._install(0, req, blocks)
        eng._run_prefill(0, req)
        if sched.slots[0] is None:
            # finished at the prefill sample (_run_prefill retired it)
            out = eng._outputs.pop(req.uid)
            eng.metrics.tick()
            return ("done", out)
        slot = sched.slots[0]
        first = int(slot.emitted[0])
        plen = int(sched.lengths[0])
        row = eng._t(sched.page_table[0]).long()
        kv = self._gather(eng.pools, row)
        key = eng.generators[0].get_state()
        shp = KVShipment(request=req, kv=kv, first_token=first,
                         prompt_len=plen, key=key,
                         nbytes=transfer.shipment_bytes(kv, key))
        # free, don't retire: the request's life continues elsewhere
        sched.allocator.free(blocks, req)
        sched._clear(0)
        sched._update_gauges()
        eng.metrics.tick()
        return ("kv", shp)


class DecodeReplica:
    """One decode slice: an engine plus the install that accepts
    shipments.  ``alive`` is the router's view: a killed replica takes no
    work and steps no more."""

    def __init__(self, index: int, model: GPTModel, cfg: GPTConfig,
                 serve_cfg: ServeConfig, devices: Sequence[torch.device],
                 registry: Optional[obs_metrics.Registry] = None,
                 tracer: Optional[Any] = None):
        self.index = index
        self.devices = tuple(devices)
        self.placement = placement(self.devices)
        self.eng = ServeEngine(model, cfg, serve_cfg,
                               registry=registry or obs_metrics.Registry(),
                               device=self.placement, tracer=tracer,
                               trace_name=f"replica{index}")
        self.alive = True
        self._install = transfer.make_install(list(self.eng.pools))
        self._hist = self.eng.metrics.histogram(
            "serve_decode_step_seconds")
        #: the histogram's state after the replica's FIRST decode step
        #: (its warm-up): the p99 the router ranks by and exports is the
        #: steady state's
        self._p99_window = None

    # -- admission ----------------------------------------------------

    def can_admit(self, req: Request) -> bool:
        """A free slot and the whole footprint coverable, without side
        effects (the router checks BEFORE paying the wire).  Reclaimable
        blocks are the free ones plus the refcount-0 cached prefix
        blocks, which ``alloc`` reclaims."""
        sched = self.eng.sched
        return bool(self.alive and sched.free_slots()
                    and sched.blocks_needed(req)
                    <= sched.allocator.reclaimable_count)

    @torch.inference_mode()
    def admit_shipment(self, shp: KVShipment) -> Optional[int]:
        """Install a prefilled request: allocate its FULL footprint,
        write the shipped blocks into this replica's pools through the
        assigned page-table row, set the slot's generator, and arm the
        slot for decode.  Returns the slot, or None when the replica could
        not take the shipment (dead, no slot, blocks short)."""
        eng, sched = self.eng, self.eng.sched
        free = sched.free_slots()
        if not self.alive or not free:
            return None
        req = shp.request
        try:
            blocks = sched.allocator.alloc(sched.blocks_needed(req), req)
        except PoolExhausted:
            return None
        slot = free[0]
        sched._install(slot, req, blocks)
        self._install(eng.pools, eng.generators,
                      eng._t(sched.page_table[slot]).long(), shp.kv, slot,
                      shp.key)
        sched.arm(slot, shp.first_token, shp.prompt_len)
        # an admission dispatch into the pools: a capture window it
        # lands in is discarded
        eng._admission_dispatches += 1
        return slot

    def submit(self, req: Request) -> None:
        """The recompute path: the replica prefills through its own
        admission."""
        self.eng.submit(req)

    # -- stepping / introspection -------------------------------------

    def step(self) -> Dict[str, np.ndarray]:
        if not self.alive:
            return {}
        out = self.eng.step()
        if self._p99_window is None and self._hist.count > 0:
            self._p99_window = self._hist.state()
        return out

    def idle(self) -> bool:
        return (not self.alive) or self.eng.sched.idle()

    def p99(self) -> float:
        """Steady-state decode-step p99 (the first step windowed out);
        ``nan`` before any observation after it."""
        if self._p99_window is None:
            return math.nan
        return self._hist.quantile(0.99, since=self._p99_window)

    def load(self) -> tuple:
        """The admission score from the engine's gauges (lower is
        preferred): outstanding work (queue + active slots), then block
        utilization, then the steady-state decode p99."""
        reg = self.eng.metrics
        q = reg.gauge("serve_queue_depth").value
        occ = reg.gauge("serve_slot_occupancy").value
        util = reg.gauge("serve_block_utilization").value
        p99 = self.p99()
        return (q + occ * self.eng.scfg.num_slots, util,
                0.0 if math.isnan(p99) else p99)


def _models_by_device(model: GPTModel, devices) -> Dict[str, GPTModel]:
    """The model on each device of ``devices``: itself where it lives,
    else one copy a device (replicas on one device share weights)."""
    out: Dict[str, GPTModel] = {}
    for dev in devices:
        key = str(dev)
        if key not in out:
            out[key] = model if same_device(model.device, dev) \
                else copy.deepcopy(model).to(dev)
    return out


class DisaggRouter:
    """The fleet's front door: ``submit()`` then ``step()`` / ``run()`` as
    for one engine; behind it requests prefill on the prefill slice,
    their KV ships to a decode slice, and the replicas decode.

    >>> router = DisaggRouter(model, cfg, ServeConfig(num_slots=4),
    ...                       devices=["cuda:0", "cuda:1", "cuda:2"])
    >>> router.submit(Request("a", prompt, max_new_tokens=32))
    >>> outputs = router.run()       # {"a": generated ids}

    ``serve_cfg`` describes ONE decode replica (all are alike; the
    prefill worker derives its one-slot config from it).  ``devices``
    defaults to every visible card and must hold ``n_prefill_devices +
    n_decode_replicas x devices_per_replica`` of them (a list may repeat
    a device: the slices then share it).  :meth:`kill_replica` loses a
    replica's device state mid-stream; the router rebuilds each of its
    requests as a continuation (prompt + the tokens streamed, the
    remaining budget, the generator re-derived by draw count) and
    prefills it elsewhere."""

    def __init__(self, model: GPTModel, cfg: GPTConfig,
                 serve_cfg: ServeConfig,
                 router_cfg: Optional[RouterConfig] = None,
                 devices: Optional[Sequence] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 slices: Optional[FleetSlices] = None,
                 tracer: Optional[Any] = None,
                 flight: Optional[Any] = None):
        self.rcfg = router_cfg or RouterConfig()
        self.scfg = serve_cfg
        #: request tracer (apex_tpu_torch.obs.reqtrace): the router mints
        #: the id at admission and hands the tracer to the worker
        #: ("prefill") and every replica ("replica{i}"); None = off
        self.tracer = tracer
        #: incident flight recorder (apex_tpu_torch.obs.flight), whose
        #: tail kill_replica's incident carries; None = off
        self.flight = flight
        self.slices = slices if slices is not None else slice_fleet(
            devices,
            n_prefill_devices=self.rcfg.n_prefill_devices,
            n_decode_replicas=self.rcfg.n_decode_replicas,
            devices_per_replica=self.rcfg.devices_per_replica)
        if len(self.slices.decode) != self.rcfg.n_decode_replicas:
            raise ValueError(
                f"slices carry {len(self.slices.decode)} decode "
                f"replicas, RouterConfig says "
                f"{self.rcfg.n_decode_replicas}")
        self.metrics = registry if registry is not None \
            else obs_metrics.DEFAULT
        homes = [placement(self.slices.prefill)] + [
            placement(s) for s in self.slices.decode]
        models = _models_by_device(model, homes)
        self.prefill = PrefillWorker(models[str(homes[0])], cfg, serve_cfg,
                                     self.slices.prefill, tracer=tracer)
        self.replicas: List[DecodeReplica] = [
            DecodeReplica(i, models[str(homes[i + 1])], cfg, serve_cfg,
                          devs, tracer=tracer)
            for i, devs in enumerate(self.slices.decode)]
        self.queue: List[Request] = []
        self._outputs: Dict[str, np.ndarray] = {}
        # -- router telemetry: host numbers at step boundaries
        self._m_queue = self.metrics.gauge(
            "serve_router_queue_depth",
            "requests held by the router (admission control: no "
            "eligible replica under the block-utilization bar)")
        self._m_ship = self.metrics.counter(
            "serve_kv_shipments_total",
            "prefilled requests shipped to a decode replica")
        self._m_bytes = self.metrics.counter(
            "serve_kv_transfer_bytes",
            "device-to-device bytes of shipped prefill KV (pools + "
            "generator state; zero under transfer='recompute')")
        self._m_reroute = self.metrics.counter(
            "serve_reroute_total",
            "requests rebuilt from the streamed-token log and "
            "re-prefilled elsewhere after a replica death")
        n = len(self.replicas)
        self._m_rep_q = [
            self.metrics.gauge(
                f"serve_replica{i}_queue_depth",
                f"replica {i} engine-local queue (recompute "
                f"admissions + preemption continuations)")
            for i in range(n)]
        self._m_rep_occ = [
            self.metrics.gauge(
                f"serve_replica{i}_slot_occupancy",
                f"replica {i} active slots / num_slots")
            for i in range(n)]
        self._m_rep_util = [
            self.metrics.gauge(
                f"serve_replica{i}_block_utilization",
                f"replica {i} live KV blocks / usable pool")
            for i in range(n)]
        self._m_rep_p99 = [
            self.metrics.gauge(
                f"serve_replica{i}_decode_p99_seconds",
                f"replica {i} decode-step p99 (from its own "
                f"serve_decode_step_seconds histogram)")
            for i in range(n)]
        # -- prefix sharing (per-replica indexes): mirrors of each
        # replica's prefix gauges and the straight-to-decode counter
        self._m_prefix_direct = None
        self._m_rep_hit: List = []
        self._m_rep_shared: List = []
        if serve_cfg.prefix_cache:
            self._m_prefix_direct = self.metrics.counter(
                "serve_prefix_direct_admissions_total",
                "prefix-hit requests admitted STRAIGHT to a decode "
                "replica — no prefill-slice time, no KV shipment for "
                "the shared span")
            self._m_rep_hit = [
                self.metrics.gauge(
                    f"serve_replica{i}_prefix_hit_rate",
                    f"replica {i} prefix-cache hit rate (mirror of "
                    f"its serve_prefix_hit_rate gauge)")
                for i in range(n)]
            self._m_rep_shared = [
                self.metrics.gauge(
                    f"serve_replica{i}_prefix_shared_blocks",
                    f"replica {i} blocks mapped by more than one slot "
                    f"(mirror of its serve_prefix_shared_blocks "
                    f"gauge)")
                for i in range(n)]
        # -- SLO admission: one evaluator per replica over its OWN
        # registry, judged at the boundary _record_metrics owns
        self.slo_evals = None
        self._m_rep_slo = []
        if self.rcfg.slo:
            from apex_tpu_torch.obs.slo import SLOEvaluator
            self.slo_evals = [SLOEvaluator(rep.eng.metrics, self.rcfg.slo)
                              for rep in self.replicas]
            self._m_rep_slo = [
                self.metrics.gauge(
                    f"serve_replica{i}_slo_ok",
                    f"replica {i} SLO eligibility (1 = no objective "
                    f"violated in its window; 0 = de-ranked from "
                    f"admission)")
                for i in range(n)]
        # -- continuous profiling: one profiler and drift sentinel a
        # replica, phases staggered so fleet windows do not collide on
        # the process-wide capture
        self.profilers = None
        self.sentinels = None
        self._m_rep_drift = []
        if self.rcfg.contprof is not None:
            from apex_tpu_torch.obs import contprof as contprof_lib
            pcfg = self.rcfg.contprof
            stride = max(pcfg.capture_steps + 1, pcfg.capture_every // n)
            self.profilers, self.sentinels = [], []
            for i, rep in enumerate(self.replicas):
                sent = contprof_lib.DriftSentinel(
                    band=self.rcfg.contprof_band, k=self.rcfg.contprof_k,
                    registry=rep.eng.metrics, flight=self.flight,
                    incident_path=self.rcfg.incident_path, name="serve")
                self.sentinels.append(sent)
                self.profilers.append(contprof_lib.serve_profiler(
                    rep.eng, sentinel=sent, config=dataclasses.replace(
                        pcfg, phase=pcfg.phase + i * stride)))
            self._m_rep_drift = [
                self.metrics.gauge(
                    f"serve_replica{i}_profile_drift",
                    f"replica {i} confirmed, unrecovered op-level drift "
                    f"(mirror of its serve_profile_drift gauge; a "
                    f"drifting replica ranks last in admission)")
                for i in range(n)]

    # -- submission ----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Validate against ONE decode replica's shapes (the scheduler's
        own check; every replica is alike) and enqueue, so a request no
        replica could hold is refused here, not deadlocked later."""
        validate_request(req, self.scfg.block_size,
                         self.scfg.max_blocks_per_slot,
                         self.scfg.num_blocks)
        self.queue.append(req)
        if self.tracer is not None:
            # router admission is the request id's birthplace
            self.tracer.mint(req.uid)
            self.tracer.record("enqueue", req.uid, "router",
                               queue_depth=len(self.queue))
        self._m_queue.set(float(len(self.queue)))

    # -- routing -------------------------------------------------------

    def _eligible(self, req: Request) -> List[tuple]:
        """``(load, replica)`` for every replica that may take ``req``
        this boundary: alive, a free slot and the footprint, block
        utilization under the admission bar, no violated SLO.  ``load``
        leads with the replica's drift flag, so a drifting replica ranks
        last."""
        scored = [((self._drifting(r),) + r.load(), r)
                  for r in self.replicas
                  if r.can_admit(req) and not self._slo_violating(r)]
        return [(load, r) for load, r in scored
                if load[2] < self.rcfg.admit_block_util]

    def _pick_replica(self, req: Request) -> Optional[DecodeReplica]:
        """The least-loaded eligible replica, ranked by (drifting,
        outstanding work, utilization, decode p99)."""
        eligible = self._eligible(req)
        if not eligible:
            return None
        return min(eligible, key=lambda lr: lr[0])[1]

    def _pick_prefix_replica(self, req: Request):
        """``(replica, matched_tokens)`` for the eligible replica whose
        prefix index covers the most leading prompt tokens (load breaks
        ties), or ``(None, 0)`` when none covers any."""
        best = None
        for load, r in self._eligible(req):
            hit = r.eng.sched.probe_prefix_tokens(req.prompt)
            if hit > 0 and (best is None or (-hit, load) < best[0]):
                best = ((-hit, load), r)
        if best is None:
            return None, 0
        return best[1], -best[0][0]

    def _drifting(self, rep: DecodeReplica) -> bool:
        """True when the replica's drift sentinel holds a confirmed,
        unrecovered drift: it ranks LAST in admission (a soft de-rank,
        not a block)."""
        if self.sentinels is None:
            return False
        return self.sentinels[rep.index].drifting

    def _slo_violating(self, rep: DecodeReplica) -> bool:
        """True when the replica's LAST boundary evaluation has a
        violated objective: it decodes what it holds but takes no new
        admission until its window recovers."""
        if self.slo_evals is None:
            return False
        return self.slo_evals[rep.index].violated()

    def _route_one(self) -> bool:
        """Route the head of the queue; False = held (no eligible replica
        this boundary)."""
        req = self.queue[0]
        # a prefix hit goes STRAIGHT to the replica holding the match,
        # which prefills only the unmatched suffix
        hit_rep, hit_tokens = self._pick_prefix_replica(req)
        if hit_rep is not None:
            self.queue.pop(0)
            hit_rep.submit(req)
            self._m_prefix_direct.inc()
            if self.tracer is not None:
                self.tracer.record("prefix_direct", req.uid, "router",
                                   to_replica=hit_rep.index,
                                   matched_tokens=hit_tokens)
            return True
        rep = self._pick_replica(req)
        if rep is None:
            return False
        self.queue.pop(0)
        if self.rcfg.transfer == "recompute":
            rep.submit(req)
            return True
        verdict = self.prefill.prefill(req)
        if verdict[0] == "done":
            self._outputs[req.uid] = verdict[1]
            return True
        shp = transfer.ship(verdict[1], rep.placement)
        if self.tracer is not None:
            self.tracer.record("kv_ship", req.uid, "router",
                               to_replica=rep.index,
                               nbytes=int(shp.nbytes))
        slot = rep.admit_shipment(shp)
        if slot is not None:
            self._m_ship.inc()
            self._m_bytes.inc(shp.nbytes)
            if self.tracer is not None:
                self.tracer.record("kv_install", req.uid,
                                   f"replica{rep.index}", slot=slot)
        else:
            # a miss (the capacity check raced an admission of the same
            # boundary): the ORIGINAL request re-prefills on the replica
            rep.submit(req)
        return True

    def step(self) -> Dict[str, np.ndarray]:
        """One fleet step boundary: route admissions (prefill + ship),
        then one decode step on every live replica; returns the requests
        that finished this boundary."""
        while self.queue and self._route_one():
            pass
        finished: Dict[str, np.ndarray] = {}
        for rep in self.replicas:
            finished.update(rep.step())
        self._outputs.update(finished)
        self._record_metrics()
        return finished

    def _record_metrics(self) -> None:
        self._m_queue.set(float(len(self.queue)))
        for i, rep in enumerate(self.replicas):
            reg = rep.eng.metrics
            self._m_rep_q[i].set(reg.gauge("serve_queue_depth").value)
            self._m_rep_occ[i].set(
                reg.gauge("serve_slot_occupancy").value)
            self._m_rep_util[i].set(
                reg.gauge("serve_block_utilization").value)
            p99 = rep.p99()
            self._m_rep_p99[i].set(0.0 if math.isnan(p99) else p99)
            if self._m_rep_hit:
                self._m_rep_hit[i].set(
                    reg.gauge("serve_prefix_hit_rate").value)
                self._m_rep_shared[i].set(
                    reg.gauge("serve_prefix_shared_blocks").value)
            if self.slo_evals is not None and rep.alive:
                self.slo_evals[i].evaluate()
                self._m_rep_slo[i].set(
                    0.0 if self.slo_evals[i].violated() else 1.0)
            if self.sentinels is not None:
                self._m_rep_drift[i].set(
                    1.0 if self.sentinels[i].drifting else 0.0)
        self.metrics.tick()

    def slo_summary(self) -> Optional[dict]:
        """Per-replica SLO verdicts of the last boundary; None when no
        objectives are configured."""
        if self.slo_evals is None:
            return None
        return {f"replica{i}": ev.summary()
                for i, ev in enumerate(self.slo_evals)}

    def idle(self) -> bool:
        return not self.queue and all(r.idle() for r in self.replicas)

    def run(self, max_steps: int = 100_000) -> Dict[str, np.ndarray]:
        """Drain the fleet; ``{uid: generated token ids}`` for every
        request ever submitted (the prompt not repeated)."""
        steps = 0
        try:
            while not self.idle():
                outstanding = len(self.queue) + sum(
                    r.eng.sched.n_active() + len(r.eng.sched.queue)
                    for r in self.replicas if r.alive)
                self.step()
                steps += 1
                if steps > max_steps:
                    raise RuntimeError(
                        f"router loop exceeded {max_steps} steps with "
                        f"{outstanding} request(s) outstanding")
        finally:
            if self.profilers is not None:
                for prof in self.profilers:
                    prof.abort_window()
        return dict(self._outputs)

    # -- failure semantics --------------------------------------------

    def kill_replica(self, index: int) -> List[str]:
        """Lose replica ``index`` mid-stream (its pools and generators are
        gone).  Every request in its slots is rebuilt from the streamed
        tokens as a continuation (the original prompt + every token
        streamed, the remaining budget, the generator re-derived by draw
        count with :func:`~apex_tpu_torch.serve.sampling.advance_key`)
        and re-queued AT THE FRONT to prefill on a live replica; its
        engine-local queue re-queues as it is.  Returns the rerouted
        uids."""
        rep = self.replicas[index]
        if not rep.alive:
            return []
        rep.alive = False
        if self.profilers is not None:
            # a dead replica steps no more: its open window would hold
            # the process's capture for the rest of the run
            self.profilers[index].abort_window()
        if self.flight is not None:
            self.flight.note("replica_kill", replica=index,
                             active=rep.eng.sched.n_active(),
                             queued=len(rep.eng.sched.queue))
        rerouted: List[Request] = []
        sched = rep.eng.sched
        for slot in range(sched.num_slots):
            s = sched.slots[slot]
            if s is None:
                continue
            req = s.request
            if req.max_new_tokens - len(s.emitted) < 1:
                continue           # retired the same boundary it died
            # one draw per streamed token (the prefill sample included):
            # the chain's position is the draw count
            draws = len(req.prior_tokens) + len(s.emitted)
            state = advance_key(req.seed, draws).get_state().numpy()
            rerouted.append(sched.continuation(slot, state))
        # the engine-local queue emitted nothing since queuing
        rerouted.extend(sched.queue)
        self.queue[:0] = rerouted
        for r in rerouted:
            if self.tracer is not None:
                # every reroute names the killed replica
                self.tracer.record("reroute", r.uid, "router",
                                   from_replica=index)
            if self.flight is not None:
                self.flight.note("reroute", uid=r.uid, from_replica=index)
        self._m_reroute.inc(len(rerouted))
        self._m_queue.set(float(len(self.queue)))
        if self.rcfg.incident_path:
            self._write_kill_incident(index, [r.uid for r in rerouted])
        return [r.uid for r in rerouted]

    def _write_kill_incident(self, index: int,
                             rerouted: List[str]) -> None:
        """The replica's death record: an incident
        (:mod:`apex_tpu_torch.resilience.incidents`) holding the router's
        metrics and the flight recorder's tail."""
        from apex_tpu_torch.resilience import incidents as incidents_lib
        extra: Dict[str, Any] = {
            "artifact": "disagg-router replica-death record",
            "replica": index, "rerouted": rerouted,
            "metrics": self.metrics.snapshot(),
        }
        if self.flight is not None:
            extra["flight"] = self.flight.dump()
        try:
            incidents_lib.write_incident(
                self.rcfg.incident_path, "replica-killed",
                f"decode replica {index} lost mid-stream; "
                f"{len(rerouted)} request(s) rebuilt from the "
                f"streamed-token log and re-prefilled elsewhere",
                [f"replica {index} killed with "
                 f"{len(rerouted)} in-flight/queued request(s)",
                 {"rerouted_uids": rerouted}],
                **extra)
        except Exception:
            import traceback
            traceback.print_exc()   # the recovery must not die on its
            #                         own record
