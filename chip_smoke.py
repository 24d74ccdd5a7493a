#!/usr/bin/env python3
"""Drive the apex_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --repo DIR --only o0_train,generic_kernels

With no arguments it runs every phase below on the checkout beside it.
``--repo`` drives another checkout's package (a parent tree unpacked
elsewhere) with this script's phase code, and ``--only`` runs just the
named phases of ``PARTIAL_PHASES`` after ``device`` and ``build``
(``o0_train``, ``generic_kernels``, ``train_kernels``, ``train``,
``multi_tensor_kernels``, ``bert_kernels``, ``bert_train``,
``resnet_kernels``, ``resnet_train``, ``ddp``, ``amp_surface``,
``data_prefetch``, ``seq_parallel``, ``rnn``, ``pipeline_moe``,
``resilience``, ``train_fleet`` (with ``obs_lag``, ``native`` and
``xplane``), ``quant``, ``serve_fleet``, ``serve``, ``contprof``),
printing their lines and no ``kernels`` or ``ok`` line: how one card
times a parent against a change.  The ``ddp``, ``seq_parallel`` and
``pipeline_moe`` phases re-run this script as their ranks
(``--ddp-rank``, through ``python -m apex_tpu_torch.parallel.multiproc``).

Phases, each printing one JSON line (``{"phase": ...}``):

1. device   the card's name and count, and ``nvidia-smi``'s name and power
            limit (also printed alone on a line);
2. build    ``nvcc`` builds every kernel from ``apex_tpu_torch/csrc`` for
            sm_90a: seconds, and registers / shared memory / spills per
            kernel from ``-Xptxas -v`` (the fused backward's four
            instantiations must show no spills, nor the generic kernels'
            tiled ones but for the register budgets kept with a few
            spilled words, ``SIMT_SPILLS_KEPT``, nor K16's Hopper kernels,
            nor K3's but ``LN_BWD_SPILLS_KEPT``; K16's CUDA-core kernel
            within ``CONV1X1_FMA_SPILL_CAP``);
3. kernels  each kernel against its plain PyTorch version at the serving
            path's shapes: max abs error within the stated tolerance,
            kernel / plain / library-call times (CUDA events) and the
            bound (bytes over 3.35 TB/s or operations over the peak rate,
            whichever is larger); the layer-norm forward (K1) also at the
            training shapes (16384 x 768 and x 1024 bf16), timed in turns
            with ``F.layer_norm`` as the call without statistics (``ms``,
            what a decode step makes) and with them (``stats_ms``), and
            the device's time a call of each (``device_ms``: calls queued
            behind a device-side sleep, timed by CUDA events); every
            K1 route (a row a warp, a row a block, three passes; 16-byte or
            element accesses, a view at an odd element offset) in every
            dtype pair, and the two routes' device times by row count (the
            crossover); the flash forward (K2, a Hopper kernel:
            wgmma on TMA-loaded tiles) timed as its launch on prepared
            operands (``ms``) and as the public call (``call_ms``);
4. serve    gpt_small at full width (bf16 weights from a seed, through
            ``params_from_jax``): 16 greedy requests drained by
            ``ServeEngine.run()``; tokens/s, decode-step p50/p99, and the
            layer-norm kernel's launches (>= 25 per decode step);
5. solo     4 of those requests through ``generate()``: the flash kernel
            launches once per layer per call; token agreement with the
            engine under the near-tie rule;
   serve_fleet  (after solo, before any profiler session) speculative
            decoding and the disaggregated fleet on gpt_small (bf16 from
            the seeded tree, the serve phase's 16 requests and shapes):
            ``SpecEngine`` with ``truncated_draft(..., 2)`` and k 4 in
            turns with the dense engine (tokens/s, p50 / p99 a round or
            step, the acceptance counters, K1 exactly (k + 1)(2 L_d + 1)
            + 2 L + 1 a round plus the draft's and the target's prefill
            chunks, spec against dense under the near-tie rule);
            ``DisaggRouter`` with 2 decode replicas on ``[cuda:0] * 3``
            (the slices share the card), in ``ship`` mode, ``recompute``
            mode and ``ship`` with the busiest replica killed after 6
            steps: tokens/s, shipments and their bytes (pools + the
            generator state), CUDA-event ms of each shipment's gather,
            wire and install, the three timed alone beside their bounds,
            K1 exactly (2 L + 1) a decode step or prefill chunk, streams
            against the dense engine's under the near-tie rule; then the
            port's ``train_toy_lm`` on the card: spec, the fleet (ship,
            recompute, a kill) and solo ``generate()`` (K2 once a layer)
            exactly equal to the dense engine;
6. reference  fp32 on a small input: the card's kernels against the plain
            versions on the CPU, tokens and logits;
7. train kernels  the training slice's kernels (layer-norm backward, the
            fused flash backward K4 with rope and its finish pass, also
            in fp16 at a padded head width, the flash forward with rope and
            its k^ prologue, Adam, the amp unscale: one launch over the
            chunk table of the 148 leaves) against their plain
            versions at the train step's shapes, with the same timings and
            bounds, and the two backward kernels run twice for equal bits;
            the forward with rope also timed the other way (the full
            prologue writing q^ and k^, then K2 with no q preparation),
            its output equal bit for bit;
8. train    gpt_small at full width and depth, amp O2 + FusedAdam
            (lr 3e-4, one K11 launch a step), B 8 x L 2048 on the
            synthetic stream of ``examples/gpt_lm.py``, 10 steps from
            seeded weights: per-step loss (finite, falling), step ms p50
            over steps 3-10, tokens/s, peak memory, launches per step of
            every kernel (one unscale, K6, a step; the layer-norm backward
            launches twice a call: dx, then the dw/db sum; the flash
            backward takes the
            two-pass route, its prologue, K13 and K14, since K4's
            planes, 1.61 GB, exceed the 1 GiB budget), the pointer rows
            uploaded (the optimizer's: none after step 1; the unscale's:
            by step, its input row following autograd's gradients); 5
            more pairs of steps alternating the fused route
            (K4 and its finish pass) and the two-pass route for both
            routes' p50; then one step with an injected non-finite
            gradient, which must be skipped on the card (masters and
            moments unchanged, scale halved);
9. train reference  a 2-layer, 2 x 64-head model, 3 steps on the card
            against the same on the CPU (plain versions): fp32 O0, and bf16
            O3 (no master weights: Adam steps the bf16 parameters);
   multi_tensor_kernels  axpby (K10), the whole-tree Adam (K11) and the
            per-tensor sums of squares (K12) against their plain versions
            at gpt_small's 148 leaves (K12 also at bert_large's 303): K10
            bitwise for every arg_to_check with an inf in x, then in y, and
            in place; K11 bitwise (fp32 g with bf16 copies; bf16 p and g)
            and equal to K5 leaf by leaf, nothing written under the noop
            flag; K12 within 1e-6 relative; all repeat bitwise; kernel /
            plain / library times and the bounds;
   nonfinite_kernels  K15, the packed non-finite flag, against its plain
            version at gpt_small's 148 fp32 leaves, bert_large's 303 and a
            mixed bf16 / fp16 / fp32 tree with integer leaves: an inf,
            then a nan, at the first, a middle and the last element of a
            ragged leaf, the flags equal bit for bit; kernel / plain /
            eager per-leaf check times and the bound;
   accum    gpt_small O2 + FusedAdam with ``accum_steps=4`` over B 32 x L
            2048 (micro-batches of 8), 10 steps: losses, step p50 (beside
            PR 6's, before K15), tokens/s, peak memory, the exact launches
            per step (K10 4, K15 1, K6 0, K11 1, K5 0, 4 x the passes'
            kernels, K12 1 for the per-leaf gradient norms logged each
            step), pointer-row uploads per step, one profiled step, and a
            step whose micro-batch 1 is non-finite, skipped on the card;
   accum_reference  a 2-layer fp32 GPT at O0 with ``accum_steps=2``, 3
            steps, card against CPU;
   fp16_optimizer  gpt_small at B 8 x L 2048 under ``FP16Optimizer(
            dynamic_loss_scale=True, max_grad_norm=1.0)``, 5 steps of one K5
            and one K9 launch each, an injected overflow skipped on the
            card, and a 2-layer model's steps card against CPU;
   long_context_kernels  the two-pass flash backward, K13 (dq) and K14
            (dk / dv), Hopper kernels (wgmma on TMA-loaded tiles), against
            their plain versions (run over slices of heads) at the train
            shape, at B 1 x L 16384, at BERT's non-causal shape with a
            ragged key mask, at 6 heads of 128, at B 1 x L 32768 and at a
            ragged (2, 1000, 4, 40) whose head width TMA pads to 64:
            bitwise repeats, times, bounds, their prologue (q pre-scaled
            and rotated, k rotated) bitwise against its plain version, the
            pair beside SDPA's backward, and where K4's planes fit 2 GiB,
            both routes of ``flash_attn_bwd`` timed whole
            (dq, dk and dv within 2 bf16 ulps and the row and norm limits
            of K4's);
   long_context  gpt_small with ``remat=True`` (O2 + FusedAdam), B 1 x L
            16384, 10 steps (falling loss, p50, tokens/s, peak memory,
            the exact launches per step: K13 12, K14 12 (and their
            prologue 12), K4 0, K2 24 (and its k^ prologue 24), K1 49,
            K3 50, K6 1, K11 1; one
            profiled step; an injected overflow skipped), then B 1 x L
            32768, 3 steps; K4's planes
            (12.9 and 51.5 GB) printed beside the peaks;
   long_context_reference  a 2-layer remat GPT at O2, B 2 x L 1024, 3
            steps on the card with the budget at 0 (two-pass) and at its
            default (fused), each against the CPU, and the two routes'
            first-step gradients against each other;
10. bert kernels  the BERT slice's kernels against their plain versions:
            LAMB stage 1 and 2 and the global sum of squares over
            bert_large's 303 fp32 master leaves with bf16 copies (bitwise
            repeats, the noop flag), and the layer-norm and flash kernels
            at bert_large's shapes (16384 x 1024; (32, 512, 16, 64),
            non-causal, a key mask), with the same timings and bounds;
11. bert_train  bert_large at full width and depth, amp O2 + FusedLAMB
            (lr 1e-3, eps 1e-6, weight decay 0.01, max_grad_norm 1.0),
            B 32 x L 512 on the synthetic masked-LM batch of
            ``examples/bert_pretraining.py``, 10 steps from seeded weights:
            losses (finite, falling), step ms p50 over steps 3-10,
            sequences/s, tokens/s, peak memory, the exact launches per
            step, one profiled step, and one injected overflow skipped on
            the card;
12. bert_train reference  a 2-layer, 2 x 64-head BERT with a ragged key
            mask, 3 FusedLAMB steps on the card against the CPU: fp32 O0
            and bf16 O2.
13. resnet_kernels  K16, the fused 1x1-conv backward, against its plain
            version at ResNet-50's 12 shapes of 1x1 stride-1 convs (bf16,
            B 256 x 224^2), in fp32 and at ragged shapes (every route of
            ``conv1x1_route``: one_pass, two_role, fma), each record with
            its route and launch plan: dx by
            ``scaled_errs`` and within 2 ulps of its largest element, dW
            within that bound, bitwise repeats; kernel / plain / cuDNN
            ``convolution_backward`` times, the HWIO-to-OIHW weight copy
            cuDNN makes, and the bounds; the step's 33 calls summed
            against cuDNN's (``k16_ms_a_step``,
            ``convolution_backward_ms_a_step``);
14. resnet_train  ResNet-50 at full width and depth (seeded weights on
            the card), amp O2 + FusedAdam (lr 1e-3), B 256 x 224^2 on one
            synthetic batch of ``examples/imagenet_main_amp.py``: 10 steps
            with ``APEX_TPU_FUSED_CONV1X1`` off, then 10 with it on, each
            with step p50 over steps 3-10, images/s, peak memory, one
            profiled step and the exact launches per step (K6 1, K11 1,
            K16 33 with the switch on, 0 off); the loss must fall; an eval
            pass on the running stats (top-1 / top-5 on that batch); one
            injected overflow skipped on the card while its forward still
            moves the running stats;
15. resnet_reference  a small Bottleneck ResNet, fp32 O0, 3 steps on the
            card against the CPU with the switch off and on (9 fp32 K16
            launches a step on the card).
   ddp      data parallelism across processes, each rank this script
            started by the port's spawner: NCCL at world size one,
            ResNet-50 O2 + FusedAdam at B 256 x 224^2, 3 world-one steps
            and 10 timed, then ``convert_syncbn_model`` +
            ``DistributedDataParallel`` from the same seeded weights: 3
            steps held against the world-one ones (losses within 2e-2,
            masters within 2 x 3 x lr), 10 timed (p50, peak memory, K6 1
            and K11 1 a step, the collectives a step: 3 a BatchNorm and
            one a bucket), one profiled (NCCL kernels, the bucket pack /
            unpack and the BatchNorm statistics ranges); gloo, two
            processes on ``cuda:0``, B 2 x 32, 3 steps against the
            whole-batch B 64 world-one run, the ranks' masters and running
            stats equal bit for bit, an inf on rank 1 skipped on both;
            LARC's per-leaf norms (K12, two launches) at ResNet-50's 161
            leaves against the plain version.  No path across several
            cards runs (one card);
   amp_surface  (after ddp) the legacy ``FP16_Optimizer`` on BASELINE
            config 1's MLP in bf16 (SGD with momentum, dynamic scaling,
            an inf at step 2) against the same run on the CPU (scales and
            skips equal, losses within 2e-2; K6 and K9, the clip's norm,
            once a step) and on
            gpt_small (FusedAdam, B 8 x L 2048, 10 steps: K6 1, K11 1,
            p50 beside the ``train`` phase's); ``Amp.add_params`` growing a
            gpt_small O2 state by a ``Dense`` after 2 steps (the next
            step's K6 and K11 one launch each over all 150 leaves, masters
            and moments equal bit for bit to the plain Adam on the CPU);
            K15 (the legacy scaler's overflow scan) and K6 (its unscale)
            against their plain versions on those leaf lists;
   data_prefetch  ResNet-50 O2 at B 256 x 224^2 fed uint8 host batches
            through ``DataPrefetcher`` with ``normalize_uint8`` (pinned
            copies and the normalize on a side stream), in turns with
            steps on a batch already on the card: both p50s, K6 1 and K11
            1 a step, the normalized batch equal bit for bit to the CPU's;
   seq_parallel  the ring's block calls at gpt_small's width (K2 with its
            lse, the backward with the lse's cotangent: K13 + K14 at L
            8192, K4 on a masked block with a row of keys all masked)
            against their plain versions; NCCL at world size 1 in this
            process: gpt_small O2 + FusedAdam, remat, B 1 x L 16384 with
            ``seq_axis_name``, 10 steps in turns with the local step
            (p50s, launches); two gloo processes on ``cuda:0``: ring and
            Ulysses at (1, 16384, 12, 64) causal and (4, 2048, 16, 64)
            masked against the local call, then gpt_small's ring and
            Ulysses steps (3 each, 8192 tokens a rank) against the
            whole-sequence run (losses within 2e-2, first gradients within
            4 bf16 ulps of each leaf's largest element, masters equal bit
            for bit across the ranks; every block through the host);
   pipeline_moe  (after seq_parallel) NCCL at world size 1 in this
            process: gpt_small's 12 blocks as one pipeline stage (O2 +
            FusedAdam, B 8 x L 2048 in 4 microbatches, ``finite_axes=
            ("pipe",)``; the embedding, ``ln_f`` and the head outside,
            the embedding's gradient summed over the group) in turns with
            the local O2 step: both p50s and their ratio, the launches and
            collectives a step, each step profiled; the expert mode of
            ``examples/pipeline_moe.py`` at gpt_small's FFN width (8
            experts 768 -> 3072 -> 768, gelu, cf 2.0, 16384 tokens, O2 +
            FusedAdam, the router's gradient averaged by ``reduce_fn``,
            ``finite_axes=("expert",)``): p50, all-to-alls a step, one
            profiled step; two gloo processes on ``cuda:0``: 6 blocks a
            stage, 3 steps against the unpipelined run (losses within
            2e-2, masters within Adam's drift bound, hops a step), 4
            experts and 8192 tokens a rank against one process holding
            all 8 (the first y and aux, 3 steps' losses within 2e-2), and
            in both an inf in rank 1's gradients skipping both ranks;
   resilience  (after pipeline_moe) durable checkpoints and
            ``run_resilient`` on gpt_small O2 + FusedAdam at B 8 x L 2048
            (12 steps, batches a function of the step index, a checkpoint
            every 4, at most 2 snapshots kept, under a temporary directory
            the phase deletes): the plain loop and the resilient loop in
            turns (both step p50s, the save's blocking ms, the writer's
            ms, the snapshot's bytes, the restore's ms, K6 1 and K11 1 a
            resolved step, K15 once a checkpoint); a preemption at step 8
            resumed by a fresh model, Amp and manager, equal to the
            uninterrupted run (bit for bit where the uninterrupted runs
            agree bit for bit, else within their spread); a NaN storm
            pinning the scale after the commit of step index 7 was
            corrupted: the rewind skips it and lands on step index 3, and
            the losses fall again; a flaky save absorbed by ``retry_io``; a
            4 s hang under a 2 s watchdog: a valid incident written
            within the hang, then ``WatchdogTimeout``; the card's snapshot
            restored into a CPU template bit for bit;
   train_fleet  (after resilience) the elastic fleet's drill on
            ``cuda:0``: two supervisors and their generation children
            (DDP + amp O2 + FusedAdam, an MLP at gpt_small's MLP widths,
            768 -> 3072 -> 768, 8192 rows a rank; two ranks on one card,
            so gloo), 24 steps, a snapshot every 4, rank 1 killed (child
            and supervisor) at step 10: the generations, each restore
            step, the steps lost, the detection latency (ledger clock),
            ``train_fleet_recovery_seconds``, the children's launches (K6,
            K11 a step, K15 a checkpoint); the shrink, regrow and
            cross-rank replays must all be bitwise equal;
   obs_lag  (after train_fleet) ``instrument_step`` around the gpt_small
            O2 step (B 8 x L 2048), 10 steps in turns with the bare step:
            both p50s, the pending groups after each tick, the loss gauge
            against the steps' own losses, ``/metrics`` and ``/fleet``
            scraped over HTTP while the steps run, the launches (the train
            phase's a step); one wrapped O4 step: both fp8 gauges;
   native   the native host runtime (``csrc/host_runtime.cpp``, the host
            compiler): ``plan_buckets`` on ResNet-50's O2 gradients and
            ``flatten`` / ``unflatten`` of its masters against their plain
            versions, timed;
   quant    (after native) fp8 / int8: ``quantize``, ``dequantize``,
            ``qdq`` (e4m3 and e5m2), ``quantize_int8``, ``quantize_kv``
            and ``record_amax`` on the card equal the CPU's bit for bit;
            ``scaled_matmul`` through ``torch._scaled_mm`` at gpt_small's
            ``ffn_in`` product against its plain version (relative error
            within ``MM_REL_TOL``, its time, the whole call's, the plain
            version's, the bf16 matmul's, the bound at the fp8 rate); the
            serve phase's 16 requests through the dense and the int8
            engine in turns (tokens/s, decode p50 / p99, the pools' bytes,
            ``serve_kv_quant_error``, K1 only), 4 of them through solo
            int8 ``generate()`` (K2 once a layer) under the near-tie rule;
            ``train_toy_lm`` trained on the card: int8 against dense
            tokens >= 0.9, two int8 runs bitwise equal, the int8 engine
            equal to solo; gpt_small at O4 in turns with O2 (B 8 x L
            2048, 10 steps each: losses, p50s, tokens/s, peak memory, the
            exact launches of every O4 step, sync-debug warnings, one
            profiled O4 step with the eager fp8 functions as their own
            group, an injected overflow skipped while the fp8 histories
            roll, 2 steps with ``accum_steps=2``: K10 2, K15 1, K6 0); a
            2-layer O4 model on the card against the CPU (losses within
            2e-2, the scales within ``O4_SCALE_RTOL``);
   rnn      every RNN mode card against CPU (H 512, B 16, T 32, both
            directions, ragged lengths) in fp32 (1e-4 of each tensor's
            largest element; the chaotic mLSTM 1e-3, beside each case's
            fp64 response to one fp32 rounding of the weights) and amp O2
            (2e-2; the mLSTM 0.1); the byte-level mLSTM language model
            (Radford et al.: 256 -> 64 embedding, ``mLSTM(4096)`` weight-
            normed, a 4096 -> 256 decoder, 86.3 M parameters), O2 +
            FusedAdam, B 128 x T 256, 10 steps: losses falling, the first
            within 2e-2 of an fp32 forward of the same weights, p50,
            bytes/s, peak memory, K6 1 and K11 1 a step, one profiled step
            by group, the weight-norm recompute timed alone, an injected
            inf skipped;
   o1_train  (after long_context_reference) gpt_small at amp O1, the
            default opt level (fp32 parameters, products cast to bf16 by
            the op layer), FusedAdam(3e-4), B 8 x L 2048, 10 steps: p50
            beside the O2 step's, tokens/s, peak memory, one profiled
            step, the exact launches per step (K1 / K3 in fp32, K6 1 over
            the fp32 gradients, K11 1), an injected overflow skipped;
   o1_reference  a 2-layer GPT at O1, card against CPU, losses within
            2e-2;
   o0_train  gpt_small at amp O0 (fp32 throughout, attention on the
            generic kernels' tiled layout, with rope inside them),
            FusedAdam(3e-4), B 8 x L 2048, 10 steps: falling losses, p50,
            tokens/s, peak memory, the exact launches per step
            (flash_fwd_simt 12, flash_bwd_simt 24, K1 25, K3 50, K6 1,
            K11 1) and one profiled step with the generic kernels named;
16. flash_mh_kernels  K17 (K2's Hopper kernel, one head a block) and
            K18 (K4's Hopper kernel), the multi-head flash forward and
            fused backward, against
            their plain versions at (8, 2048, 12, 64)
            causal, (32, 512, 16, 64) with a key mask, (1, 4096, 6, 128)
            causal and a ragged (2, 1000, 4, 64), with a cotangent on the
            lse: the row and norm limits, bitwise repeats, the backward
            once more at budget 0 (K13 + K14); times beside K2 / K4 on the
            same tensors and SDPA's forward and backward; the bounds;
17. flash_mh  the entry point ``flash_attention_mh`` with autograd at
            BERT's masked shape (K17 1, K18 1 and its finish pass 1) and
            at the GPT train shape (K17 1, K13 + K14 at the default
            budget);
18. mnist_o1  BASELINE config 1: ``MLP((256, 256))``, O1, SGD(0.05), B
            256, 20 steps: falling losses, p50, samples/s, launches (K6
            1), an injected overflow skipped;
   flash_repairs  (after flash_mh) ``flash_attention_mh`` and
            ``attention`` with autograd in fp16 and fp32 and at head widths
            40, 96, 192, 256, 520 and 1024 (the routes of ``fwd_route`` /
            ``bwd_route``: K2 / K17, K4 / K18 and the generic kernels),
            each against its plain versions by the row and norm limits,
            the launches of the path, K4 and K18 timed in fp16;
   fp16_o2  amp O2 with ``half_dtype=torch.float16`` at gpt_small's width
            and 4 layers, B 8 x L 2048, 5 steps: finite, falling losses,
            the exact launches per step (every kernel in fp16), p50, one
            injected overflow skipped;
19. dcgan_o1  BASELINE config 5: DCGAN (fm 64, zdim 100, 32^2, B 64), two
            FusedAdams with one O1 scaler each, 20 iterations: D's loss
            falls, p50, samples/s, launches (K6 1 a network, K11 2); then
            D's loss overflowed: only D's scale halves and
            only D's step is skipped.
   generic_kernels  the generic kernels (``flash_fwd_simt``,
            ``flash_bwd_simt``) against their plain versions, causal, at
            fp32 (2, 1024, 12, 64), fp32 (8, 2048, 12, 64) with rope (the
            O0 GPT step's), fp32 (8, 2048, 6, 128) and bf16 (1, 1024, 4,
            256): bitwise repeats, times (CUDA events), device ms (calls
            queued behind a device-side sleep), the bounds (each at the
            card's peak rate for the dtype), SDPA's calls where they
            compute the same function (no rope); in a partial run
            (``--only generic_kernels``) also the device kernels SDPA ran
            (the profiler: none in the whole run, before serve_profile);
20. serve_profile  last (a profiled run can slow the host's later
            calls): one decode step of gpt_small's 8 slots profiled (device
            ms by group, busy share) after one whose host ms in K1's calls
            is timed;
   xplane   (after serve_profile) two gpt_small O2 steps profiled under a
            schedule: ``obs.xplane``'s device total of the chrome trace
            within 1% of ``key_averages()``'s, 2 step markers.
   contprof  (after xplane) the continuous profiler: ``DisaggRouter``
            over gpt_small (2 decode replicas on ``[cuda:0] * 3``, the
            serve phase's 16 requests, capped at 80 new tokens) with
            ``RouterConfig(contprof=ContProfConfig(capture_every=16,
            capture_steps=2))``, a clean
            and a seeded lane (replica 0's kv_read x 2 from window 2) in
            turn with a run without a profiler: greedy streams equal bit
            for bit, every window from the device (none discarded, the
            decode fractions summing to 1, ``other`` at most half), the
            clean lane quiet, the seeded drift confirmed at window 3
            naming kv_read (gauges, incident, the replica ranked last, the
            PROFILE_DRIFT document valid); ``run_resilient`` over
            gpt_small O2 with ``train_profiler`` (fwd / bwd / optimizer
            above 0, K13 / K14 in bwd, K6 / K11 in optimizer, K2 / K1 in
            fwd, the profiled steps' launches the loop's), a NaN storm's
            rewind suppressing the open window; a window's cost against
            bare 2-step segments in turns (before and after it), amortized
            at ``capture_every=256`` against ``CONTPROF_BUDGET_PCT``; the
            decode ranges' cost outside a window (the ranges a step
            enters x a range's host µs); at most 90 s.

Every phase line carries ``at_s``, its seconds since the script started.
Then one JSON line of per-kernel numbers (``{"kernels": [...]}``), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before the last line; with no card it exits 1 at
once.  The script clears ``APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES`` (its
launch counts assume the default 1 GiB budget) and sets it only inside
the phases that compare the two routes; likewise it clears
``APEX_TPU_FUSED_CONV1X1`` and sets it only inside the ResNet phases.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # dense tensor cores
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
NEAR_TIE_FP32 = 1e-3         # top-2 logit margin of a recorded near tie
NEAR_TIE_BF16 = 0.125        # bf16 logits: a few ulps at |logit| ~ 4


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


#: the script's clock: each phase line carries its seconds since the start
_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - _T0, 3)}),
          flush=True)


def time_ms(fn, budget_s: float = 0.05) -> float:
    """Mean milliseconds per call over a run of calls timed with CUDA
    events, after a warm-up; the count is chosen to fill ~budget_s."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    n = int(min(max(budget_s / one, 3), 200))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


#: the byte budget of the fused flash backward's fp32 dq partial planes
#: (read by both packages on every call; 1 GiB by default)
BUDGET_ENV = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"
#: a budget above every plane buffer of this script: the fused route (K4)
FUSED_ALWAYS = 1 << 40


@contextlib.contextmanager
def env_set(name: str, value):
    """The environment variable ``name`` at ``value`` (unset for None)
    inside the block (or under the decorated function), restored after."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def fused_budget(nbytes: int):
    """The flash backward's partials budget at ``nbytes``."""
    return env_set(BUDGET_ENV, str(nbytes))


# -- phases ---------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", kind=name, count=count, nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)
    print(line, flush=True)
    return name, count, line


#: the generic kernels' tiled configurations kept at two 256-thread blocks
#: an SM (128 registers a thread) with a few spilled words, by the mangled
#: name's ``Cfg<DP, BR, BC, NT, MINB>``: the forward at DP 128 and both
#: backward passes at DP 64 (one block an SM, spill-free, ran about 35%
#: slower on the H100); their spills stay within ``SIMT_SPILL_CAP`` bytes
SIMT_SPILLS_KEPT = ("CfgILi128ELi64ELi64ELi256ELi2E",
                    "CfgILi64ELi64ELi64ELi256ELi2E")
SIMT_SPILL_CAP = 128


#: K16's CUDA-core kernel (fp32, and half types TMA cannot take) keeps
#: two 256-thread blocks an SM at 128 registers with a few spilled words:
#: faster over ResNet-50's fp32 shapes than one block at ~200 registers
#: (the source note, measured when it was ported); fp32 spills 548 / 492
#: bytes (stores / loads), the half types 28 / 60
CONV1X1_FMA_SPILL_CAP = 640
#: K3's instantiations kept at their register budget with a few spilled
#: words, by a fragment of the mangled name and a cap in bytes: LN_BWD_KEPT
LN_BWD_SPILLS_KEPT = ()


def _spill_bytes(ptxas_line):
    """(spill stores, spill loads) in bytes from one ``-Xptxas -v`` line."""
    return tuple(int(re.search(rf"(\d+) bytes spill {w}", ptxas_line)[1])
                 for w in ("stores", "loads"))


def phase_build():
    from apex_tpu_torch.ops.cuda import build
    lib = build.library(rebuild=True)
    info = build.build_info()
    require(info.compiled, "the kernels were not built from source")
    kernels = {}
    for mangled, lines in info.ptxas.items():
        short = mangled.split("_cu_")[-1][8:] if "_cu_" in mangled \
            else mangled
        kernels[short] = "; ".join(
            l for l in lines if not l.startswith("Compile time"))
    # K4 / K18's four instantiations (DP 64 / 128, bf16 / fp16): no spills
    fused = {k: v for k, v in kernels.items()
             if "flash_bwd_fused_sm90" in k}
    require(len(fused) == 4, f"flash_bwd_fused_sm90: {len(fused)} "
                             f"instantiations in the build, want 4")
    require(all(re.search(r"(^|\D)0 bytes spill stores", v)
                and re.search(r"(^|\D)0 bytes spill loads", v)
                for v in fused.values()),
            f"flash_bwd_fused_sm90 spills: {fused}")
    # the generic kernels' tiled instantiations: forward, dk / dv and dq at
    # DP 64 / 128 / 192 / 256 in fp32, bf16 and fp16
    tiled = {k: _spill_bytes(v) for k, v in kernels.items()
             if "_simt_tiled" in k}
    require(len(tiled) == 36, f"flash_*_simt_tiled: {len(tiled)} "
                              f"instantiations in the build, want 36")
    for k, spills in tiled.items():
        cap = SIMT_SPILL_CAP if any(c in k for c in SIMT_SPILLS_KEPT) else 0
        require(max(spills) <= cap,
                f"{k} spills {spills} bytes (stores, loads), cap {cap}")
    # K16: the Hopper kernels (one_pass, two_role; bf16, fp16) spill
    # nothing; the CUDA-core kernel keeps its two blocks an SM at 128
    # registers, a few spilled words, within CONV1X1_FMA_SPILL_CAP
    k16 = {k: _spill_bytes(v) for k, v in kernels.items()
           if "conv1x1_" in k}
    hopper16 = {k: v for k, v in k16.items()
                if "one_pass" in k or "two_role" in k}
    require(len(hopper16) == 4 and len(k16) == 7,
            f"conv1x1: {len(hopper16)} Hopper and {len(k16)} in all "
            "instantiations in the build, want 4 and 7")
    for k, spills in k16.items():
        cap = 0 if k in hopper16 else CONV1X1_FMA_SPILL_CAP
        require(max(spills) <= cap,
                f"{k} spills {spills} bytes (stores, loads), cap {cap}")
    # K3: no spills but the kept instantiations of LN_BWD_SPILLS_KEPT
    k3 = {k: _spill_bytes(v) for k, v in kernels.items() if "ln_bwd_" in k}
    require(k3, "ln_bwd: no instantiation in the build")
    for k, spills in k3.items():
        cap = next((c for frag, c in LN_BWD_SPILLS_KEPT if frag in k), 0)
        require(max(spills) <= cap,
                f"{k} spills {spills} bytes (stores, loads), cap {cap}")
    emit("build", nvcc_seconds=round(info.seconds, 3), library=info.path,
         sources=len(build.sources()), ptxas=kernels,
         # K2 / K17 by the padded head width they run at
         flash_fwd_sm90_dynamic_smem_bytes={
             d: lib.apex_flash_fwd_sm90_smem_bytes(d) for d in (64, 128)},
         # K4 / K18 by the padded head width they run at
         flash_bwd_fused_sm90_dynamic_smem_bytes={
             d: lib.apex_flash_bwd_fused_smem_bytes(d) for d in (64, 128)},
         flash_bwd_fused_sm90=fused,
         flash_simt_tiled_spills={k: v for k, v in tiled.items() if any(v)},
         conv1x1_spills={k: v for k, v in k16.items() if any(v)},
         ln_bwd_spills={k: v for k, v in k3.items() if any(v)},
         # K13 / K14 by the padded head width they run at
         flash_bwd_dq_sm90_dynamic_smem_bytes={
             d: lib.apex_flash_attn_bwd_dq_smem_bytes(d) for d in (64, 128)},
         flash_bwd_dkv_sm90_dynamic_smem_bytes={
             d: lib.apex_flash_attn_bwd_dkv_smem_bytes(d)
             for d in (64, 128)})


def device_us(fn, frags, n=100):
    """Mean device microseconds a kernel whose name holds one of
    ``frags``, over ``n`` calls of ``fn`` under ``torch.profiler``.  Run it
    after a case's host timings: a profiled run can slow the host's later
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if any(f in ev.key for f in frags):
            total += ev.device_time_total
            count += ev.count
    require(count > 0, f"no device event named {frags} in the profile")
    return total / count


#: cycles of the device-side sleep ``device_queued_ms`` queues calls
#: behind: ~25 ms at the H100's 1980 MHz, longer than the host takes to
#: launch the calls
QUEUE_SLEEP_CYCLES = 50_000_000


def device_queued_ms(fn, n=50):
    """Mean device milliseconds a call of ``fn`` takes, its ``n`` calls
    queued behind a device-side sleep (``torch.cuda._sleep``) so that the
    card runs them back to back whatever the host's speed: CUDA events
    then time the device (each kernel and the gap before the next), not
    the host's launching.  No profiler: nothing lingers into later
    phases."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n=5000):
    """Host microseconds a call of ``fn`` (perf_counter, the best of
    three runs of ``n`` calls, the device drained between runs)."""
    import torch
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def in_turns(calls, rounds=3):
    """``time_ms`` of each of ``calls`` (name: fn), the calls taken in
    turns ``rounds`` times over: the median of each (the host's speed
    drifts within a run)."""
    times = {k: [] for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            times[k].append(time_ms(fn))
    return {k: float(np.median(v)) for k, v in times.items()}


def _ln_tolerance(y, y_ref):
    """``(max abs err, ulps, tolerance)`` of K1's y against its plain
    version; raises past it (fp32 1e-5; bf16 / fp16 1 ulp, or 2**-16
    abs where the affine sum cancels)."""
    import torch
    from apex_tpu_torch.testing import BF16_CANCEL_ATOL, half_ulp_distance
    err = float((y.float() - y_ref.float()).abs().max())
    if y.dtype == torch.float32:
        require(torch.allclose(y, y_ref, atol=1e-5, rtol=1e-5),
                f"layer_norm_fwd fp32: max err {err}")
        return err, None, "atol=rtol=1e-5"
    ulps = half_ulp_distance(y, y_ref, BF16_CANCEL_ATOL)
    require(ulps <= 1, f"layer_norm_fwd {y.dtype}: {ulps} ulps")
    return err, ulps, "<= 1 ulp, or 2**-16 abs where the sum cancels"


def _ln_case(n1, dtype, rng, n2=768):
    """K1 at ``(n1, n2)`` against its plain version (bitwise repeats, the
    stats-free call bitwise the stats call); times in turns: ``ms`` the
    call as serving makes it (no statistics), ``stats_ms`` with them (a
    train forward), ``library_ms`` ``F.layer_norm``; the device's time a
    call of each (``device_queued_ms``)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import (layer_norm_fwd, layer_norm_fwd_ref,
                                         ln_fwd_route)
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((n1, n2), np.float32) * 2 + 0.3,
                        device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal(n2, np.float32),
                        device=dev).to(dtype)
    b = torch.as_tensor(rng.standard_normal(n2, np.float32),
                        device=dev).to(dtype)
    y, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
    again = layer_norm_fwd(x, w, b, 1e-5)
    bare = layer_norm_fwd(x, w, b, 1e-5, stats=False)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip((y, mean, inv), again))
            and torch.equal(y, bare[0]) and bare[1] is None,
            f"layer_norm_fwd {n1}x{n2}: runs, or the stats-free call, "
            f"differ")
    y_ref, mean_ref, inv_ref = layer_norm_fwd_ref(x, w, b, 1e-5)
    stat_err = max(float((mean - mean_ref).abs().max()),
                   float(((inv - inv_ref) / inv_ref).abs().max()))
    require(stat_err <= 1e-5, f"layer_norm_fwd stats off by {stat_err}")
    err, ulps, tol = _ln_tolerance(y, y_ref)
    t = in_turns({
        "ms": lambda: layer_norm_fwd(x, w, b, 1e-5, stats=False),
        "stats_ms": lambda: layer_norm_fwd(x, w, b, 1e-5),
        "library_ms": lambda: F.layer_norm(x, (n2,), w, b, 1e-5)})
    plain = time_ms(lambda: layer_norm_fwd_ref(x, w, b, 1e-5))
    isz = x.element_size()
    nbytes = 2 * n1 * n2 * isz + 2 * n2 * w.element_size() + 8 * n1
    b_ms, b_by = bound(nbytes, 8.0 * n1 * n2, PEAK_FP32_FLOPS)
    dev_ms = device_queued_ms(lambda: layer_norm_fwd(x, w, b, 1e-5))
    lib_dev_ms = device_queued_ms(lambda: F.layer_norm(x, (n2,), w, b, 1e-5))
    rec = dict(kernel="layer_norm_fwd", n1=n1, n2=n2,
               dtype=str(dtype).split(".")[-1],
               route=ln_fwd_route(n1, n2, dtype), max_abs_err=err, ulps=ulps,
               tolerance=tol, ms=t["ms"], stats_ms=t["stats_ms"],
               plain_ms=plain, library_ms=t["library_ms"],
               device_ms=dev_ms, library_device_ms=lib_dev_ms,
               bound_ms=b_ms, bound_by=b_by, device_bound_share=b_ms / dev_ms)
    emit("kernels", **rec)
    return rec


#: K1's routes as ``ln_fwd_route`` names them
LN_ROUTES = ("warp_vec", "warp_scalar", "block_vec", "block_scalar",
             "loop_vec", "loop_scalar")


def _ln_routes(rng):
    """Every K1 route that takes a shape, in every dtype pair (x fp32 /
    bf16 / fp16, w fp32 or x's), with and without the affine, at a few
    shapes (a ragged width, rows wider than a warp or a block holds), the
    scalar routes also on a view at an odd element offset: each against
    the plain version within K1's tolerance, repeating bitwise, the
    stats-free call bitwise the stats call, and the vector and scalar
    forms of one route bitwise equal (the same sums in the same
    order)."""
    import torch
    from apex_tpu_torch.ops.cuda import layer_norm_fwd, layer_norm_fwd_ref
    from apex_tpu_torch.ops.cuda.layer_norm import (BLOCK_GROUPS_MAX,
                                                    WARP_GROUPS_MAX)
    dev = torch.device("cuda")
    pairs = [(torch.float32, torch.float32),
             (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
             (torch.float16, torch.float32)]
    checked, worst = {r: 0 for r in LN_ROUTES}, {}
    for xdt, wdt in pairs:
        per = 16 // xdt.itemsize
        for n1, n2 in ((8, 768), (300, 1024), (37, 770), (5, 4096),
                       (3, 20000)):
            groups = -(-n2 // per)
            outs = {}
            for route in LN_ROUTES:
                kind, access = route.split("_")
                if (kind == "warp" and groups > WARP_GROUPS_MAX) or (
                        kind == "block" and groups > BLOCK_GROUPS_MAX) or (
                        access == "vec" and n2 % per):
                    continue
                for affine in (True, False):
                    for offset in ((0, 1) if access == "scalar" else (0,)):
                        base = torch.as_tensor(
                            rng.standard_normal(n1 * n2 + offset,
                                                np.float32) * 2 + 0.3,
                            device=dev).to(xdt)
                        x = base[offset:].view(n1, n2)
                        w = b = None
                        if affine:
                            w, b = (torch.as_tensor(rng.standard_normal(
                                n2, np.float32), device=dev).to(wdt)
                                for _ in range(2))
                        got = layer_norm_fwd(x, w, b, 1e-5, route=route)
                        again = layer_norm_fwd(x, w, b, 1e-5, route=route)
                        bare = layer_norm_fwd(x, w, b, 1e-5, stats=False,
                                              route=route)[0]
                        torch.cuda.synchronize()
                        what = f"{route} {xdt}/{wdt} {n1}x{n2} off {offset}"
                        require(all(torch.equal(a, c) for a, c in
                                    zip(got, again))
                                and torch.equal(got[0], bare),
                                f"layer_norm_fwd {what}: runs differ")
                        ref = layer_norm_fwd_ref(x, w, b, 1e-5)
                        require(float((got[1] - ref[1]).abs().max()) <= 1e-5
                                and float(((got[2] - ref[2]) / ref[2]).abs()
                                          .max()) <= 1e-5,
                                f"layer_norm_fwd {what}: stats")
                        err, _, _ = _ln_tolerance(got[0], ref[0])
                        worst[str(xdt).split(".")[-1]] = max(
                            worst.get(str(xdt).split(".")[-1], 0.0), err)
                        checked[route] += 1
                        if affine and offset == 0:
                            outs[route] = (x.clone(), w, b, got[0])
            for kind in ("warp", "block", "loop"):
                if f"{kind}_vec" in outs:
                    x, w, b, yv = outs[f"{kind}_vec"]
                    ys = layer_norm_fwd(x, w, b, 1e-5,
                                        route=f"{kind}_scalar")[0]
                    require(torch.equal(yv, ys),
                            f"layer_norm_fwd {kind} vec != scalar at "
                            f"{n1}x{n2} {xdt}")
    rec = dict(kernel="layer_norm_fwd", case="routes", checked=checked,
               max_abs_err_by_dtype=worst,
               tolerance="fp32 1e-5; bf16 / fp16 <= 1 ulp (2**-16 abs "
                         "where the sum cancels); bitwise repeats; vec == "
                         "scalar bitwise")
    emit("kernels", **rec)
    return rec


def _ln_crossover():
    """K1's device microseconds on the warp and the block route by row
    count (768 and 1024 bf16 rows): where ``BLOCK_ROWS_MAX`` belongs."""
    import torch
    from apex_tpu_torch.ops.cuda import layer_norm_fwd
    from apex_tpu_torch.ops.cuda.layer_norm import BLOCK_ROWS_MAX
    dev = torch.device("cuda")
    table = {}
    for n2 in (768, 1024):
        for n1 in (8, 64, 256, 512, 1024, 2048, 4096, 16384):
            x = torch.randn(n1, n2, device=dev).to(torch.bfloat16)
            w, b = (torch.randn(n2, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            table[f"{n1}x{n2}"] = {r: 1e3 * device_queued_ms(
                lambda: layer_norm_fwd(x, w, b, 1e-5, route=r))
                for r in ("warp_vec", "block_vec")}
    rec = dict(kernel="layer_norm_fwd", case="crossover",
               device_us_by_route=table, block_rows_max=BLOCK_ROWS_MAX)
    emit("kernels", **rec)
    return rec


def _fwd_launch_ms(q, k, v, kw, scale=None):
    """The Hopper forward's launch alone, on operands prepared once (the
    maps encoded, k^ written): the kernel's time without the host work
    and the prologue of a call."""
    from apex_tpu_torch.ops.cuda import flash_attention as fa
    ops = fa._fwd_operands("timing", q, k, v, kw.get("kv_mask"),
                           kw.get("causal", False), scale, kw.get("rope"))
    return time_ms(lambda: fa._fwd_launch(ops, True))


def _flash_case(shape, rng, masked=False, causal=True, dtype="bfloat16"):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import flash_attn_fwd, flash_attn_fwd_ref
    bsz, l, h, d = shape
    dev = torch.device("cuda")
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(getattr(torch, dtype))
               for _ in range(3))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.random((bsz, l)) > 0.25, device=dev)
        mask[:, 0] = True
    o, lse = flash_attn_fwd(q, k, v, causal=causal, kv_mask=mask,
                            return_lse=True)
    again = flash_attn_fwd(q, k, v, causal=causal, kv_mask=mask,
                           return_lse=True)
    torch.cuda.synchronize()
    require(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
            f"flash_attn_fwd {shape}: two runs differ")
    o_ref, lse_ref = flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                        causal=causal, kv_mask=mask)
    err = float((o.float() - o_ref).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    require(err <= 2e-2 and lse_err <= 2e-2,
            f"flash_attn_fwd {shape} masked={masked}: o err {err}, "
            f"lse err {lse_err}")
    kw = dict(causal=causal, kv_mask=mask)
    ms = _fwd_launch_ms(q, k, v, kw)
    call = time_ms(lambda: flash_attn_fwd(q, k, v, **kw))
    plain = time_ms(lambda: flash_attn_fwd_ref(q, k, v, causal=causal,
                                               kv_mask=mask))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if masked:
        am = mask[:, None, None, :]
        if causal:
            am = am & torch.ones(l, l, dtype=torch.bool, device=dev).tril()
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am))
    else:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
    pairs = _flash_pairs(bsz, l, h, causal, mask)
    nbytes = 4 * bsz * l * h * d * q.element_size() + (bsz * l if masked
                                                        else 0)
    b_ms, b_by = bound(nbytes, 4.0 * d * pairs, PEAK_BF16_FLOPS)
    rec = dict(kernel="flash_attn_fwd", shape=list(shape), causal=causal,
               kv_mask=masked, dtype=dtype, max_abs_err=err,
               lse_err=lse_err, tolerance="atol 2e-2 vs plain in fp32",
               bitwise_repeat=True, ms=ms, call_ms=call, plain_ms=plain,
               library_ms=lib, bound_ms=b_ms, bound_by=b_by,
               bound_share=b_ms / ms)
    emit("kernels", **rec)
    return rec


def phase_kernels(solo_lengths):
    import torch
    rng = np.random.default_rng(0)
    ln = [_ln_case(n1, dt, rng) for dt in (torch.bfloat16, torch.float32)
          for n1 in (1, 8, 16, 64, 2048, 8192)]
    # the training shapes (gpt_small's and bert_large's rows of a step),
    # and decode in fp16
    ln += [_ln_case(16384, torch.bfloat16, rng, n2=n2) for n2 in (768, 1024)]
    ln.append(_ln_case(8, torch.float16, rng))
    ln_extra = {"routes": _ln_routes(rng), "crossover": _ln_crossover()}
    shapes = [(1, 512, 12, 64), (4, 1024, 12, 64), (1, 2048, 12, 64),
              (2, 1000, 6, 128)] + [(1, l, 12, 64) for l in solo_lengths]
    fl = [_flash_case(s, rng) for s in shapes]
    fl.append(_flash_case((2, 512, 12, 64), rng, masked=True))
    return ln, fl, ln_extra


def gpt_small_tree(cfg, seed: int):
    """A JAX-layout parameter tree of numpy fp32 arrays, initialised as
    the flax model initialises (kernels N(0, 1/fan_in), embedding
    N(0, 1/hidden), biases 0, layer-norm scales 1)."""
    rng = np.random.default_rng(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def dense(i, o, bias=True):
        d = {"kernel": rng.standard_normal((i, o), np.float32) * i ** -0.5}
        if bias:
            d["bias"] = np.zeros(o, np.float32)
        return d

    def ln():
        return {"scale": np.ones(e, np.float32),
                "bias": np.zeros(e, np.float32)}
    tree = {"tok_emb": {"embedding": rng.standard_normal(
        (v, e), np.float32) * e ** -0.5}}
    for i in range(cfg.num_layers):
        tree[f"block_{i}"] = {
            "ln1": ln(), "ln2": ln(),
            "attention": {"qkv": dense(e, 3 * e), "out": dense(e, e)},
            "ffn_in": dense(e, f), "ffn_out": dense(f, e)}
    tree["ln_f"] = ln()
    tree["lm_head"] = dense(e, v, bias=False)
    return tree


def margins_of(model, seq, lp):
    """Top-2 logit gap at each generated step of ``seq`` (full forward)."""
    import torch
    with torch.inference_mode():
        logits = model(torch.as_tensor(seq[None], device=model.device))
    top2 = logits[0, lp - 1:len(seq) - 1].float().topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def first_divergence(a, b):
    for t, (x, y) in enumerate(zip(a, b)):
        if int(x) != int(y):
            return t
    return None


@contextlib.contextmanager
def host_timed(spots):
    """Inside the block, each ``(module, name)`` of ``spots`` (a function)
    is timed on the host; yields ``{name: [ms, calls]}``, summed over the
    spots of one name."""
    spent, saved = {}, []
    for module, name in spots:
        orig = getattr(module, name)
        saved.append((module, name, orig))
        acc = spent.setdefault(name, [0.0, 0])

        def timed(*args, _orig=orig, _acc=acc, **kwargs):
            t0 = time.perf_counter()
            try:
                return _orig(*args, **kwargs)
            finally:
                _acc[0] += (time.perf_counter() - t0) * 1e3
                _acc[1] += 1
        setattr(module, name, timed)
    try:
        yield spent
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)


def profile_decode_step(model, cfg, seed=7):
    """One decode step of a full batch (8 slots, prompts of 64 tokens)
    under ``torch.profiler`` (device ms by group, busy share), after one
    unprofiled decode step whose host ms in K1's calls
    (``layer_norm_fwd``) and in the whole layer-norm calls of the step
    (``fused_layer_norm_affine``: the checks and reshapes around K1) are
    timed.  Both are plain decode steps: every request was admitted and
    prefilled before."""
    import importlib

    import torch
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    # the modules (the packages export functions of the same names)
    gen_mod = importlib.import_module("apex_tpu_torch.models.generate")
    fln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    scfg = ServeConfig(num_slots=8, block_size=16, max_blocks_per_slot=64,
                       num_blocks=8 * 64 + 1, prefill_chunk=64)
    eng = ServeEngine(model, cfg, scfg)
    rng = np.random.default_rng(seed)
    for i in range(scfg.num_slots):
        eng.submit(Request(uid=f"p{i}", prompt=rng.integers(
            0, cfg.vocab_size, 64), max_new_tokens=32))
    for _ in range(3):           # admit and prefill, then decode steps
        eng.step()
    require(eng.sched.n_active() == scfg.num_slots and not eng.sched.queue,
            "decode profile: not every slot decoding")
    torch.cuda.synchronize()
    spots = [(fln, "layer_norm_fwd"), (fln, "fused_layer_norm_affine"),
             (gen_mod, "fused_layer_norm_affine")]
    with host_timed(spots) as spent:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof = profile_step(eng.step)
    return dict(slots=scfg.num_slots, timed_step_wall_ms=wall,
                k1_calls=spent["layer_norm_fwd"][1],
                k1_host_ms=spent["layer_norm_fwd"][0],
                layer_norm_calls=spent["fused_layer_norm_affine"][1],
                layer_norm_host_ms=spent["fused_layer_norm_affine"][0],
                profile=prof)


def phase_serve_profile(cfg):
    """One profiled decode step of gpt_small (bf16 weights from its seeded
    tree), made last, after every timed phase: ``torch.profiler`` can
    slow the host's later calls, and a parent tree's run has no such
    session before its timed phases."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    model = params_from_jax(gpt_small_tree(cfg, seed=0), cfg,
                            dtype=torch.bfloat16)
    decode = profile_decode_step(model, cfg)
    emit("serve_profile", model="gpt_small", dtype="bfloat16",
         decode_step=decode)
    del model
    torch.cuda.empty_cache()
    return decode


def phase_serve(model, cfg, requests):
    import torch
    from apex_tpu_torch.obs import Registry
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    scfg = ServeConfig(num_slots=8, block_size=16, max_blocks_per_slot=64,
                       num_blocks=8 * 64 + 1, prefill_chunk=64)
    reg = Registry()
    eng = ServeEngine(model, cfg, scfg, registry=reg)
    for uid, prompt, n in requests:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    chunks = int(reg.counter("serve_prefill_chunks_total").value)
    per_pass = 2 * cfg.num_layers + 1
    require(len(out) == len(requests), "not every request finished")
    for uid, prompt, n in requests:
        toks = out[uid]
        require(toks.shape == (n,) and toks.min() >= 0
                and toks.max() < cfg.vocab_size,
                f"{uid}: bad output {toks.shape}")
    require(counts["layer_norm_fwd"] >= per_pass * eng.steps,
            f"layer_norm_fwd launched {counts['layer_norm_fwd']} times in "
            f"{eng.steps} decode steps")
    require(counts["layer_norm_fwd"] == per_pass * (eng.steps + chunks),
            "layer_norm_fwd launches != (2 x layers + 1) x (decode steps "
            "+ prefill chunks)")
    h = reg.histogram("serve_decode_step_seconds")
    generated = int(reg.counter("serve_tokens_total").value)
    emit("serve", model="gpt_small", dtype="bfloat16", requests=len(out),
         generated_tokens=generated, wall_s=wall,
         tokens_per_s=generated / wall, decode_steps=eng.steps,
         prefill_chunks=chunks,
         decode_step_p50_ms=h.quantile(0.5) * 1e3,
         decode_step_p99_ms=h.quantile(0.99) * 1e3,
         launches=counts,
         layer_norm_launches_per_decode_step=per_pass,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out, counts


def phase_solo(model, cfg, requests, engine_out):
    import torch
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    total = {"layer_norm_fwd": 0, "flash_attn_fwd": 0}
    agree, compared, rows = 0, 0, []
    for uid, prompt, n in requests:
        reset_launch_counts()
        seq = generate(model, cfg, prompt[None], n)[0].cpu().numpy()
        torch.cuda.synchronize()
        counts = launch_counts()
        require(counts["flash_attn_fwd"] == cfg.num_layers,
                f"{uid}: flash_attn_fwd launched "
                f"{counts['flash_attn_fwd']} times, want {cfg.num_layers}")
        for k in total:
            total[k] += counts[k]
        solo, eng = seq[len(prompt):], engine_out[uid]
        t = first_divergence(solo, eng)
        margin = None
        if t is not None:
            margin = float(margins_of(model, seq, len(prompt))[t])
            require(margin <= NEAR_TIE_BF16,
                    f"{uid}: engine and solo differ at step {t} with "
                    f"top-2 margin {margin} > {NEAR_TIE_BF16}")
        same = n if t is None else t
        agree += same
        compared += n
        rows.append(dict(uid=uid, prompt_len=len(prompt), new=n,
                         equal_prefix=same, near_tie_margin=margin))
    emit("solo", calls=len(requests), launches=total,
         flash_launches_per_call=cfg.num_layers,
         tokens_equal_before_first_near_tie=agree, tokens_compared=compared,
         near_tie_rule=f"divergence only at top-2 margin <= "
                       f"{NEAR_TIE_BF16} (bf16 logits)", requests=rows)
    return total


def phase_reference(tree, cfg):
    """fp32, small input: the card (kernels) against the CPU (the plain
    versions) — greedy tokens under the 1e-3 near-tie rule, and the
    full-sequence logits."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    from apex_tpu_torch.obs import Registry
    gpu = params_from_jax(tree, cfg)
    cpu = params_from_jax(tree, cfg, device="cpu")
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 48)
    n = 16
    ref = generate(cpu, cfg, prompt[None], n, device="cpu")[0].numpy()
    got = generate(gpu, cfg, prompt[None], n)[0].cpu().numpy()
    eng = ServeEngine(gpu, cfg, ServeConfig(num_slots=2, block_size=16,
                                            num_blocks=9,
                                            max_blocks_per_slot=4,
                                            prefill_chunk=32),
                      registry=Registry())
    eng.submit(Request(uid="ref", prompt=prompt, max_new_tokens=n))
    served = eng.run()["ref"]
    margins = margins_of(cpu, ref, len(prompt))
    for name, toks in (("solo", got[len(prompt):]), ("engine", served)):
        t = first_divergence(toks, ref[len(prompt):])
        require(t is None or margins[t] <= NEAR_TIE_FP32,
                f"fp32 {name} on the card differs from the CPU at step "
                f"{t} (margin {None if t is None else margins[t]})")
    with torch.inference_mode():
        lg = gpu(torch.as_tensor(ref[None], device="cuda")).cpu()
        lc = cpu(torch.as_tensor(ref[None]))
    err = float((lg - lc).abs().max())
    require(err <= 2e-3, f"fp32 logits card vs CPU differ by {err}")
    emit("reference", dtype="float32", prompt_len=len(prompt), new=n,
         solo_equal=bool((got == ref).all()),
         engine_equal=bool((served == ref[len(prompt):]).all()),
         logits_max_abs_err=err, logits_tolerance=2e-3)


# -- the training slice ---------------------------------------------------

#: bf16 results against their plain version in the same dtype: within 2
#: bf16 ulps of the largest element (both sides compute in fp32 and round
#: to bf16 at the end, but sum in another order)
def bf16_tol(ref) -> float:
    return 2 * 2.0 ** -8 * max(1.0, float(ref.float().abs().max()))


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


#: the scale-aware check beside ``bf16_tol``, for results whose rows span
#: orders of magnitude (causal attention at long L): each row's (last
#: dim's) max error within 2**-6 of that row's max |ref| (two bf16 ulps of
#: it at most: a rounding flip at the store, one more at dq's bf16
#: scale), and ||err|| / ||ref|| within 1e-2 over the whole tensor.  A
#: row whose max |ref| is under 1% of the median non-zero row's is held to
#: that 1% instead (dq's first query row is pure cancellation: P = 1, dP =
#: delta); a row whose ref is zero must be zero
ROW_REL_TOL = 2.0 ** -6
NORM_REL_TOL = 1e-2
ROW_FLOOR = 1e-2


def scaled_errs(what: str, got, ref) -> dict:
    """``got`` against ``ref`` by the row and norm checks above; fails the
    run past either limit, else returns both errors and their limits."""
    import torch
    err = got.float() - ref.float()
    row_ref = ref.float().abs().amax(dim=-1)
    live = row_ref[row_ref > 0]
    floor = max(ROW_FLOOR * float(live.median()) if live.numel() else 0.0,
                torch.finfo(torch.float32).tiny)
    row = float((err.abs().amax(dim=-1)
                 / torch.clamp(row_ref, min=floor)).max())
    norm = float(err.norm() / ref.float().norm())
    require(row <= ROW_REL_TOL and norm <= NORM_REL_TOL,
            f"{what}: row-relative error {row} (limit {ROW_REL_TOL}), "
            f"norm-relative error {norm} (limit {NORM_REL_TOL})")
    return dict(row_rel_err=row, row_rel_tol=ROW_REL_TOL, norm_rel_err=norm,
                norm_rel_tol=NORM_REL_TOL)


#: fp32 scores one plain-version call may hold at once
PLAIN_SCORES = 1 << 28


def _plain_by_heads(fn, args, kw):
    """A plain attention function ``fn(*args, **kw)`` whose ``args`` are
    ``(B, L, H, ...)`` tensors, run over slices of heads so that at most
    ``PLAIN_SCORES`` fp32 scores exist at once; every head is computed,
    the results concatenated along the heads."""
    import torch
    b, l, h = args[0].shape[:3]
    step = max(1, min(h, PLAIN_SCORES // (b * l * l)))
    parts = [fn(*(t[:, :, h0:h0 + step] for t in args), **kw)
             for h0 in range(0, h, step)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=2) for p in zip(*parts))
    return torch.cat(parts, dim=2)


def _kernel_rec(**rec):
    emit("kernels", **rec)
    return rec


def _tables(b, l, d, dtype):
    import torch
    from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables
    pos = torch.arange(l, device="cuda")[None].expand(b, l)
    cos, sin = rope_tables(pos, d, 10000.0)
    return tuple(rope_kernel_tables(cos, sin, b, l, d, dtype))


def _ln_bwd_case(n1, n2, dtype, rng):
    """K3 against its plain version at one shape: the route
    ``ln_bwd_route`` picks (on a tree that has it), launches a call, two
    runs equal bit for bit, kernel / plain / ``native_layer_norm_backward``
    times, the kernel's and the library call's device times (calls queued
    behind a device-side sleep) and the bytes bound."""
    import torch
    from apex_tpu_torch.ops.cuda import (layer_norm_bwd, layer_norm_bwd_ref,
                                         layer_norm_fwd)
    from apex_tpu_torch.ops.cuda import layer_norm as ln_mod
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((n1, n2), np.float32) * 2 + 0.3,
                        device=dev).to(dtype)
    dy = torch.as_tensor(rng.standard_normal((n1, n2), np.float32),
                         device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal(n2, np.float32),
                        device=dev).to(dtype)
    b = torch.zeros_like(w)
    _, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
    before = layer_norm_bwd.launches
    got = layer_norm_bwd(dy, x, w, mean, inv)
    launches = layer_norm_bwd.launches - before
    again = layer_norm_bwd(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"layer_norm_bwd {n1}x{n2} {dtype}: two runs differ")
    ref = layer_norm_bwd_ref(dy, x, w, mean, inv)
    errs = [_max_err(a, r) for a, r in zip(got, ref)]
    if dtype == torch.float32:
        tol = "dx atol 1e-5; dw, db rtol 1e-5 + atol 1e-4 (row sums)"
        ok = errs[0] <= 1e-5 and all(
            torch.allclose(a, r, rtol=1e-5, atol=1e-4)
            for a, r in zip(got[1:], ref[1:]))
    else:
        tol = "2 bf16 ulps of the largest element"
        ok = all(e <= bf16_tol(r) for e, r in zip(errs, ref))
    require(ok, f"layer_norm_bwd {n1}x{n2} {dtype}: errors {errs}")
    route = parts = None
    if hasattr(ln_mod, "ln_bwd_route"):   # a parent tree may lack it
        aligned = all(t.data_ptr() % 16 == 0 for t in (dy, x, w))
        route = ln_mod.ln_bwd_route(n1, n2, dtype, aligned)
        from apex_tpu_torch.ops.cuda import build
        parts = build.library().apex_layer_norm_bwd_parts(
            n1, n2, ln_mod._bwd_mode(n1, n2, dtype, ln_mod._DTYPES[w.dtype],
                                     aligned))
    ms = time_ms(lambda: layer_norm_bwd(dy, x, w, mean, inv))
    plain = time_ms(lambda: layer_norm_bwd_ref(dy, x, w, mean, inv))
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [n2], w, b, 1e-5)

    def library():
        return torch.ops.aten.native_layer_norm_backward(
            dy, x, [n2], lmean, lrstd, w, b, [True, True, True])
    lib = time_ms(library)
    # the device's time a call, whatever the host's speed late in a long
    # process (``ms`` above times back-to-back calls from the host)
    dev = device_queued_ms(lambda: layer_norm_bwd(dy, x, w, mean, inv))
    lib_dev = device_queued_ms(library)
    isz, wsz = x.element_size(), w.element_size()
    nbytes = 3 * n1 * n2 * isz + 8 * n1 + 3 * n2 * wsz
    b_ms, b_by = bound(nbytes, 14.0 * n1 * n2, PEAK_FP32_FLOPS)
    return _kernel_rec(kernel="layer_norm_bwd", n1=n1, n2=n2,
                       dtype=str(dtype).split(".")[-1], route=route,
                       partial_rows=parts, launches_a_call=launches,
                       max_abs_err=max(errs), errs_dx_dw_db=errs,
                       tolerance=tol, bitwise_repeat=True, ms=ms,
                       plain_ms=plain, library_ms=lib, device_ms=dev,
                       library_device_ms=lib_dev, bound_ms=b_ms,
                       bound_by=b_by, bound_share=b_ms / ms,
                       device_bound_share=b_ms / dev)


def _flash_pairs(b, l, h, causal, mask):
    if mask is not None:
        import torch
        vis = mask[:, None, :].expand(b, l, l)
        if causal:
            vis = vis & torch.ones(l, l, dtype=torch.bool,
                                   device=mask.device).tril()
        return float(vis.sum()) * h
    return b * h * (l * (l + 1) / 2 if causal else l * l)


def _planes_bytes(bsz, l, h, d, causal):
    """The dq partial plane bytes K4 writes (and the finish pass reads)
    for these inputs: under causality only the rows a plane's 64 keys
    reach."""
    n = -(-l // 64)
    rows = sum(l - 64 * j for j in range(n)) if causal else n * l
    return rows * bsz * h * d * 4


def _finish_case(ops, planes, shape, causal, tables, dtype):
    """The finish pass on K4's own planes, bitwise against its plain
    version, with its time and byte bound."""
    import torch
    from apex_tpu_torch.ops.cuda import flash_bwd_finish_ref
    from apex_tpu_torch.ops.cuda.flash_attention import _finish
    bsz, l, h, d = shape

    def run():
        return _finish(planes, ops.cos_t, ops.sin_t, ops.scale_q,
                       ops.causal, dtype, ops.stream)

    def plain():
        return flash_bwd_finish_ref(planes, causal=causal, rope=tables,
                                    scale=1.0 / d ** 0.5, dtype=dtype)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    require(torch.equal(got, ref), f"flash_bwd_finish {shape}: differs "
                                   f"from its plain version")
    nbytes = (_planes_bytes(bsz, l, h, d, causal) + bsz * l * h * d * 2
              + (2 * bsz * l * d * 2 if tables is not None else 0))
    b_ms, b_by = bound(nbytes, 0.0, PEAK_BF16_FLOPS)
    return dict(kernel="flash_bwd_finish", shape=list(shape), causal=causal,
                rope=tables is not None, dtype=str(dtype).split(".")[-1],
                max_abs_err=0.0, tolerance="bitwise", ms=time_ms(run),
                plain_ms=time_ms(plain, budget_s=0.2), bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                library_null_reason="no PyTorch call sums the planes, "
                                    "inverse-rotates and scales")


@fused_budget(FUSED_ALWAYS)
def _flash_bwd_case(shape, rng, causal=True, masked=False, rope=True,
                    dtype="bfloat16"):
    """K4, the fused backward (the budget raised so that every shape takes
    it), against its plain version (run over slices of heads, every head
    compared) within 2 ulps (bf16's) of the largest gradient and the row
    and norm limits, twice for equal bits; its finish pass bitwise
    against the finish's plain version.  ``ms`` times the public call
    whole (the q^ / k^ prologue, delta, K4 and the finish pass),
    ``launch_ms`` K4's launch on prepared
    operands, ``finish_ms`` the finish pass; the bound counts the call's
    own operands and outputs beside 10 D flops a visible pair (the planes
    are the design's, and count in the finish pass's own bound)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import (attn_delta, flash_attn_bwd,
                                         flash_attn_bwd_ref, flash_attn_fwd)
    from apex_tpu_torch.ops.cuda.flash_attention import (_bwd_operands,
                                                         _fused_launch)
    bsz, l, h, d = shape
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                                   device=dev).to(dt)
                   for _ in range(4))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.random((bsz, l)) > 0.25, device=dev)
        mask[:, 0] = True
    tables = _tables(bsz, l, d, dt) if rope else None
    kw = dict(causal=causal, kv_mask=mask, rope=tables)
    o, lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
    got = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    require(same, f"flash_attn_bwd {shape}: two runs differ")
    del again
    ref = _plain_by_heads(flash_attn_bwd_ref, (q, k, v, o, lse, do), kw)
    errs = [_max_err(a, r) for a, r in zip(got, ref)]
    require(all(e <= bf16_tol(r) for e, r in zip(errs, ref)),
            f"flash_attn_bwd {shape} masked={masked}: errors {errs}")
    scaled = [scaled_errs(f"flash_attn_bwd {shape} d{n}", a, r)
              for n, a, r in zip("qkv", got, ref)]
    del ref, got
    ops = _bwd_operands("K4 case", q, k, v, do, lse, attn_delta(o, do, None),
                        causal, mask, None, tables)
    launch_ms = time_ms(lambda: _fused_launch(ops, flash_attn_bwd))
    planes = _fused_launch(ops, flash_attn_bwd)[0]
    fin = _finish_case(ops, planes, shape, causal, tables, dt)
    del ops, planes
    ms = time_ms(lambda: flash_attn_bwd(q, k, v, o, lse, do, **kw))
    plain = time_ms(lambda: _plain_by_heads(
        flash_attn_bwd_ref, (q, k, v, o, lse, do), kw), budget_s=0.2)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if masked:
        am = torch.ones(l, l, dtype=torch.bool, device=dev).tril() \
            if causal else torch.ones(l, l, dtype=torch.bool, device=dev)
        am = am[None, None] & mask[:, None, None, :]
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    else:
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                              retain_graph=True))
    del ot, qt, kt, vt
    pairs = _flash_pairs(bsz, l, h, causal, mask)
    one = bsz * l * h * d * 2
    # q, k, v, o, do read, dq, dk, dv written; lse (and dlse's delta) and
    # the tables and mask read
    nbytes = (8 * one + 4 * bsz * l * h
              + (2 * bsz * l * d * 2 if rope else 0)
              + (bsz * l if masked else 0))
    b_ms, b_by = bound(nbytes, 10.0 * d * pairs, PEAK_BF16_FLOPS)
    rec = _kernel_rec(kernel="flash_attn_bwd", shape=list(shape),
                      causal=causal, kv_mask=masked, rope=rope, dtype=dtype,
                      max_abs_err=max(errs), errs_dq_dk_dv=errs,
                      **{k_: max(x[k_] for x in scaled) for k_ in scaled[0]},
                      tolerance="2 bf16 ulps of the largest gradient vs "
                                "the plain version in the same dtype, and "
                                "the row and norm limits",
                      bitwise_repeat=same, ms=ms, launch_ms=launch_ms,
                      finish_ms=fin["ms"],
                      plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                      bound_by=b_by, bound_share=b_ms / ms,
                      planes_bytes=_planes_bytes(bsz, l, h, d, causal))
    emit("kernels", **fin)
    return rec, fin


def _flash_rope_case(shape, rng):
    """K2, causal with rope, against its plain version (run over slices of
    heads, every head compared) by the absolute and the scale-aware
    checks, twice for equal bits, with times and the bound: the launch on
    prepared operands (``ms``), the public call with its k^ prologue
    (``call_ms``), the prologue alone, and the other split measured
    beside it: the full prologue writing q^ and k^, then K2 with no q
    preparation (``full_prologue_call_ms``), whose output must equal the
    default's bit for bit (the same q^ arithmetic, in the prologue or in
    shared memory)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import (flash_attn_fwd, flash_attn_fwd_ref,
                                         flash_bwd_prologue,
                                         flash_fwd_prologue)
    bsz, l, h, d = shape
    dev = torch.device("cuda")
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(torch.bfloat16)
               for _ in range(3))
    tables = _tables(bsz, l, d, torch.bfloat16)
    kw = dict(causal=True, rope=tables)
    o, lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
    again = flash_attn_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    require(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
            f"flash_attn_fwd rope {shape}: two runs differ")
    del again

    def full_prologue():
        qh, kh = flash_bwd_prologue(q, k, scale=d ** -0.5, rope=tables)
        return flash_attn_fwd(qh, kh, v, causal=True, scale=1.0,
                              return_lse=True)
    alt = full_prologue()
    require(torch.equal(o, alt[0]) and torch.equal(lse, alt[1]),
            f"flash_attn_fwd rope {shape}: q prepared in the kernel and by "
            f"the full prologue differ")
    del alt
    o_ref, lse_ref = _plain_by_heads(flash_attn_fwd_ref, (q, k, v), kw)
    err = _max_err(o, o_ref)
    lse_err = _max_err(lse, lse_ref)
    require(err <= 2e-2 and lse_err <= 2e-2,
            f"flash_attn_fwd rope {shape}: o err {err}, lse err {lse_err}")
    scaled = scaled_errs(f"flash_attn_fwd rope {shape} o", o, o_ref)
    del o_ref, lse_ref
    ms = _fwd_launch_ms(q, k, v, kw)
    call = time_ms(lambda: flash_attn_fwd(q, k, v, **kw))
    prologue = time_ms(lambda: flash_fwd_prologue(k, tables))
    full = time_ms(full_prologue)
    plain = time_ms(lambda: _plain_by_heads(flash_attn_fwd_ref, (q, k, v),
                                            kw), budget_s=0.2)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = bsz * h * l * (l + 1) / 2
    nbytes = 4 * bsz * l * h * d * 2 + 2 * bsz * l * d * 2
    b_ms, b_by = bound(nbytes, 4.0 * d * pairs, PEAK_BF16_FLOPS)
    return _kernel_rec(kernel="flash_attn_fwd", shape=list(shape),
                       causal=True, rope=True, dtype="bfloat16",
                       max_abs_err=err, lse_err=lse_err,
                       tolerance="atol 2e-2 vs plain in bf16 (same rounded "
                                 "q, k, tables), and the row and norm "
                                 "limits",
                       **scaled, bitwise_repeat=True,
                       equal_to_full_prologue_split=True,
                       plain="run over slices of heads (at most 2**28 fp32 "
                             "scores at once), every head compared",
                       ms=ms, call_ms=call, prologue_ms=prologue,
                       full_prologue_call_ms=full, plain_ms=plain,
                       library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / ms)


def _fwd_prologue_case(shape, rng):
    """K2's prologue (k^: k rotated, once a call) against its plain
    version, bitwise, twice for equal bits, with its time and the bound
    (bytes: k and the two tables read, k^ written)."""
    import torch
    from apex_tpu_torch.ops.cuda import (flash_fwd_prologue,
                                         flash_fwd_prologue_ref)
    bsz, l, h, d = shape
    k = torch.as_tensor(rng.standard_normal(shape, np.float32),
                        device="cuda").to(torch.bfloat16)
    tables = _tables(bsz, l, d, torch.bfloat16)
    got = flash_fwd_prologue(k, tables)
    again = flash_fwd_prologue(k, tables)
    want = flash_fwd_prologue_ref(k, tables)
    torch.cuda.synchronize()
    require(torch.equal(got, want) and torch.equal(got, again),
            f"flash_fwd_prologue {shape}: not bitwise its plain version")
    nbytes = 2 * bsz * l * h * d * 2 + 2 * bsz * l * d * 2
    b_ms, b_by = bound(nbytes, 6.0 * bsz * l * h * d, PEAK_FP32_FLOPS)
    return _kernel_rec(
        kernel="flash_fwd_prologue", shape=list(shape), dtype="bfloat16",
        max_abs_err=0.0, tolerance="bitwise", bitwise_repeat=True,
        ms=time_ms(lambda: flash_fwd_prologue(k, tables)),
        plain_ms=time_ms(lambda: flash_fwd_prologue_ref(k, tables)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_null_reason="no PyTorch call rotates by full-width "
                            "tables")


def _leaf_shapes(cfg):
    """The parameter shapes of ``cfg``'s model (GPT or BERT), in order."""
    from apex_tpu_torch.models import BertConfig, BertForPreTraining, \
        GPTModel
    cls = BertForPreTraining if isinstance(cfg, BertConfig) else GPTModel
    return [tuple(p.shape) for p in cls(cfg, device="meta").parameters()]


def _adam_case(cfg, rng):
    """K5 over ``cfg``'s leaves launched leaf by leaf and over one flat
    buffer of all their elements (FP16Optimizer's one launch a step),
    against its plain version: bitwise, the noop flag; timings of both
    forms."""
    import torch
    from apex_tpu_torch.ops.cuda import packed_adam, packed_adam_ref
    dev = torch.device("cuda")
    shapes = _leaf_shapes(cfg)
    n = sum(int(np.prod(s)) for s in shapes)

    def leaves(scale, absval=False):
        out = []
        for s in shapes:
            a = rng.standard_normal(s, np.float32) * scale
            out.append(torch.as_tensor(np.abs(a) if absval else a,
                                       device=dev))
        return out
    p, m, v, g = leaves(0.05), leaves(1e-3), leaves(1e-4, True), leaves(1e-2)
    copies = [torch.empty_like(t, dtype=torch.bfloat16) for t in p]
    sizes = torch.full((len(shapes),), 3e-4, device=dev)
    scale = torch.ones(1, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    twins = [[t.clone() for t in ts] for ts in (p, m, v, copies)]

    def run(fn, ps, ms_, vs, cs):
        for i in range(len(shapes)):
            fn(ps[i], ms_[i], vs[i], g[i], sizes[i:i + 1], scale, flag,
               p_copy=cs[i], **kw)
    run(packed_adam, p, m, v, copies)
    run(packed_adam_ref, *twins)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for xs, ys in zip((p, m, v, copies), twins)
                for a, b in zip(xs, ys))
    err = max(_max_err(a, b) for a, b in zip(p, twins[0]))
    require(equal, f"packed_adam differs from its plain version ({err})")
    del twins
    flag.fill_(1)
    before = [t.clone() for t in p[:4]]
    run(packed_adam, p, m, v, copies)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(p, before)),
            "packed_adam wrote with the noop flag set")
    flag.zero_()
    ms148 = time_ms(lambda: run(packed_adam, p, m, v, copies))
    # the flat form: one launch over every element, as FP16Optimizer runs
    flat = [torch.cat([t.reshape(-1) for t in ts]) for ts in (p, m, v, g)]
    fc = torch.empty(n, dtype=torch.bfloat16, device=dev)
    twin = [t.clone() for t in flat[:3]] + [fc.clone()]
    packed_adam(*flat, sizes[:1], scale, flag, p_copy=fc, **kw)
    packed_adam_ref(*twin[:3], flat[3], sizes[:1], scale, flag,
                    p_copy=twin[3], **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(flat[:3] + [fc], twin)),
            "packed_adam over the flat buffer differs from its plain "
            "version")
    del twin
    ms = time_ms(lambda: packed_adam(*flat, sizes[:1], scale, flag,
                                     p_copy=fc, **kw))
    plain = time_ms(lambda: packed_adam_ref(*flat, sizes[:1], scale, flag,
                                            p_copy=fc, **kw))
    lp = [flat[0].clone().requires_grad_()]
    lp[0].grad = flat[3]
    opt = torch.optim.Adam(lp, lr=3e-4, fused=True)
    lib = time_ms(opt.step)
    del lp, opt, flat, fc
    b_ms, b_by = bound(30.0 * n, 15.0 * n, PEAK_FP32_FLOPS)
    return _kernel_rec(kernel="packed_adam", leaves=len(shapes), elements=n,
                       shape=f"one flat buffer of {n} elements",
                       p_copy="bfloat16", max_abs_err=err,
                       tolerance="bitwise equal to the plain version",
                       noop_flag_skips=True, ms=ms, plain_ms=plain,
                       library_ms=lib, library_call="torch.optim.Adam("
                       "fused=True).step() over the flat tensor",
                       ms_148_launches_one_a_leaf=ms148, bound_ms=b_ms,
                       bound_by=b_by, per="one FP16Optimizer step (one "
                       "launch over the flat buffer)")


def _scale_case(shapes, rng, in_place=False, dtypes=None):
    """K6 over one gradient per shape of ``shapes`` (a model's leaves),
    one launch over their chunk table, against its plain version:
    bitwise, clean, with one inf leaf, then with one nan leaf; timings.
    By default bf16 -> fp32 into kept buffers (amp's unscale of a step's
    gradients; ``dtypes``: each leaf's gradient dtype, for a model whose
    O2 keeps some leaves fp32: still one launch); ``in_place``: fp32
    over itself (``out`` aliasing ``x``), the function of PyTorch's own
    ``torch._amp_foreach_non_finite_check_and_unscale_``."""
    import torch
    from apex_tpu_torch.ops.cuda import packed_scale, packed_scale_ref
    from apex_tpu_torch.ops.multi_tensor import ChunkTable
    dev = torch.device("cuda")
    n = sum(int(np.prod(s)) for s in shapes)
    dt = torch.float32 if in_place else torch.bfloat16
    dtypes = dtypes or [dt] * len(shapes)
    grads = [torch.as_tensor(rng.standard_normal(s, np.float32) * 1e3,
                             device=dev).to(d) for s, d in zip(shapes, dtypes)]
    table = ChunkTable.of(grads)
    inv = torch.full((1,), 2.0 ** -16, device=dev)
    results = {}
    for bad in (None, "inf", "nan"):
        if bad:
            grads[5].view(-1)[17] = float(bad)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        flag_ref = torch.zeros_like(flag)
        if in_place:
            outs = [g.clone() for g in grads]
            refs = [g.clone() for g in grads]
            ins, ins_ref = outs, refs
        else:
            outs = table.empty_views(shapes, [torch.float32] * len(shapes))
            refs = [torch.empty(s, device=dev) for s in shapes]
            ins = ins_ref = grads
        before = packed_scale.launches
        packed_scale(table, ins, inv, flag, outs)
        require(packed_scale.launches == before + 1,
                "packed_scale: not one launch over the table")
        packed_scale_ref(table, ins_ref, inv, flag_ref, refs)
        torch.cuda.synchronize()
        require(int(flag) == int(flag_ref) == int(bad is not None),
                f"packed_scale flag {int(flag)} (plain {int(flag_ref)}), "
                f"want {int(bad is not None)}")
        require(all(torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(), b.nan_to_num()) for a, b in zip(outs, refs)),
            f"packed_scale ({set(dtypes)}, in place {in_place}, {bad}) "
            f"differs from its plain version")
        # the scale was applied: 2**-16 is exact away from underflow
        require(torch.equal(outs[0], grads[0].float() * 2.0 ** -16),
                "packed_scale did not apply the scale")
        results[bad or "clean"] = int(flag)
        del outs, refs
    grads[5].view(-1)[17] = 1.0
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    found = torch.zeros(1, device=dev)
    names = sorted({str(d).replace("torch.", "") for d in dtypes})
    rec = dict(kernel="packed_scale", leaves=len(shapes), elements=n,
               shape=f"{len(shapes)} leaves, {n} elements", scale=2.0 ** -16,
               launches_a_call=1, chunks=table.n_chunks, max_abs_err=0.0,
               tolerance="bitwise equal to the plain version; flag raised "
                         "by the one inf, then the one nan leaf",
               flags=results, per="one unscale over every leaf")
    if in_place:
        # in place, each timed call scales the leaves again (toward zero
        # and the subnormals, which the card reads and writes at the same
        # rate); PyTorch's own unscale computes this function
        t = in_turns({
            "ms": lambda: packed_scale(table, grads, inv, flag, grads),
            "library_ms": lambda: torch.
            _amp_foreach_non_finite_check_and_unscale_(grads, found, inv)})
        plain = time_ms(lambda: packed_scale_ref(table, grads, inv, flag,
                                                 grads))
        b_ms, b_by = bound(8.0 * n, 2.0 * n, PEAK_FP32_FLOPS)
        return _kernel_rec(
            **rec, dtype="float32 -> float32, in place", ms=t["ms"],
            plain_ms=plain, library_ms=t["library_ms"],
            library_call="torch._amp_foreach_non_finite_check_and_unscale_",
            bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / t["ms"])
    outs = table.empty_views(shapes, [torch.float32] * len(shapes))
    ms = time_ms(lambda: packed_scale(table, grads, inv, flag, outs))
    plain = time_ms(lambda: packed_scale_ref(table, grads, inv, flag, outs))
    # PyTorch's own unscale takes no bf16 gradients (it unscales float
    # tensors in place): no call computes this function on these inputs,
    # so library_ms is null; the fp32 in-place call is timed beside it
    # (in_place=True holds K6 against it on the same inputs)
    one = torch.ones(1, device=dev)
    grads32 = [g.float() for g in grads]
    lib32 = time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
        grads32, found, one))
    del grads32
    nbytes = sum((g.element_size() + 4) * g.numel() for g in grads)
    b_ms, b_by = bound(nbytes, 2.0 * n, PEAK_FP32_FLOPS)
    return _kernel_rec(**rec, dtype=" / ".join(names) + " -> float32",
                       ms=ms, plain_ms=plain, library_ms=None,
                       library_null_reason="no PyTorch call unscales bf16 "
                                           "gradients into fp32",
                       library_fp32_in_place_ms=lib32, bound_ms=b_ms,
                       bound_by=b_by, bound_share=b_ms / ms)


def phase_train_kernels(cfg):
    import torch
    rng = np.random.default_rng(2)
    recs = {}
    recs["layer_norm_bwd"] = [_ln_bwd_case(16384, 768, dt, rng)
                              for dt in (torch.bfloat16, torch.float32)]
    k4 = [_flash_bwd_case((8, 2048, 12, 64), rng),
          _flash_bwd_case((2, 1000, 6, 128), rng),
          _flash_bwd_case((2, 512, 12, 64), rng, masked=True, rope=False),
          # a head width TMA pads (40 runs as 64), in fp16, at a ragged L
          _flash_bwd_case((2, 1000, 4, 40), rng, dtype="float16")]
    recs["flash_attn_bwd"] = [r for r, _ in k4]
    recs["flash_bwd_finish"] = [f for _, f in k4]
    recs["flash_attn_fwd_rope"] = [_flash_rope_case((8, 2048, 12, 64), rng)]
    recs["flash_fwd_prologue"] = [_fwd_prologue_case((8, 2048, 12, 64),
                                                     rng)]
    recs["packed_adam"] = [_adam_case(cfg, rng)]
    # bf16 -> fp32 (train), then fp32 in place (accum's accumulators)
    recs["packed_scale"] = [_scale_case(_leaf_shapes(cfg), rng),
                            _scale_case(_leaf_shapes(cfg), rng,
                                        in_place=True)]
    torch.cuda.empty_cache()
    return recs


TRAIN_STEPS = 10
TRAIN_B, TRAIN_L = 8, 2048


def train_stream(vocab, b, l):
    """``examples/gpt_lm.py``'s synthetic stream: each row counts up by
    one from a random start (next token = token + 1)."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (b, 1))
    return (base + np.arange(l)[None, :]) % vocab


def _gpt_loss(model, ids):
    from apex_tpu_torch.models import lm_loss
    return lm_loss(model(ids)[:, :-1], ids[:, 1:])


#: the gpt_small O2 step's p50 measured by this script before FusedAdam
#: went to K11 (148 K5 launches a step), on an NVIDIA H100 80GB HBM3 at
#: 700.00 W; printed beside this run's as a record, not compared
PR3_TRAIN_P50_MS = 124.8

#: every kernel's name with no launch
NO_LAUNCHES = {k: 0 for k in (
    "layer_norm_fwd", "flash_attn_fwd", "layer_norm_bwd", "flash_attn_bwd",
    "packed_adam", "packed_scale", "lamb_stage1", "lamb_stage2",
    "packed_sumsq", "packed_axpby", "packed_adam_tree", "sumsq_per_tensor",
    "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "flash_bwd_prologue",
    "conv1x1_bwd", "packed_nonfinite", "flash_mh_fwd", "flash_mh_bwd",
    "flash_fwd_prologue", "flash_fwd_simt", "flash_bwd_simt",
    "flash_bwd_finish")}


def fused_route(b, l, h, d) -> bool:
    """Whether the flash backward takes K4 at a bf16 ``(b, l, h, d)`` under
    the current budget (else K13 + K14)."""
    import torch
    from apex_tpu_torch.ops.cuda import (fused_bwd_max_bytes,
                                         fused_bwd_partials_bytes)
    return fused_bwd_partials_bytes(b, l, h, d, torch.bfloat16) \
        <= fused_bwd_max_bytes()


def gpt_pass_launches(cfg, micro_batches=1, b=TRAIN_B, l=TRAIN_L):
    """Launches of ``micro_batches`` GPT forward and backward passes of
    ``(b, l)`` tokens each, and none of any other kernel: the flash
    backward's q^ / k^ prologue once a layer (the GPT rotates), then by
    the route the budget gives that shape K4 and its finish pass, or K13
    and K14, once a layer each; K2 with its k^ prologue, and under
    ``cfg.remat`` each block's forward kernels twice (the recompute)."""
    lnc = 2 * cfg.num_layers + 1
    again = cfg.num_layers if cfg.remat else 0       # blocks run again
    n = micro_batches * cfg.num_layers
    fused = fused_route(b, l, cfg.num_heads, cfg.head_dim)
    return dict(NO_LAUNCHES,
                layer_norm_fwd=micro_batches * (lnc + 2 * again),
                flash_attn_fwd=micro_batches * (cfg.num_layers + again),
                flash_fwd_prologue=micro_batches * (cfg.num_layers + again),
                # two launches a call: dx with partials, then the dw/db sum
                layer_norm_bwd=micro_batches * 2 * lnc,
                flash_attn_bwd=n if fused else 0,
                flash_bwd_finish=n if fused else 0,
                flash_attn_bwd_dq=0 if fused else n,
                flash_attn_bwd_dkv=0 if fused else n,
                flash_bwd_prologue=n)


def row_counts(tables):
    """(lookups, uploads) of the pointer rows of ``tables``."""
    return (sum(t.lookups for t in tables), sum(t.uploads for t in tables))


def pointer_rows(first, tables, steps=TRAIN_STEPS):
    """Pointer-row lookups and uploads in step 1 and in the later steps."""
    now = row_counts(tables)
    return dict(lookups_step_1=first[0], uploads_step_1=first[1],
                lookups_later=now[0] - first[0],
                uploads_later=now[1] - first[1],
                uploads_per_later_step=(now[1] - first[1]) / (steps - 1))


class TableRows:
    """Pointer-row lookups and uploads of ``table_for``'s chunk tables
    (the unscale's, K6: its input row holds autograd's gradients, whose
    addresses move until the caching allocator settles in the first
    steps; its output row amp's kept buffers) over a phase's steps:
    ``mark()`` after each step, then ``report()``: a record, no check
    (the optimizer's own tables, whose rows are amp's kept buffers, are
    checked by ``pointer_rows``)."""

    def __init__(self):
        from apex_tpu_torch.ops.multi_tensor import cached_tables
        self._tables = cached_tables
        self._base = {id(t): (t.lookups, t.uploads) for t in cached_tables()}
        self.after = []

    def mark(self):
        lk = up = 0
        for t in self._tables():
            base = self._base.get(id(t), (0, 0))
            lk += t.lookups - base[0]
            up += t.uploads - base[1]
        self.after.append((lk, up))

    def report(self):
        """Lookups and uploads in step 1, uploads in each step, and the
        last step that uploaded a row."""
        up = [u for _, u in self.after]
        by_step = [up[0]] + [b - a for a, b in zip(up, up[1:])]
        return dict(lookups_step_1=self.after[0][0], uploads_step_1=up[0],
                    uploads_later=up[-1] - up[0], uploads_by_step=by_step,
                    last_step_uploading=max((i + 1 for i, u in
                                             enumerate(by_step) if u),
                                            default=0))


def device_kernel_ms(prof) -> dict:
    """Device ms by kernel name of a finished ``torch.profiler`` session:
    device events only, without the ranges that annotate a span of them
    (the optimizer's ``Optimizer.step#...``), which would count the same
    kernels twice."""
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA") \
                and not getattr(ev, "is_user_annotation", False):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    return kernels


def profile_step(step, *batch, ranges=()):
    """One train step under ``torch.profiler``: the device time of every
    kernel, summed by group (the port's kernels, cuBLAS matmuls, the rest
    of PyTorch's kernels), against the step's wall time; kernels on one
    stream do not overlap, so their sum over the wall time is the
    device's busy share.  ``ranges``: ``record_function`` names whose
    kernels' device ms (and calls) are summed too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.obs.stepclass import (OTHER_GROUP, PROFILE_GROUPS,
                                              kernel_group)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernel_ms(prof)
    busy = sum(kernels.values())
    if busy == 0.0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups[OTHER_GROUP] = 0.0
    for name, ms in kernels.items():
        groups[kernel_group(name)] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    rec = {"wall_ms": wall_ms, "device_ms": busy,
           "device_busy_share": busy / wall_ms, "by_group_ms": groups,
           "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
    if ranges:
        # the host-side range: the device time of the kernels it launched
        rec["ranges"] = {
            ev.key: {"calls": ev.count,
                     "device_ms": getattr(ev, "device_time_total", 0.0)
                     / 1e3}
            for ev in prof.key_averages() if ev.key in ranges
            and not str(getattr(ev, "device_type", "")).endswith("CUDA")}
    return rec


def phase_train(cfg, tree):
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _gpt_loss)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    n_leaves = len(a.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rows6 = TableRows()
    losses, scales, overflows, times = [], [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows6.mark()
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
        if i == 0:
            rows_first = row_counts(opt.tables)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    # one K6 launch a step: the unscale over the whole tree
    want = dict(gpt_pass_launches(cfg), packed_scale=1, packed_adam_tree=1)
    require(per_step == want, f"train launches per step {per_step}, want "
                              f"{want}")
    rows = pointer_rows(rows_first, opt.tables)
    require(rows["uploads_later"] == 0,
            f"pointer rows uploaded after the first step: {rows}")
    unscale_rows = rows6.report()
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(not any(overflows), f"overflow in the train steps: {overflows}")
    p50 = float(np.median(times[2:])) * 1e3
    STEP_P50["train"] = p50
    tokens = TRAIN_B * TRAIN_L
    profile = profile_step(step, ids)
    routes = route_steps(step, ids, cfg, dict(packed_scale=1,
                                              packed_adam_tree=1))
    # one step with a non-finite gradient: skipped on the card
    with torch.enable_grad():
        loss = a.run(_gpt_loss, model, ids)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[3].view(-1)[0] = float("inf")
    masters = {n: t.clone() for n, t in a.masters.items()}
    st = opt.state[a.masters["lm_head.kernel"]]
    moments = (st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
               int(st["step"]))
    compute = a.params[0].detach().clone()
    scale_before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    torch.cuda.synchronize()
    require(bool(info["overflow"]), "the injected inf was not seen")
    require(float(info["loss_scale"]) == scale_before / 2,
            "the scale did not halve on overflow")
    require(all(torch.equal(masters[n], t) for n, t in a.masters.items()),
            "masters changed on a skipped step")
    require(torch.equal(st["exp_avg"], moments[0])
            and torch.equal(st["exp_avg_sq"], moments[1])
            and int(st["step"]) == moments[2],
            "moments or step counts changed on a skipped step")
    require(torch.equal(a.params[0], compute),
            "compute params changed on a skipped step")
    emit("train", model="gpt_small", opt_level="O2", optimizer="FusedAdam",
         lr=3e-4, batch=TRAIN_B, seq_len=TRAIN_L, steps=TRAIN_STEPS,
         losses=losses, loss_scales=scales, step_ms=[t * 1e3 for t in times],
         step_ms_p50_steps_3_to_10=p50, tokens_per_s=tokens / (p50 / 1e3),
         record_step_ms_p50_before_k11=PR3_TRAIN_P50_MS,
         peak_memory_gb=peak, launches=counts, launches_per_step=per_step,
         pointer_rows=rows, unscale_pointer_rows=unscale_rows,
         leaves=n_leaves, profile=profile,
         flash_backward_route="fused (K4)" if fused_route(
             TRAIN_B, TRAIN_L, cfg.num_heads, cfg.head_dim)
         else "two-pass (K13 + K14)",
         route_comparison=routes,
         injected_overflow={
             "skipped": True, "loss_scale": [scale_before,
                                             float(info["loss_scale"])]})
    del a, opt, model, grads, masters
    torch.cuda.empty_cache()
    return counts


#: steps of each route in the train phase's comparison, alternated
ROUTE_PAIRS = 5


def route_steps(step, ids, cfg, extra):
    """``ROUTE_PAIRS`` pairs of steps of ``step``, alternating step by step
    between a budget above K4's planes (the fused route: K4 and its
    finish pass) and a budget of 0 (the two-pass route: K13 + K14), each
    launching exactly its route's kernels (``gpt_pass_launches`` under
    that budget, and ``extra``): both routes' step times and peak memory
    under the same conditions; p50s over pairs 2 to ``ROUTE_PAIRS``."""
    import torch
    from apex_tpu_torch.ops.cuda import (fused_bwd_partials_bytes,
                                         launch_counts, reset_launch_counts)
    b, l = ids.shape
    runs = {"fused": FUSED_ALWAYS, "two_pass": 0}
    times = {r: [] for r in runs}
    peaks = {r: 0.0 for r in runs}
    wants = {}
    for _ in range(ROUTE_PAIRS):
        for route, budget in runs.items():
            with fused_budget(budget):
                wants[route] = dict(gpt_pass_launches(cfg, b=b, l=l),
                                    **extra)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                out = step(ids)
                torch.cuda.synchronize()
                times[route].append(time.perf_counter() - t0)
                counts = launch_counts()
            require(counts == wants[route], f"{route}-route step launched "
                                            f"{counts}, want {wants[route]}")
            require(not bool(out["overflow"]),
                    f"overflow in a {route}-route step")
            peaks[route] = max(peaks[route],
                               torch.cuda.max_memory_allocated() / 1e9)
    p50 = {r: float(np.median(t[1:])) * 1e3 for r, t in times.items()}
    return dict(pairs=ROUTE_PAIRS, order="fused, two-pass; alternated step "
                                         "by step",
                fused_step_ms=[t * 1e3 for t in times["fused"]],
                two_pass_step_ms=[t * 1e3 for t in times["two_pass"]],
                fused_step_ms_p50_pairs_2_to_5=p50["fused"],
                two_pass_step_ms_p50_pairs_2_to_5=p50["two_pass"],
                fused_minus_two_pass_ms=p50["fused"] - p50["two_pass"],
                fused_peak_memory_gb=peaks["fused"],
                two_pass_peak_memory_gb=peaks["two_pass"],
                planes_gb=fused_bwd_partials_bytes(
                    b, l, cfg.num_heads, cfg.head_dim, torch.bfloat16) / 1e9,
                launches_per_step=wants)


def masters_np(a):
    """An :class:`Amp`'s fp32 masters as ``{path: numpy array}``."""
    import torch.utils._pytree as pytree
    from apex_tpu_torch.convert import params_to_numpy
    flat, _ = pytree.tree_flatten_with_path(params_to_numpy(a.masters))
    return {tuple(k.key for k in path): np.asarray(v, np.float32)
            for path, v in flat}


def phase_train_reference():
    """A 2-layer 2 x 64-head model, 3 steps, the card (kernels) against the
    CPU (plain versions) from the same weights: fp32 O0, then bf16 O3 (no
    master weights, so K5 steps the bf16 parameters with bf16
    gradients)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    tree = gpt_small_tree(cfg, seed=3)
    ids = train_stream(cfg.vocab_size, 4, 128)

    out = {}
    for level in ("O0", "O3"):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = params_from_jax(tree, cfg, device=dev, trainable=True)
            a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                                device=dev),
                               opt_level=level, device=dev)
            step = amp.make_train_step(a, model, _gpt_loss)
            x = torch.as_tensor(ids, device=dev)
            losses = [float(step(x)["loss"]) for _ in range(3)]
            masters = masters_np(a)
            runs[dev] = (losses, masters,
                         {str(t.dtype) for t in a.masters.values()})
        (lg, pg, dg), (lc, pc, _) = runs["cuda"], runs["cpu"]
        loss_err = max(abs(x - y) for x, y in zip(lg, lc))
        param_err = max(float(np.abs(v - pc[k]).max()) for k, v in pg.items())
        require(all(np.isfinite(lg)) and lg[-1] < lg[0],
                f"{level} train losses on the card: {lg}")
        out[level] = dict(losses_card=lg, losses_cpu=lc,
                          loss_max_abs_err=loss_err,
                          param_max_abs_err=param_err,
                          master_dtypes=sorted(dg))
    o0, o3 = out["O0"], out["O3"]
    require(o0["loss_max_abs_err"] <= 1e-4,
            f"fp32 train losses card vs CPU differ by "
            f"{o0['loss_max_abs_err']}")
    require(o0["param_max_abs_err"] <= TRAIN_REF_PARAM_TOL,
            f"fp32 train params card vs CPU differ by "
            f"{o0['param_max_abs_err']}")
    require(o3["master_dtypes"] == ["torch.bfloat16"],
            f"O3 stepped {o3['master_dtypes']}, not the bf16 parameters")
    require(o3["loss_max_abs_err"] <= TRAIN_REF_O3_LOSS_TOL,
            f"O3 train losses card vs CPU differ by "
            f"{o3['loss_max_abs_err']}")
    emit("train_reference", steps=3,
         O0=dict(o0, dtype="float32", loss_tolerance=1e-4,
                 param_tolerance=TRAIN_REF_PARAM_TOL),
         O3=dict(o3, dtype="bfloat16",
                 loss_tolerance=TRAIN_REF_O3_LOSS_TOL))


#: fp32 masters after 3 Adam steps at lr 3e-3, card vs CPU: cuBLAS and
#: the CPU sum matmuls in other orders, and Adam's m / sqrt(v) turns
#: last-bit gradient differences into parameter differences of a small
#: fraction of lr
TRAIN_REF_PARAM_TOL = 1e-4
#: bf16 O3 losses, card vs CPU: the two round bf16 activations and
#: gradients at other places (the bound of the CPU O2 test against JAX);
#: the bf16 parameters themselves are reported, not gated: a gradient
#: near zero whose sign differs moves an element by up to 2 x lr a step
TRAIN_REF_O3_LOSS_TOL = 2e-2


# -- accumulation, the whole-tree Adam, FP16Optimizer --------------------

def _fp32_leaves(shapes, gen, scale=1.0, dtype=None):
    import torch
    out = [torch.randn(s, generator=gen, device="cuda") * scale
           for s in shapes]
    return out if dtype is None else [t.to(dtype) for t in out]


def _equal_nan(a, b) -> bool:
    import torch
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _axpby_case(shapes):
    """K10 over gpt_small's 148 leaves as the accumulation runs it (bf16
    scaled gradients x, fp32 accumulators y, out = y) against its plain
    version: bitwise for arg_to_check -1 / 0 / 1 with an inf in x, then
    in y, and in place; repeats; timings."""
    import torch
    from apex_tpu_torch.ops.cuda import packed_axpby, packed_axpby_ref
    from apex_tpu_torch.ops.multi_tensor import ChunkTable
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    x = _fp32_leaves(shapes, gen, 1e3, torch.bfloat16)
    y = _fp32_leaves(shapes, gen)
    n = sum(t.numel() for t in x)
    table = ChunkTable.of(x)
    a = torch.ones(1, device=dev)
    b = torch.ones(1, device=dev)
    flags = {}
    for bad in (None, "x", "y"):
        if bad == "x":
            x[5].view(-1)[17] = float("inf")
        if bad == "y":
            x[5].view(-1)[17] = 1.0
            y[9].view(-1)[3] = float("inf")
        for arg in (-1, 0, 1):
            outs = []
            for fn in (packed_axpby, packed_axpby_ref):
                out = [torch.empty_like(t) for t in y]
                flag = torch.zeros(1, dtype=torch.int32, device=dev)
                fn(table, x, y, a, b, flag, out, arg_to_check=arg)
                outs.append((out, int(flag)))
            want = {None: 0, "x": int(arg in (-1, 0)),
                    "y": int(arg in (-1, 1))}[bad]
            require(outs[0][1] == outs[1][1] == want,
                    f"packed_axpby flag {outs[0][1]} (plain {outs[1][1]}) "
                    f"with an inf in {bad}, arg_to_check {arg}: want {want}")
            require(all(_equal_nan(p_, q) for p_, q in
                        zip(outs[0][0], outs[1][0])),
                    f"packed_axpby differs from its plain version (inf in "
                    f"{bad}, arg_to_check {arg})")
            flags[f"inf_in_{bad}_check_{arg}"] = outs[0][1]
            del outs
    y[9].view(-1)[3] = 0.0
    # in place (out = y), twice from the same state for equal bits
    runs = []
    for fn in (packed_axpby, packed_axpby, packed_axpby_ref):
        acc = [t.clone() for t in y]
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(table, x, acc, a, b, flag, acc)
        runs.append(acc)
    torch.cuda.synchronize()
    require(all(torch.equal(p_, q) for p_, q in zip(runs[0], runs[1])),
            "packed_axpby: two runs differ")
    require(all(torch.equal(p_, q) for p_, q in zip(runs[0], runs[2])),
            "packed_axpby in place differs from its plain version")
    del runs
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: packed_axpby(table, x, y, a, b, flag, y))
    plain = time_ms(lambda: packed_axpby_ref(table, x, y, a, b, flag, y))
    lib = time_ms(lambda: torch._foreach_add_(y, x))
    b_ms, b_by = bound(10.0 * n, 3.0 * n, PEAK_FP32_FLOPS)
    return _kernel_rec(kernel="packed_axpby", leaves=len(shapes), elements=n,
                       shape=f"{len(shapes)} leaves, {n} elements",
                       dtype="bfloat16 x, float32 y and out (in place)",
                       max_abs_err=0.0, flags=flags, bitwise_repeat=True,
                       tolerance="bitwise equal to the plain version; flags "
                                 "as arg_to_check says",
                       ms=ms, plain_ms=plain, library_ms=lib,
                       library_call="torch._foreach_add_(y, x)",
                       bound_ms=b_ms, bound_by=b_by,
                       per="one accumulation of a micro-batch's gradients")


def _adam_tree_case(shapes, p_dtype, g_dtype, copy):
    """K11 over one group of ``shapes`` against its plain version and K5
    leaf by leaf: bitwise, twice; nothing written under the noop flag;
    timings."""
    import torch
    from apex_tpu_torch.ops.cuda import (packed_adam, packed_adam_tree,
                                         packed_adam_tree_ref)
    from apex_tpu_torch.ops.multi_tensor import ChunkTable
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    p = _fp32_leaves(shapes, gen, 0.05, p_dtype)
    m = _fp32_leaves(shapes, gen, 1e-3)
    v = [t.abs() for t in _fp32_leaves(shapes, gen, 1e-4)]
    g = _fp32_leaves(shapes, gen, 1e-2, g_dtype)
    n = sum(t.numel() for t in p)
    table = ChunkTable.of(p)
    sizes = torch.linspace(2e-4, 4e-4, len(shapes), device=dev)
    scale = torch.ones(1, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)

    def state():
        return [[t.clone() for t in ts] for ts in (p, m, v)] + [
            [torch.zeros_like(t, dtype=torch.bfloat16) for t in p]
            if copy else None]
    first = None
    for how in ("kernel", "kernel", "plain", "k5"):
        ps, ms_, vs, cs = state()
        if how == "k5":
            for i in range(len(shapes)):
                packed_adam(ps[i], ms_[i], vs[i], g[i], sizes[i:i + 1],
                            scale, flag, p_copy=None if cs is None
                            else cs[i], **kw)
        else:
            fn = packed_adam_tree if how == "kernel" else \
                packed_adam_tree_ref
            fn(table, ps, ms_, vs, g, sizes, scale, flag, p_copy=cs, **kw)
        torch.cuda.synchronize()
        run = [ps, ms_, vs] + ([cs] if copy else [])
        if first is None:
            first = run
            continue
        require(all(torch.equal(a_, b_) for xs, ys in zip(first, run)
                    for a_, b_ in zip(xs, ys)),
                f"packed_adam_tree ({p_dtype} p, {g_dtype} g) differs from "
                f"the {how} run")
        del run
    kept = [[t.clone() for t in ts[:12]] for ts in first]
    flag.fill_(1)
    packed_adam_tree(table, *first[:3], g, sizes, scale, flag,
                     p_copy=first[3] if copy else None, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a_, b_) for xs, ys in zip(first, kept)
                for a_, b_ in zip(xs, ys)),
            "packed_adam_tree wrote with the noop flag set")
    flag.zero_()
    ps, ms_, vs = first[:3]
    cs = first[3] if copy else None
    ms = time_ms(lambda: packed_adam_tree(table, ps, ms_, vs, g, sizes,
                                          scale, flag, p_copy=cs, **kw))
    plain = time_ms(lambda: packed_adam_tree_ref(
        table, ps, ms_, vs, g, sizes, scale, flag, p_copy=cs, **kw))
    lib = None
    if p_dtype == torch.float32:
        lp = [t.clone().requires_grad_() for t in ps]
        for t, gg in zip(lp, g):
            t.grad = gg
        opt = torch.optim.Adam(lp, lr=3e-4, weight_decay=0.01, fused=True)
        lib = time_ms(opt.step)
        del lp, opt
    per_elem = 4 * 4 + 3 * 4 + (2 if copy else 0) - (
        2 if g_dtype == torch.bfloat16 else 0) - (
        4 if p_dtype == torch.bfloat16 else 0)
    b_ms, b_by = bound(per_elem * n, 15.0 * n, PEAK_FP32_FLOPS)
    rec = dict(kernel="packed_adam_tree", leaves=len(shapes), elements=n,
               chunks=table.n_chunks,
               shape=f"{len(shapes)} leaves, {n} elements",
               dtype=f"{str(p_dtype)[6:]} p, {str(g_dtype)[6:]} g, float32 "
                     f"m, v" + (", bfloat16 copy" if copy else ""),
               max_abs_err=0.0, bitwise_repeat=True, equals_k5_per_leaf=True,
               noop_flag_skips=True,
               tolerance="bitwise equal to the plain version and to K5 "
                         "launched leaf by leaf",
               ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
               bound_by=b_by, bytes_per_element=per_elem,
               per="one FusedAdam step over every leaf")
    if lib is None:
        rec["library_null_reason"] = ("torch.optim.Adam steps bf16 "
                                      "parameters in bf16, not through "
                                      "fp32 moments as this kernel does")
    else:
        rec["library_call"] = "torch.optim.Adam(fused=True).step()"
    return _kernel_rec(**rec)


def _sumsq_per_tensor_case(shapes, model):
    """K12 over a model's fp32 leaves against its plain version: within
    1e-6 relative per leaf, repeats bitwise; timings."""
    import torch
    from apex_tpu_torch.ops.cuda import sumsq_per_tensor, sumsq_per_tensor_ref
    from apex_tpu_torch.ops.multi_tensor import ChunkTable
    gen = torch.Generator(device="cuda").manual_seed(23)
    xs = _fp32_leaves(shapes, gen, 1e-2)
    n = sum(t.numel() for t in xs)
    table = ChunkTable.of(xs)
    got = sumsq_per_tensor(table, xs)
    again = sumsq_per_tensor(table, xs)
    ref = sumsq_per_tensor_ref(table, xs)
    torch.cuda.synchronize()
    require(torch.equal(got, again), "sumsq_per_tensor: two runs differ")
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    require(rel <= 1e-6, f"sumsq_per_tensor off by {rel} (relative)")
    ms = time_ms(lambda: sumsq_per_tensor(table, xs))
    plain = time_ms(lambda: sumsq_per_tensor_ref(table, xs), budget_s=0.2)
    lib = time_ms(lambda: torch._foreach_norm(xs))
    b_ms, b_by = bound(4.0 * n, 2.0 * n, PEAK_FP32_FLOPS)
    return _kernel_rec(kernel="sumsq_per_tensor", model=model,
                       leaves=len(shapes), elements=n, chunks=table.n_chunks,
                       shape=f"{len(shapes)} leaves, {n} elements",
                       dtype="float32", max_abs_err=float(
                           (got - ref).abs().max()), rel_err=rel,
                       bitwise_repeat=True,
                       tolerance="rtol 1e-6 per leaf vs the plain sums "
                                 "(another order)",
                       ms=ms, plain_ms=plain, library_ms=lib,
                       library_call="torch._foreach_norm (per-leaf norms)",
                       bound_ms=b_ms, bound_by=b_by,
                       per="one per-tensor norm call over every leaf")


def phase_multi_tensor_kernels(cfg, bert_cfg):
    """K10, K11 and K12 against their plain versions at gpt_small's 148
    leaves (K12 also at bert_large's 303)."""
    import torch
    shapes = _leaf_shapes(cfg)
    recs = {"packed_axpby": _axpby_case(shapes)}
    torch.cuda.empty_cache()
    # the O2 path (fp32 masters and gradients, bf16 copies), then O3's
    # (bf16 parameters stepped with bf16 gradients)
    recs["packed_adam_tree"] = [
        _adam_tree_case(shapes, torch.float32, torch.float32, True),
        _adam_tree_case(shapes, torch.bfloat16, torch.bfloat16, False)]
    torch.cuda.empty_cache()
    recs["sumsq_per_tensor"] = [
        _sumsq_per_tensor_case(shapes, "gpt_small"),
        _sumsq_per_tensor_case(_leaf_shapes(bert_cfg), "bert_large")]
    torch.cuda.empty_cache()
    return recs


ACCUM_STEPS = 4
ACCUM_B = 32


def _gpt_loss_poisoned(model, ids, poison):
    """``_gpt_loss`` times ``1 + sum(poison)``: 1 exactly for a zero
    poison row, a non-finite loss (and gradients) for an inf one."""
    return _gpt_loss(model, ids) * (1.0 + poison.float().sum())


def phase_accum(cfg, tree):
    """gpt_small O2 + FusedAdam with ``accum_steps=4`` over B 32 x L 2048
    (micro-batches of the train phase's 8 x 2048): per step K10 4 (each
    micro-batch unscaled onto the accumulators), K15 1 (the finite check
    of the accumulated gradients), K6 0, K11 1, K5 0, 4 x a pass's forward
    and backward kernels, and the per-leaf gradient norms a trainer logs
    (K12 1); then one step whose micro-batch 1 is non-finite, skipped on
    the card."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.ops.multi_tensor import (cached_tables,
                                                 multi_tensor_l2norm)
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _gpt_loss, accum_steps=ACCUM_STEPS)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, ACCUM_B, TRAIN_L),
                          device="cuda")
    n_leaves = len(a.params)

    def tables():
        return cached_tables() + opt.tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, scales, overflows, times, norms, rows = [], [], [], [], [], []
    for i in range(TRAIN_STEPS):
        before = row_counts(tables())
        t0 = time.perf_counter()
        out = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = row_counts(tables())
        rows.append([after[0] - before[0], after[1] - before[1]])
        total, per = multi_tensor_applier(multi_tensor_l2norm,
                                          [a.grad_buffers()], True)
        norms.append([float(total), float(per.max())])
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: c / TRAIN_STEPS for k, c in counts.items()}
    want = dict(gpt_pass_launches(cfg, ACCUM_STEPS), packed_axpby=ACCUM_STEPS,
                packed_nonfinite=1, packed_adam_tree=1, sumsq_per_tensor=1)
    require(per_step == want, f"accum launches per step {per_step}, want "
                              f"{want}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(not any(overflows), f"overflow in the accum steps: {overflows}")
    require(all(np.isfinite(norms).all(axis=1)), f"norms: {norms}")
    # after step 1 only the fresh gradients of each micro-batch may need a
    # row (the accumulators, masters, moments and copies keep theirs)
    require(all(r[1] <= ACCUM_STEPS for r in rows[1:]),
            f"pointer rows uploaded per step: {rows}")
    p50 = float(np.median(times[2:])) * 1e3
    tokens = ACCUM_B * TRAIN_L
    profile = profile_step(step, ids)
    # one step with a non-finite micro-batch: skipped on the card
    poisoned = amp.make_train_step(a, model, _gpt_loss_poisoned,
                                   accum_steps=ACCUM_STEPS)
    poison = torch.zeros(ACCUM_B, device="cuda")
    per_micro = ACCUM_B // ACCUM_STEPS
    poison[per_micro:2 * per_micro] = float("inf")
    masters = {k: t.clone() for k, t in a.masters.items()}
    scale_before = float(a.scaler_state.loss_scale)
    info = poisoned(ids, poison)
    torch.cuda.synchronize()
    require(bool(info["overflow"]), "the non-finite micro-batch was not seen")
    require(float(info["loss_scale"]) == scale_before / 2,
            "the scale did not halve on overflow")
    require(all(torch.equal(masters[k], t) for k, t in a.masters.items()),
            "masters changed on a skipped accumulated step")
    emit("accum", model="gpt_small", opt_level="O2", optimizer="FusedAdam",
         lr=3e-4, accum_steps=ACCUM_STEPS, batch=ACCUM_B,
         micro_batch=per_micro, seq_len=TRAIN_L, steps=TRAIN_STEPS,
         losses=losses, loss_scales=scales, step_ms=[t * 1e3 for t in times],
         step_ms_p50_steps_3_to_10=p50, tokens_per_s=tokens / (p50 / 1e3),
         record_step_ms_p50_before_k15=PR6_ACCUM_P50_MS,
         peak_memory_gb=peak, launches=counts, launches_per_step=per_step,
         leaves=n_leaves, grad_norm_and_max_leaf_norm=norms,
         pointer_rows_per_step=rows, profile=profile,
         injected_overflow={"micro_batch": 1, "skipped": True,
                            "loss_scale": [scale_before,
                                           float(info["loss_scale"])]})
    del a, opt, model, masters, step, poisoned
    torch.cuda.empty_cache()
    return counts


def phase_accum_reference():
    """A 2-layer fp32 GPT at O0 with ``accum_steps=2``, 3 steps, the card
    (kernels) against the CPU (plain versions) from the same weights,
    within the train reference's bounds."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    tree = gpt_small_tree(cfg, seed=4)
    ids = train_stream(cfg.vocab_size, 8, 128)

    runs = {}
    for dev in ("cuda", "cpu"):
        model = params_from_jax(tree, cfg, device=dev, trainable=True)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev),
                           opt_level="O0", device=dev)
        step = amp.make_train_step(a, model, _gpt_loss, accum_steps=2)
        x = torch.as_tensor(ids, device=dev)
        losses = [float(step(x)["loss"]) for _ in range(3)]
        runs[dev] = (losses, masters_np(a))
    (lg, pg), (lc, pc) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(x - y) for x, y in zip(lg, lc))
    param_err = max(float(np.abs(v - pc[k]).max()) for k, v in pg.items())
    require(all(np.isfinite(lg)) and lg[-1] < lg[0],
            f"accumulated losses on the card: {lg}")
    require(loss_err <= 1e-4, f"accumulated fp32 losses card vs CPU differ "
                              f"by {loss_err}")
    require(param_err <= TRAIN_REF_PARAM_TOL,
            f"accumulated fp32 masters card vs CPU differ by {param_err}")
    emit("accum_reference", steps=3, accum_steps=2, opt_level="O0",
         dtype="float32", losses_card=lg, losses_cpu=lc,
         loss_max_abs_err=loss_err, param_max_abs_err=param_err,
         loss_tolerance=1e-4, param_tolerance=TRAIN_REF_PARAM_TOL)


FP16_STEPS = 5


def _fp16_steps(model, opt, x, steps):
    """``steps`` FP16Optimizer steps of the GPT loss; per step the loss,
    the step's info (host floats) and its wall seconds."""
    import torch
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = _gpt_loss(model, x)
        grads = torch.autograd.grad(opt.scale_loss(loss), opt.model_params)
        info = opt.step(grads)
        if x.is_cuda:
            torch.cuda.synchronize()
        out.append((float(loss.detach()),
                    {k: float(v) for k, v in info.items()},
                    time.perf_counter() - t0))
    return out


def _flat_sumsq_case(grads):
    """K9 as ``FP16Optimizer.step`` runs it: over the scaled half gradients
    copied into one flat fp32 buffer, a one-leaf chunk table, against its
    plain version (rtol 1e-5, another order) and repeating bitwise;
    timings."""
    import torch
    from apex_tpu_torch.ops.cuda import packed_sumsq, packed_sumsq_ref
    from apex_tpu_torch.ops.multi_tensor import ChunkTable
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    n = flat.numel()
    table = ChunkTable([n], flat.device)
    s = packed_sumsq(table, [flat])
    s_again = packed_sumsq(table, [flat])
    s_ref = packed_sumsq_ref(table, [flat])
    torch.cuda.synchronize()
    require(torch.equal(s, s_again), "packed_sumsq (flat): two runs differ")
    rel = float((s - s_ref).abs()) / float(s_ref)
    require(bool(torch.isfinite(s)) and rel <= 1e-5,
            f"packed_sumsq (flat) off by {rel} (relative)")
    ms = time_ms(lambda: packed_sumsq(table, [flat]))
    plain = time_ms(lambda: packed_sumsq_ref(table, [flat]), budget_s=0.2)
    lib = time_ms(lambda: torch.dot(flat, flat))
    b_ms, b_by = bound(4.0 * n, 2.0 * n, PEAK_FP32_FLOPS)
    del flat
    return _kernel_rec(
        kernel="packed_sumsq", dtype="float32", leaves=1, elements=n,
        chunks=table.n_chunks, chunk_size=table.chunk_size,
        shape=f"one flat buffer of {n} elements (the scaled gradients of "
              f"{len(grads)} leaves)", sumsq=float(s),
        max_abs_err=float((s - s_ref).abs()), rel_err=rel,
        tolerance="rtol 1e-5 vs the plain sum (another order)",
        bitwise_repeat=True, ms=ms, plain_ms=plain, library_ms=lib,
        library_call="torch.dot(flat, flat)", bound_ms=b_ms, bound_by=b_by,
        per="one FP16Optimizer step's gradient norm")


def phase_fp16_optimizer(cfg, tree):
    """gpt_small at B 8 x L 2048 under ``FP16Optimizer(dynamic_loss_scale=
    True, max_grad_norm=1.0)``: 5 steps, each one K5 and one K9 launch
    beside the forward and backward kernels; one injected overflow
    skipped on the card; then a 2-layer model's same steps on the card
    against the CPU."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FP16Optimizer
    model = params_from_jax(tree, cfg, trainable=True)
    opt = FP16Optimizer(model, lr=3e-4, dynamic_loss_scale=True,
                        max_grad_norm=1.0)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    runs = _fp16_steps(model, opt, ids, FP16_STEPS)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: c / FP16_STEPS for k, c in counts.items()}
    want = dict(gpt_pass_launches(cfg), packed_adam=1, packed_sumsq=1)
    require(per_step == want, f"fp16_optimizer launches per step "
                              f"{per_step}, want {want}")
    losses = [r[0] for r in runs]
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"fp16_optimizer losses: {losses}")
    require(not any(r[1]["overflow"] for r in runs),
            "overflow in the fp16_optimizer steps")
    loss = _gpt_loss(model, ids)
    grads = list(torch.autograd.grad(opt.scale_loss(loss),
                                     opt.model_params))
    k9 = _flat_sumsq_case(grads)
    # an injected overflow: the flat master and the step count stay
    grads[3].view(-1)[0] = float("inf")
    master = opt.master.clone()
    steps_before = int(opt.step_count)
    scale_before = float(opt.loss_scale)
    info = opt.step(grads)
    torch.cuda.synchronize()
    require(bool(info["overflow"]), "the injected inf was not seen")
    require(float(info["loss_scale"]) == scale_before / 2,
            "the scale did not halve on overflow")
    require(torch.equal(opt.master, master)
            and int(opt.step_count) == steps_before,
            "the flat master or the step count changed on a skipped step")
    p50 = float(np.median([r[2] for r in runs[1:]])) * 1e3
    del model, opt, grads, master
    torch.cuda.empty_cache()
    # the same steps on a 2-layer model, card against CPU
    small = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                      num_heads=2, intermediate_size=256)
    small_tree = gpt_small_tree(small, seed=5)
    ref = {}
    for dev in ("cuda", "cpu"):
        m = params_from_jax(small_tree, small, device=dev, trainable=True)
        o = FP16Optimizer(m, lr=3e-3, dynamic_loss_scale=True,
                          max_grad_norm=1.0, device=dev)
        x = torch.as_tensor(train_stream(small.vocab_size, 4, 128),
                            device=dev)
        r = _fp16_steps(m, o, x, 3)
        ref[dev] = ([q[0] for q in r], [q[1]["grad_norm"] for q in r])
    loss_err = max(abs(p_ - q) for p_, q in zip(ref["cuda"][0],
                                                ref["cpu"][0]))
    norm_rel = max(abs(p_ - q) / q for p_, q in zip(ref["cuda"][1],
                                                    ref["cpu"][1]))
    require(loss_err <= TRAIN_REF_O3_LOSS_TOL,
            f"fp16_optimizer losses card vs CPU differ by {loss_err}")
    require(norm_rel <= TRAIN_REF_O3_LOSS_TOL,
            f"fp16_optimizer grad norms card vs CPU differ by {norm_rel}")
    emit("fp16_optimizer", model="gpt_small", optimizer="FP16Optimizer",
         lr=3e-4, dynamic_loss_scale=True, max_grad_norm=1.0,
         batch=TRAIN_B, seq_len=TRAIN_L, steps=FP16_STEPS, losses=losses,
         grad_norms=[r[1]["grad_norm"] for r in runs],
         loss_scales=[r[1]["loss_scale"] for r in runs],
         step_ms=[r[2] * 1e3 for r in runs], step_ms_p50_steps_2_to_5=p50,
         peak_memory_gb=peak, launches=counts, launches_per_step=per_step,
         injected_overflow={"skipped": True, "loss_scale": [
             scale_before, float(info["loss_scale"])]},
         reference=dict(model="2 layers, 2 x 64 heads", steps=3,
                        losses_card=ref["cuda"][0], losses_cpu=ref["cpu"][0],
                        loss_max_abs_err=loss_err,
                        grad_norm_max_rel_err=norm_rel,
                        tolerance=TRAIN_REF_O3_LOSS_TOL))
    return counts, k9


# -- long-context training: the two-pass flash backward, remat ------------

#: (sequence length, steps) of the long_context phase, batch 1
LC_RUNS = ((16384, 10), (32768, 3))
#: the launches per gpt_small O2 step with remat at B1 x L16384 or L32768
#: (the two-pass route), as ``gpt_pass_launches`` derives them: K13 12,
#: K14 12, K4 0, K2 24 (12 + 12 recomputed) and its k^ prologue 24, K1 49
#: (25 + 24 recomputed), K3 50 (25 calls x 2), K6 1, K11 1
#: the two routes of flash_attn_bwd are timed whole, side by side, where
#: K4's planes stay under this
ROUTE_COMPARE_MAX_BYTES = 2 << 30


def _prologue_case(q, k, scale, tables, shape, rope):
    """The two-pass prologue (q^, k^) against its plain version, bitwise,
    with its time and byte bound."""
    import torch
    from apex_tpu_torch.ops.cuda import (flash_bwd_prologue,
                                         flash_bwd_prologue_ref)
    bsz, l, h, d = shape
    got = flash_bwd_prologue(q, k, scale=scale, rope=tables)
    ref = flash_bwd_prologue_ref(q, k, scale=float(torch.tensor(
        scale, dtype=torch.bfloat16)), rope=tables)
    torch.cuda.synchronize()
    require(all(torch.equal(g, r) for g, r in zip(got, ref)),
            f"flash_bwd_prologue {shape}: differs from its plain version")
    one = bsz * l * h * d * 2
    # q read, q^ written; with tables k read, k^ written and the tables read
    nbytes = 2 * one + ((2 * one + 2 * bsz * l * d * 2) if rope else 0)
    b_pro = bound(nbytes, 0.0, PEAK_BF16_FLOPS)
    return dict(kernel="flash_bwd_prologue", shape=list(shape), rope=rope,
                dtype="bfloat16", max_abs_err=0.0, tolerance="bitwise",
                ms=time_ms(lambda: flash_bwd_prologue(q, k, scale=scale,
                                                      rope=tables)),
                plain_ms=time_ms(lambda: flash_bwd_prologue_ref(
                    q, k, scale=scale, rope=tables)),
                bound_ms=b_pro[0], bound_by=b_pro[1], library_ms=None,
                library_null_reason="no PyTorch call pre-scales and rotates "
                                    "q and k")


def _two_pass_case(shape, rng, causal=True, masked=False, rope=True):
    """K13 and K14 at ``shape`` against their plain versions (run over
    slices of heads, every head compared), twice each for equal bits, with
    times and bounds, and their prologue bitwise against its plain
    version.  Each kernel's ``ms`` times its launch on operands prepared
    once (the prologue timed in its own row); ``call_ms`` times the public
    wrapper whole, checks and prologue included, which the shared host
    bounds at small shapes; the pair's time beside SDPA's backward at the shape without
    rope; where K4's planes fit ``ROUTE_COMPARE_MAX_BYTES``, both routes
    of ``flash_attn_bwd`` timed whole, K14's dk / dv and K13's dq within
    2 bf16 ulps of K4's and the row and norm limits.  A
    head width K2 does not take gets its forward from the plain version."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import (attn_delta, flash_attn_bwd,
                                         flash_attn_bwd_dkv,
                                         flash_attn_bwd_dkv_ref,
                                         flash_attn_bwd_dq,
                                         flash_attn_bwd_dq_ref,
                                         flash_attn_fwd, flash_attn_fwd_ref,
                                         fused_bwd_partials_bytes)
    from apex_tpu_torch.ops.cuda.flash_attention import (_dkv_pass, _dq_pass,
                                                         _bwd_operands)
    bsz, l, h, d = shape
    dev = torch.device("cuda")
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                                   device=dev).to(torch.bfloat16)
                   for _ in range(4))
    mask = None
    if masked:
        # ragged: batch row i keeps its first l - 61 i keys (BERT padding)
        keep = l - 61 * np.arange(bsz)
        mask = torch.as_tensor(np.arange(l)[None, :] < keep[:, None],
                               device=dev)
    tables = _tables(bsz, l, d, torch.bfloat16) if rope else None
    kw = dict(causal=causal, kv_mask=mask, rope=tables)
    k2_width = d in (64, 128)
    o, lse = (flash_attn_fwd(q, k, v, return_lse=True, **kw) if k2_width
              else flash_attn_fwd_ref(q, k, v, **kw))
    delta = attn_delta(o, do, None)
    args = (q, k, v, do, lse, delta)
    rec_pro = _prologue_case(q, k, 1.0 / d ** 0.5, tables, shape, rope)
    dq = flash_attn_bwd_dq(*args, **kw)
    dk, dv = flash_attn_bwd_dkv(*args, **kw)
    again = (flash_attn_bwd_dq(*args, **kw),
             *flash_attn_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
            f"two-pass backward {shape}: two runs differ")
    del again
    ref = _plain_by_heads(flash_attn_bwd_dq_ref, args, kw)
    err_dq, tol_dq = _max_err(dq, ref), bf16_tol(ref)
    require(err_dq <= tol_dq, f"flash_attn_bwd_dq {shape}: error {err_dq} "
                              f"> {tol_dq}")
    scaled_dq = scaled_errs(f"flash_attn_bwd_dq {shape}", dq, ref)
    ref = _plain_by_heads(flash_attn_bwd_dkv_ref, args, kw)
    errs_dkv = [_max_err(a, r) for a, r in zip((dk, dv), ref)]
    tols_dkv = [bf16_tol(r) for r in ref]
    require(all(e <= t for e, t in zip(errs_dkv, tols_dkv)),
            f"flash_attn_bwd_dkv {shape}: errors {errs_dkv} > {tols_dkv}")
    scaled_dk, scaled_dv = (scaled_errs(f"flash_attn_bwd_dkv {shape} {n}",
                                        a, r)
                            for n, a, r in zip(("dk", "dv"), (dk, dv), ref))
    del ref
    ops = _bwd_operands("two-pass case", *args, causal, mask, None,
                             tables)
    ms_dq = time_ms(lambda: _dq_pass(ops))
    ms_dkv = time_ms(lambda: _dkv_pass(ops))
    call_dq = time_ms(lambda: flash_attn_bwd_dq(*args, **kw))
    call_dkv = time_ms(lambda: flash_attn_bwd_dkv(*args, **kw))
    del ops
    plain_dq = time_ms(lambda: _plain_by_heads(flash_attn_bwd_dq_ref, args,
                                               kw), budget_s=0.2)
    plain_dkv = time_ms(lambda: _plain_by_heads(flash_attn_bwd_dkv_ref,
                                                args, kw), budget_s=0.2)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if masked:
        am = mask[:, None, None, :]
        if causal:
            am = am & torch.ones(l, l, dtype=torch.bool, device=dev).tril()
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    else:
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                   retain_graph=True))
    del ot, qt, kt, vt
    pairs = _flash_pairs(bsz, l, h, causal, mask)
    one = bsz * l * h * d * 2                  # one bf16 (B, L, H, D) tensor
    reads = (4 * one + 2 * 4 * bsz * l * h
             + (2 * bsz * l * d * 2 if rope else 0) + (bsz * l if masked
                                                        else 0))
    b_dq = bound(reads + one, 6.0 * d * pairs, PEAK_BF16_FLOPS)
    b_dkv = bound(reads + 2 * one, 8.0 * d * pairs, PEAK_BF16_FLOPS)
    base = dict(shape=list(shape), causal=causal, kv_mask=masked, rope=rope,
                dtype="bfloat16", visible_pairs=pairs,
                tolerance="2 bf16 ulps of the largest gradient vs the plain "
                          "version in bf16, and the row and norm limits",
                plain="run over slices of heads (at most 2**28 fp32 scores "
                      "at once), every head compared",
                bitwise_repeat=True, library_ms=None)
    rec_dq = _kernel_rec(
        kernel="flash_attn_bwd_dq", **base, max_abs_err=err_dq, **scaled_dq,
        ms=ms_dq, call_ms=call_dq, plain_ms=plain_dq, bound_ms=b_dq[0],
        bound_by=b_dq[1], bound_share=b_dq[0] / ms_dq,
        library_null_reason="no PyTorch call computes dq alone")
    rec_dkv = _kernel_rec(
        kernel="flash_attn_bwd_dkv", **base, max_abs_err=max(errs_dkv),
        errs_dk_dv=errs_dkv,
        **{k: max(scaled_dk[k], scaled_dv[k]) for k in scaled_dk},
        scaled_errs_dk_dv=[scaled_dk, scaled_dv], ms=ms_dkv,
        call_ms=call_dkv, plain_ms=plain_dkv,
        bound_ms=b_dkv[0], bound_by=b_dkv[1], bound_share=b_dkv[0] / ms_dkv,
        library_null_reason="no PyTorch call computes dk and dv alone")
    emit("kernels", **rec_pro)
    pair = dict(kernel="two_pass_pair", shape=list(shape), causal=causal,
                kv_mask=masked, rope=rope, k13_plus_k14_ms=ms_dq + ms_dkv,
                prologue_ms=rec_pro["ms"], bound_ms=b_dq[0] + b_dkv[0],
                library_sdpa_backward_ms_no_rope=sdpa_bwd)
    planes = fused_bwd_partials_bytes(bsz, l, h, d, torch.bfloat16)
    if planes <= ROUTE_COMPARE_MAX_BYTES:
        bwd = (q, k, v, o, lse, do)
        with fused_budget(FUSED_ALWAYS):
            fused = flash_attn_bwd(*bwd, **kw)
            torch.cuda.synchronize()
            fused_ms = time_ms(lambda: flash_attn_bwd(*bwd, **kw))
        with fused_budget(0):
            two_pass_ms = time_ms(lambda: flash_attn_bwd(*bwd, **kw))
        # K14 is its own kernel now, no longer K4's code: the routes agree
        # within the dq check's 2-ulp limit and the row and norm limits
        route_errs = [_max_err(f, g) for f, g in zip(fused, (dq, dk, dv))]
        route_tols = [tol_dq] + tols_dkv
        require(all(e <= t for e, t in zip(route_errs, route_tols)),
                f"{shape}: the routes' dq / dk / dv differ by {route_errs} "
                f"(limits {route_tols})")
        route_scaled = [scaled_errs(f"{shape}: two-pass {n} vs K4's", g, f)
                        for n, g, f in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                           fused)]
        pair.update(fused_route_ms=fused_ms, two_pass_route_ms=two_pass_ms,
                    fused_planes_bytes=planes,
                    routes_max_abs_err_dq_dk_dv=route_errs,
                    routes_limits_dq_dk_dv=route_tols,
                    routes_scaled_errs_dq_dk_dv=route_scaled)
        del fused
    emit("kernels", **pair)
    del dq, dk, dv
    torch.cuda.empty_cache()
    return rec_dq, rec_dkv, pair, rec_pro


def phase_long_context_kernels():
    """K13 and K14 (and their prologue) at the train shape, at B1 x
    L16384, at BERT's non-causal shape with a ragged key mask, at
    gpt_small_tpu's head width, at B1 x L32768 and at a ragged L with a
    padded head width; K2 (causal, rope) at both long lengths.  Returns the
    two-pass cases in that order and the forward cases."""
    rng = np.random.default_rng(4)
    cases = [((TRAIN_B, TRAIN_L, 12, 64), True, False, True),
             ((1, LC_RUNS[0][0], 12, 64), True, False, True),
             ((4, 512, 16, 64), False, True, False),
             ((1, 4096, 6, 128), True, False, True),
             ((1, LC_RUNS[1][0], 12, 64), True, False, True),
             # a ragged L and a head width TMA pads (40 runs as 64)
             ((2, 1000, 4, 40), True, False, True)]
    two_pass = [_two_pass_case(s, rng, causal=c, masked=m, rope=r)
                for s, c, m, r in cases]
    forward = [_flash_rope_case((1, l, 12, 64), rng) for l, _ in LC_RUNS]
    return two_pass, forward


def phase_long_context(cfg, tree):
    """gpt_small with per-layer remat, amp O2 + FusedAdam(lr=3e-4), one
    sequence on the synthetic stream: 10 steps at L 16384 (falling loss,
    step p50, tokens/s, peak memory, the exact launches per step, one
    profiled step, one injected overflow skipped on the card), then 3
    steps at L 32768 with the same launches per step.  K4's planes would
    be 12.9 and 51.5 GB; the two-pass route allocates none."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import (fused_bwd_partials_bytes,
                                         launch_counts, reset_launch_counts)
    from apex_tpu_torch.optimizers import FusedAdam
    rcfg = dataclasses.replace(cfg, remat=True)
    model = params_from_jax(tree, rcfg, trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _gpt_loss)
    n_leaves = len(a.params)
    runs, counts_by_len, overflow = [], {}, None
    for l, steps in LC_RUNS:
        want = dict(gpt_pass_launches(rcfg, b=1, l=l),
                    packed_scale=1, packed_adam_tree=1)
        ids = torch.as_tensor(train_stream(cfg.vocab_size, 1, l),
                              device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        rows6 = TableRows()
        losses, scales, overflows, times = [], [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            out = step(ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rows6.mark()
            losses.append(float(out["loss"]))
            scales.append(float(out["loss_scale"]))
            overflows.append(bool(out["overflow"]))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        per_step = {k: c / steps for k, c in counts.items()}
        require(per_step == want, f"long_context L {l} launches per step "
                                  f"{per_step}, want {want}")
        require(all(np.isfinite(losses)), f"L {l}: non-finite loss {losses}")
        require(not any(overflows), f"L {l}: overflow {overflows}")
        counts_by_len[l] = counts
        run = dict(seq_len=l, steps=steps, losses=losses, loss_scales=scales,
                   step_ms=[t * 1e3 for t in times], peak_memory_gb=peak,
                   fused_route_planes_gb=fused_bwd_partials_bytes(
                       1, l, cfg.num_heads, cfg.head_dim,
                       torch.bfloat16) / 1e9,
                   launches=counts, launches_per_step=per_step,
                   unscale_pointer_rows=rows6.report())
        if steps >= 10:
            require(losses[-1] < losses[0], f"L {l}: loss did not fall: "
                                            f"{losses}")
            p50 = float(np.median(times[2:])) * 1e3
            STEP_P50.setdefault("long_context", p50)
            run.update(step_ms_p50_steps_3_to_10=p50,
                       tokens_per_s=l / (p50 / 1e3),
                       profile=profile_step(step, ids))
            overflow = _inject_overflow(a, opt, model, ids)
        else:
            mean = float(np.mean(times[1:])) * 1e3
            run.update(step_ms_mean_steps_2_to_3=mean,
                       tokens_per_s=l / (mean / 1e3),
                       loss_fell=losses[-1] < losses[0])
        runs.append(run)
        del ids
    emit("long_context", model="gpt_small", remat=True, opt_level="O2",
         optimizer="FusedAdam", lr=3e-4, batch=1, leaves=n_leaves,
         flash_backward_route="two-pass (K13 + K14)", runs=runs,
         injected_overflow=overflow)
    del a, opt, model, step
    torch.cuda.empty_cache()
    return counts_by_len[LC_RUNS[0][0]], counts_by_len[LC_RUNS[1][0]]


def _inject_overflow(a, opt, model, ids):
    """One step whose gradient holds an inf: skipped on the card (masters,
    the lm_head moments and step count unchanged, the scale halved)."""
    import torch
    with torch.enable_grad():
        loss = a.run(_gpt_loss, model, ids)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[3].view(-1)[0] = float("inf")
    inf = _skipped(a, grads, opt, "lm_head.kernel")
    require(inf["skipped"], f"the injected inf was not skipped: {inf}")
    return {"skipped": True, "loss_scale": inf["loss_scale"]}


def phase_long_context_reference():
    """A 2-layer 2 x 64-head GPT with remat, bf16 O2, B 2 x L 1024, 3
    steps: on the card with the budget at 0 (two-pass: K13 + K14) and at
    its default (fused: K4's 16.8 MB of planes fit), each against the CPU
    (plain versions) within the O3 train reference's bound, and the two
    card routes' first-step gradients within 2 bf16 ulps of each other."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, remat=True)
    tree = gpt_small_tree(cfg, seed=6)
    ids = train_stream(cfg.vocab_size, 2, 1024)
    runs = {}
    for name, dev, budget in (("two_pass", "cuda", 0),
                              ("fused", "cuda", None), ("cpu", "cpu", None)):
        with (contextlib.nullcontext() if budget is None
              else fused_budget(budget)):
            model = params_from_jax(tree, cfg, device=dev, trainable=True)
            a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                                device=dev),
                               opt_level="O2", device=dev)
            step = amp.make_train_step(a, model, _gpt_loss)
            x = torch.as_tensor(ids, device=dev)
            with torch.enable_grad():
                loss = a.run(_gpt_loss, model, x)
                grads = [g.float().cpu() for g in torch.autograd.grad(
                    a.scale_loss(loss), a.params)]
            reset_launch_counts()
            losses = [float(step(x)["loss"]) for _ in range(3)]
            counts = launch_counts()
        runs[name] = dict(losses=losses, grads=grads, counts=counts)
    tp, fu, cpu = runs["two_pass"], runs["fused"], runs["cpu"]
    n = 3 * cfg.num_layers
    require((tp["counts"]["flash_attn_bwd_dq"],
             tp["counts"]["flash_attn_bwd_dkv"],
             tp["counts"]["flash_bwd_prologue"],
             tp["counts"]["flash_attn_bwd"]) == (n, n, n, 0),
            f"two-pass reference launches {tp['counts']}")
    require((fu["counts"]["flash_attn_bwd_dq"],
             fu["counts"]["flash_bwd_prologue"],
             fu["counts"]["flash_attn_bwd"],
             fu["counts"]["flash_bwd_finish"]) == (0, n, n, n),
            f"fused reference launches {fu['counts']}")
    out = {}
    for name, run in (("two_pass", tp), ("fused", fu)):
        err = max(abs(x - y) for x, y in zip(run["losses"], cpu["losses"]))
        require(all(np.isfinite(run["losses"]))
                and run["losses"][-1] < run["losses"][0],
                f"{name} reference losses on the card: {run['losses']}")
        require(err <= TRAIN_REF_O3_LOSS_TOL,
                f"{name} route losses card vs CPU differ by {err}")
        out[name] = dict(losses_card=run["losses"], loss_max_abs_err=err,
                         flash_launches={k: run["counts"][k] for k in (
                             "flash_attn_bwd", "flash_attn_bwd_dq",
                             "flash_attn_bwd_dkv", "flash_bwd_prologue",
                             "flash_bwd_finish", "flash_attn_fwd")})
    grad_errs = [float((g - f).abs().max()) / bf16_tol(f)
                 for g, f in zip(tp["grads"], fu["grads"])]
    require(max(grad_errs) <= 1.0, f"first-step gradients of the two routes "
                                   f"differ by up to {max(grad_errs)} x the "
                                   f"2-ulp bound")
    emit("long_context_reference", model="2 layers, 2 x 64 heads, remat",
         opt_level="O2", batch=2, seq_len=1024, steps=3,
         losses_cpu=cpu["losses"], loss_tolerance=TRAIN_REF_O3_LOSS_TOL,
         **out, first_step_grads_routes_max_err_over_bound=max(grad_errs),
         grads_tolerance="2 bf16 ulps of each leaf's largest gradient")


# -- the BERT slice -------------------------------------------------------

BERT_STEPS = 10
BERT_B, BERT_L = 32, 512
#: fp32 masters after 3 LAMB steps at lr 1e-3, card vs CPU (the CPU
#: test against JAX measures 1.2e-6 after 5 steps at this lr)
BERT_REF_PARAM_TOL = 1e-5
#: bf16 O2 losses, card vs CPU: other roundings in cuBLAS and on the CPU
BERT_REF_O2_LOSS_TOL = 2e-2


def bert_tree(cfg, seed: int):
    """A JAX-layout ``BertForPreTraining`` parameter tree of numpy fp32
    arrays, initialised as :func:`gpt_small_tree` does (kernels
    N(0, 1/fan_in), embeddings N(0, 1/hidden), biases 0, layer-norm
    scales 1)."""
    rng = np.random.default_rng(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def dense(i, o):
        return {"kernel": rng.standard_normal((i, o), np.float32) * i ** -0.5,
                "bias": np.zeros(o, np.float32)}

    def emb(n):
        return {"embedding": rng.standard_normal((n, e), np.float32)
                * e ** -0.5}

    def ln():
        return {"scale": np.ones(e, np.float32),
                "bias": np.zeros(e, np.float32)}
    bert = {"tok_emb": emb(v), "pos_emb": emb(cfg.max_position_embeddings),
            "seg_emb": emb(cfg.type_vocab_size), "emb_ln": ln()}
    for i in range(cfg.num_layers):
        bert[f"layer_{i}"] = {
            "attention": {"qkv": dense(e, 3 * e), "out": dense(e, e)},
            "attention_ln": ln(), "ffn_in": dense(e, f),
            "ffn_out": dense(f, e), "ffn_ln": ln()}
    return {"bert": bert, "mlm_transform": dense(e, e), "mlm_ln": ln(),
            "mlm_decoder": dense(e, v), "pooler": dense(e, e),
            "nsp": dense(e, 2)}


def mlm_batch(vocab, b, l, seed, ragged=False):
    """``examples/bert_pretraining.py``'s synthetic masked-LM batch, drawn
    with numpy: ``(input ids with 15% of positions set to 103, attention
    mask, labels = the original ids, mlm_mask, nsp labels)``.  The mask
    is all ones, or with ``ragged`` row i keeps its first ``l - 9 i``
    positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, l))
    pos = rng.random((b, l)) < 0.15
    attn = np.ones((b, l), np.int32)
    if ragged:
        attn = (np.arange(l)[None] < (l - 9 * np.arange(b))[:, None]) \
            .astype(np.int32)
    return (np.where(pos, 103, ids), attn, ids, pos.astype(np.float32),
            rng.integers(0, 2, b))


def _bert_loss(model, ids, attn, labels, mlm_mask, nsp):
    from apex_tpu_torch.models import pretraining_loss
    mlm, nspl = model(ids, None, attn)
    return pretraining_loss(mlm, nspl, labels, nsp, mlm_mask)


def _bert_batch(arrays, dev):
    import torch
    ids, attn, labels, mlm_mask, nsp = arrays
    return [torch.as_tensor(ids, device=dev), torch.as_tensor(attn,
                                                              device=dev),
            torch.as_tensor(labels, device=dev),
            torch.as_tensor(mlm_mask, device=dev),
            torch.as_tensor(nsp, device=dev)]


def _lamb_case(cfg):
    """K7, K8 and K9 over bert_large's fp32 master leaves (with bf16
    copies) against their plain versions: bitwise where the arithmetic is
    the same, the sums within rtol; repeats; the noop flag; timings."""
    import torch
    from apex_tpu_torch.ops.cuda import (lamb_stage1, lamb_stage1_ref,
                                         lamb_stage2, lamb_stage2_ref,
                                         packed_sumsq, packed_sumsq_ref)
    from apex_tpu_torch.ops.multi_tensor import ChunkTable
    from apex_tpu_torch.optimizers.fused_lamb import bias_corrections
    dev = torch.device("cuda")
    shapes = _leaf_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)

    def leaves(scale):
        return [torch.randn(s, generator=gen, device=dev) * scale
                for s in shapes]
    p, g, m = leaves(0.05), leaves(1e-2), leaves(1e-3)
    v = [t.abs() for t in leaves(1e-5)]
    copies = [torch.empty_like(t, dtype=torch.bfloat16) for t in p]
    table = ChunkTable.of(p)
    _, u = table.flat_views(shapes)
    n = sum(t.numel() for t in p)
    bc1, bc2 = bias_corrections(0.9, 0.999, torch.full(
        (len(shapes),), 3, dtype=torch.int32, device=dev))
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              max_grad_norm=1.0)
    recs = {}
    # K9
    s = packed_sumsq(table, g)
    s_again = packed_sumsq(table, g)
    s_ref = packed_sumsq_ref(table, g)
    torch.cuda.synchronize()
    require(torch.equal(s, s_again), "packed_sumsq: two runs differ")
    s_err = float((s - s_ref).abs()) / float(s_ref)
    require(s_err <= 1e-5, f"packed_sumsq off by {s_err} (relative)")
    # K7: twice from the same state for equal bits, and the plain version
    m0, v0 = [t.clone() for t in m], [t.clone() for t in v]
    parts = lamb_stage1(table, p, g, m, v, u, bc1, bc2, s, None, **kw)
    m1, v1 = [t.clone() for t in m0], [t.clone() for t in v0]
    _, u1 = table.flat_views(shapes)
    parts1 = lamb_stage1(table, p, g, m1, v1, u1, bc1, bc2, s, None, **kw)
    torch.cuda.synchronize()
    same1 = all(torch.equal(a, b) for xs, ys in
                zip((m, v, u) + parts, (m1, v1, u1) + parts1)
                for a, b in zip(xs, ys))
    require(same1, "lamb_stage1: two runs differ")
    del m1, v1, u1
    _, u_ref = table.flat_views(shapes)
    parts_ref = lamb_stage1_ref(table, p, g, m0, v0, u_ref, bc1, bc2, s,
                                None, **kw)
    torch.cuda.synchronize()
    equal1 = all(torch.equal(a, b) for xs, ys in
                 zip((m, v, u), (m0, v0, u_ref)) for a, b in zip(xs, ys))
    require(equal1, "lamb_stage1: m, v or u differ from the plain version")
    part_err = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                   for a, b in zip(parts, parts_ref))
    require(part_err <= 1e-5, f"lamb_stage1 partials off by {part_err}")
    del m0, v0, u_ref
    # K8: twice from the same p for equal bits, and the plain version
    p0 = [t.clone() for t in p]
    lamb_stage2(table, p, u, *parts, None, lr=1e-3, p_copy=copies)
    p1 = [t.clone() for t in p0]
    c1 = [torch.empty_like(t) for t in copies]
    lamb_stage2(table, p1, u, *parts, None, lr=1e-3, p_copy=c1)
    torch.cuda.synchronize()
    same2 = all(torch.equal(a, b) for xs, ys in ((p, p1), (copies, c1))
                for a, b in zip(xs, ys))
    require(same2, "lamb_stage2: two runs differ")
    del p1, c1
    lamb_stage2_ref(table, p0, u, *parts, None, lr=1e-3)
    torch.cuda.synchronize()
    p_err = max(_max_err(a, b) for a, b in zip(p, p0))
    require(all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
                for a, b in zip(p, p0)),
            f"lamb_stage2 differs from its plain version by {p_err}")
    require(all(torch.equal(c, t.to(torch.bfloat16))
                for c, t in zip(copies, p)), "lamb_stage2: bad bf16 copy")
    del p0
    # the noop flag: neither stage writes
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    kept = [[t.clone() for t in ts[:12]] for ts in (p, m, v, u, copies)]
    parts_n = lamb_stage1(table, p, g, m, v, u, bc1, bc2, s, flag, **kw)
    lamb_stage2(table, p, u, *parts_n, flag, lr=1e-3, p_copy=copies)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for xs, ys in zip((p, m, v, u, copies),
                                                    kept)
                for a, b in zip(xs, ys)), "a LAMB stage wrote under noop")
    del kept
    flag.zero_()
    # timings (every call of a stage updates its state in place)
    ms9 = time_ms(lambda: packed_sumsq(table, g))
    plain9 = time_ms(lambda: packed_sumsq_ref(table, g), budget_s=0.2)
    lib9 = time_ms(lambda: torch._foreach_norm(g))
    ms7 = time_ms(lambda: lamb_stage1(table, p, g, m, v, u, bc1, bc2, s,
                                      flag, **kw))
    plain7 = time_ms(lambda: lamb_stage1_ref(table, p, g, m, v, u, bc1,
                                             bc2, s, flag, **kw),
                     budget_s=0.5)
    ms8 = time_ms(lambda: lamb_stage2(table, p, u, *parts, flag, lr=1e-3,
                                      p_copy=copies))
    plain8 = time_ms(lambda: lamb_stage2_ref(table, p, u, *parts, flag,
                                             lr=1e-3, p_copy=copies),
                     budget_s=0.5)
    common = dict(shape=f"{len(shapes)} leaves, {n} elements",
                  leaves=len(shapes), elements=n, chunks=table.n_chunks,
                  chunk_size=table.chunk_size, bitwise_repeat=True)
    no_lib = ("no single PyTorch call computes a LAMB stage (torch.optim "
              "has no LAMB)")
    b9 = bound(4.0 * n, 2.0 * n, PEAK_FP32_FLOPS)
    recs["packed_sumsq"] = _kernel_rec(
        kernel="packed_sumsq", dtype="float32", max_abs_err=float(
            (s - s_ref).abs()), rel_err=s_err,
        tolerance="rtol 1e-5 vs the plain sum (another order)", ms=ms9,
        plain_ms=plain9, library_ms=lib9,
        library_call="torch._foreach_norm (per-leaf norms)",
        bound_ms=b9[0], bound_by=b9[1], **common)
    b7 = bound(28.0 * n, 20.0 * n, PEAK_FP32_FLOPS)
    recs["lamb_stage1"] = _kernel_rec(
        kernel="lamb_stage1", dtype="float32 p, g, m, v, u",
        max_abs_err=0.0, partials_rel_err=part_err,
        tolerance="m, v, u bitwise equal to the plain version; norm "
                  "partials rtol 1e-5", noop_flag_skips=True, ms=ms7,
        plain_ms=plain7, library_ms=None, library_null_reason=no_lib,
        bound_ms=b7[0], bound_by=b7[1], **common)
    b8 = bound(14.0 * n, 3.0 * n, PEAK_FP32_FLOPS)
    recs["lamb_stage2"] = _kernel_rec(
        kernel="lamb_stage2", dtype="float32 p, u; bfloat16 copy",
        max_abs_err=p_err,
        tolerance="p rtol 1e-6 + atol 1e-7 vs the plain version (per-leaf "
                  "norm sums in another order); copy = bf16(p)",
        noop_flag_skips=True, ms=ms8, plain_ms=plain8, library_ms=None,
        library_null_reason=no_lib, bound_ms=b8[0], bound_by=b8[1],
        **common)
    del p, g, m, v, u, copies, parts
    torch.cuda.empty_cache()
    return recs


def phase_bert_kernels(cfg):
    import torch
    rng = np.random.default_rng(3)
    recs = _lamb_case(cfg)
    # K6 on bert_large's 303 leaves (the NSP bias and kernel and the
    # 30522-row embedding among them), as the bert_train path runs it
    recs["packed_scale"] = _scale_case(_leaf_shapes(cfg), rng)
    n1 = BERT_B * BERT_L
    recs["layer_norm_fwd"] = _ln_case(n1, torch.bfloat16, rng,
                                      n2=cfg.hidden_size)
    recs["layer_norm_bwd"] = _ln_bwd_case(n1, cfg.hidden_size,
                                          torch.bfloat16, rng)
    shape = (BERT_B, BERT_L, cfg.num_heads, cfg.head_dim)
    recs["flash_attn_fwd"] = _flash_case(shape, rng, masked=True,
                                         causal=False)
    recs["flash_attn_bwd"], recs["flash_bwd_finish"] = _flash_bwd_case(
        shape, rng, causal=False, masked=True, rope=False)
    torch.cuda.empty_cache()
    return recs


def phase_bert_train(cfg):
    """bert_large at full width and depth, amp O2 + FusedLAMB (the
    example's defaults), B 32 x L 512 on one synthetic masked-LM batch."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import bert_params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedLAMB
    t0 = time.perf_counter()
    model = bert_params_from_jax(bert_tree(cfg, seed=5), cfg,
                                 trainable=True)
    setup_s = time.perf_counter() - t0
    opt = FusedLAMB(model.parameters(), lr=1e-3)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _bert_loss)
    batch = _bert_batch(mlm_batch(cfg.vocab_size, BERT_B, BERT_L, seed=8),
                        "cuda")
    n_leaves = len(a.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rows6 = TableRows()
    losses, scales, overflows, times = [], [], [], []
    for i in range(BERT_STEPS):
        t0 = time.perf_counter()
        out = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows6.mark()
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
        if i == 0:
            rows_first = (opt.table.lookups, opt.table.uploads)
    counts = launch_counts()
    # the chunk table's pointer rows: amp's gradient buffers keep their
    # storage, so every row is uploaded in the first step and none after
    rows = dict(lookups_step_1=rows_first[0], uploads_step_1=rows_first[1],
                lookups_later=opt.table.lookups - rows_first[0],
                uploads_later=opt.table.uploads - rows_first[1])
    require(rows["uploads_later"] == 0,
            f"pointer rows uploaded after the first step: {rows}")
    unscale_rows = rows6.report()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: c / BERT_STEPS for k, c in counts.items()}
    lnc = 2 * cfg.num_layers + 2
    want = dict(NO_LAUNCHES, layer_norm_fwd=lnc,
                flash_attn_fwd=cfg.num_layers,
                # two launches a call: dx with partials, then the dw/db sum
                layer_norm_bwd=2 * lnc, flash_attn_bwd=cfg.num_layers,
                # K4's q^ prologue (q pre-scaled; no rope) and finish pass
                flash_bwd_prologue=cfg.num_layers,
                flash_bwd_finish=cfg.num_layers,
                packed_scale=1, lamb_stage1=1, lamb_stage2=1,
                packed_sumsq=1)
    require(per_step == want, f"bert launches per step {per_step}, want "
                              f"{want}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(not any(overflows), f"overflow in the bert steps: {overflows}")
    p50 = float(np.median(times[2:])) * 1e3
    profile = profile_step(step, *batch)
    # one step with a non-finite gradient: skipped on the card
    with torch.enable_grad():
        loss = a.run(_bert_loss, model, *batch)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[11].view(-1)[5] = float("inf")
    masters = {n: t.clone() for n, t in a.masters.items()}
    moments = [(opt.state[t]["exp_avg"].clone(),
                opt.state[t]["exp_avg_sq"].clone())
               for t in a.masters.values()]
    steps = opt.param_groups[0]["leaf_steps"].clone()
    compute = a.params[0].detach().clone()
    scale_before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    torch.cuda.synchronize()
    require(bool(info["overflow"]), "the injected inf was not seen")
    require(float(info["loss_scale"]) == scale_before / 2,
            "the scale did not halve on overflow")
    require(all(torch.equal(masters[n], t) for n, t in a.masters.items()),
            "masters changed on a skipped step")
    require(all(torch.equal(opt.state[t]["exp_avg"], m0)
                and torch.equal(opt.state[t]["exp_avg_sq"], v0)
                for (m0, v0), t in zip(moments, a.masters.values())),
            "moments changed on a skipped step")
    # the timed steps and the profiled one
    require(torch.equal(opt.param_groups[0]["leaf_steps"], steps)
            and int(steps[0]) == BERT_STEPS + 1,
            "leaf step counts changed on a skipped step")
    require(torch.equal(a.params[0], compute),
            "compute params changed on a skipped step")
    emit("bert_train", model="bert_large", opt_level="O2",
         optimizer="FusedLAMB", lr=1e-3, eps=1e-6, weight_decay=0.01,
         max_grad_norm=1.0, batch=BERT_B, seq_len=BERT_L,
         steps=BERT_STEPS, parameters=sum(t.numel() for t in
                                          a.masters.values()),
         leaves=n_leaves, weights_from_seed_s=setup_s, losses=losses,
         loss_scales=scales, step_ms=[t * 1e3 for t in times],
         step_ms_p50_steps_3_to_10=p50,
         unscale_pointer_rows=unscale_rows,
         sequences_per_s=BERT_B / (p50 / 1e3),
         tokens_per_s=BERT_B * BERT_L / (p50 / 1e3), peak_memory_gb=peak,
         launches=counts, launches_per_step=per_step, pointer_rows=rows,
         profile=profile,
         injected_overflow={"skipped": True, "loss_scale": [
             scale_before, float(info["loss_scale"])]})
    del a, opt, model, grads, masters, moments, step, batch
    torch.cuda.empty_cache()
    return counts


def phase_bert_train_reference():
    """A 2-layer 2 x 64-head BERT, 3 FusedLAMB steps on the card (kernels)
    against the same on the CPU (plain versions) from the same weights,
    with a ragged key mask: fp32 O0, then bf16 O2."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import bert_params_from_jax
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=256,
                     max_position_embeddings=128)
    tree = bert_tree(cfg, seed=6)
    arrays = mlm_batch(cfg.vocab_size, 4, 128, seed=7, ragged=True)

    out = {}
    for level in ("O0", "O2"):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = bert_params_from_jax(tree, cfg, device=dev,
                                         trainable=True)
            a = amp.initialize(model, FusedLAMB(model.parameters(),
                                                lr=1e-3, device=dev),
                               opt_level=level, device=dev)
            step = amp.make_train_step(a, model, _bert_loss)
            batch = _bert_batch(arrays, dev)
            losses = [float(step(*batch)["loss"]) for _ in range(3)]
            masters = masters_np(a)
            runs[dev] = (losses, masters)
        (lg, pg), (lc, pc) = runs["cuda"], runs["cpu"]
        require(all(np.isfinite(lg)) and lg[-1] < lg[0],
                f"{level} bert losses on the card: {lg}")
        out[level] = dict(losses_card=lg, losses_cpu=lc,
                          loss_max_abs_err=max(abs(x - y)
                                               for x, y in zip(lg, lc)),
                          param_max_abs_err=max(
                              float(np.abs(v - pc[k]).max())
                              for k, v in pg.items()))
    o0, o2 = out["O0"], out["O2"]
    require(o0["loss_max_abs_err"] <= 1e-4,
            f"fp32 bert losses card vs CPU differ by "
            f"{o0['loss_max_abs_err']}")
    require(o0["param_max_abs_err"] <= BERT_REF_PARAM_TOL,
            f"fp32 bert masters card vs CPU differ by "
            f"{o0['param_max_abs_err']}")
    require(o2["loss_max_abs_err"] <= BERT_REF_O2_LOSS_TOL,
            f"O2 bert losses card vs CPU differ by "
            f"{o2['loss_max_abs_err']}")
    emit("bert_train_reference", steps=3, kv_mask="ragged",
         O0=dict(o0, dtype="float32", loss_tolerance=1e-4,
                 param_tolerance=BERT_REF_PARAM_TOL),
         O2=dict(o2, dtype="bfloat16 compute, fp32 masters",
                 loss_tolerance=BERT_REF_O2_LOSS_TOL))


# -- the ResNet slice -----------------------------------------------------

#: ResNet-50's 1x1 stride-1 convs at B 256 x 224^2, (M, cin, cout, calls a
#: step): conv1 and conv3 of the 16 bottlenecks and stage 0's projection,
#: 33 calls of K16 a step with the switch on
RN50_CONV1X1 = ((802816, 64, 64, 1), (802816, 64, 256, 4),
                (802816, 256, 64, 2), (802816, 256, 128, 1),
                (200704, 512, 128, 3), (200704, 128, 512, 4),
                (200704, 512, 256, 1), (50176, 1024, 256, 5),
                (50176, 256, 1024, 6), (50176, 1024, 512, 1),
                (12544, 2048, 512, 2), (12544, 512, 2048, 3))
RN_B = 256
RN_SIZE = 224
RN_STEPS = 10
RN_LR = 1e-3
CONV1X1_ENV = "APEX_TPU_FUSED_CONV1X1"


def conv1x1_switch(on: bool):
    """``APEX_TPU_FUSED_CONV1X1`` set to 1 (or cleared)."""
    return env_set(CONV1X1_ENV, "1" if on else None)


def _conv1x1_case(m, cin, cout, dtype, seed, calls=None):
    """K16 against its plain version at one shape: dx by ``scaled_errs``
    and within 2 ulps of its largest element (``bf16_tol``; fp32: 1e-5
    of it), dW within the same bound (both sum in fp32 and round once,
    in other orders), a second run equal bit for bit; kernel, plain and
    ``aten.convolution_backward`` (cuDNN's dgrad + wgrad of the same conv,
    the weight given as the route's strided HWIO view) times, the copy
    of that view to OIHW, and the bound."""
    import torch
    from apex_tpu_torch.ops.cuda import build, conv1x1_bwd, conv1x1_bwd_ref
    from apex_tpu_torch.ops.cuda import conv1x1 as c1_mod
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, cin), generator=g, device="cuda").to(dtype)
    dy = torch.randn((m, cout), generator=g, device="cuda").to(dtype)
    w = (torch.randn((cin, cout), generator=g, device="cuda")
         * cin ** -0.5).to(dtype)
    dx, dw = conv1x1_bwd(x, dy, w)
    dx2, dw2 = conv1x1_bwd(x, dy, w)
    torch.cuda.synchronize()
    require(torch.equal(dx, dx2) and torch.equal(dw, dw2),
            f"conv1x1_bwd {(m, cin, cout)} does not repeat bitwise")
    rdx, rdw = conv1x1_bwd_ref(x, dy, w)
    tol = {}
    for name, got, ref in (("dx", dx, rdx), ("dw", dw, rdw)):
        lim = (bf16_tol(ref) if dtype != torch.float32
               else 1e-5 * max(1.0, float(ref.abs().max())))
        err = _max_err(got, ref)
        require(err <= lim, f"conv1x1_bwd {name} {(m, cin, cout)} "
                            f"{dtype}: max err {err} > {lim}")
        tol[name] = (err, lim)
    scaled = scaled_errs(f"conv1x1_bwd dx {(m, cin, cout)}", dx, rdx)
    item = x.element_size()
    nbytes = item * (2 * m * cin + m * cout) + 2 * item * cin * cout
    flops = 4.0 * m * cin * cout
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    bms, by = bound(nbytes, flops, peak)
    # the conv as the route hands it to cuDNN: NCHW channels-last views
    # of NHWC tensors (B 256 at a square size where M allows, else one
    # image of M x 1), the HWIO kernel seen as OIHW
    side = int(round((m // RN_B) ** 0.5))
    nhw = (RN_B, side, side) if RN_B * side * side == m else (1, m, 1)
    x4 = x.view(*nhw, cin).permute(0, 3, 1, 2)
    dy4 = dy.view(*nhw, cout).permute(0, 3, 1, 2)
    w4 = w.view(1, 1, cin, cout).permute(3, 2, 0, 1)

    def library():
        return torch.ops.aten.convolution_backward(
            dy4, x4, w4, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
            [True, True, False])

    ldx, ldw, _ = library()
    if hasattr(c1_mod, "conv1x1_route"):   # a parent tree may lack it
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, w, dx, dw))
        route = c1_mod.conv1x1_route(m, cin, cout, dtype, aligned)
        plan = dict(c1_mod.plan(m, cin, cout, route))
    else:
        route = None
        plan = {"planes": build.library().apex_conv1x1_bwd_split(
            m, cin, cout)}
    lib_err = [_max_err(ldx.permute(0, 2, 3, 1).reshape(m, cin), rdx),
               _max_err(ldw.reshape(cout, cin).t(), rdw)]
    rec = dict(kernel="conv1x1_bwd", shape=[m, cin, cout],
               dtype=str(dtype).replace("torch.", ""), calls_a_step=calls,
               dx_max_abs_err=tol["dx"][0], dx_tolerance=tol["dx"][1],
               dw_max_abs_err=tol["dw"][0], dw_tolerance=tol["dw"][1],
               max_abs_err=max(tol["dx"][0], tol["dw"][0]),
               route=route, plan=plan, dw_partial_planes=plan["planes"],
               ms=time_ms(lambda: conv1x1_bwd(x, dy, w)),
               plain_ms=time_ms(lambda: conv1x1_bwd_ref(x, dy, w)),
               library_ms=time_ms(library),
               weight_to_oihw_copy_ms=time_ms(lambda: w4.contiguous()),
               bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
               library_dx_dw_max_abs_err=lib_err, nhw=list(nhw),
               bitwise_repeat=True, **scaled)
    del x, dy, w, dx, dw, dx2, dw2, rdx, rdw, ldx, ldw
    return _kernel_rec(**rec)


def phase_resnet_kernels():
    """K16 at ResNet-50's 12 shapes of 1x1 stride-1 convs (bf16, B 256 x
    224^2), in fp32 at one of them, and at ragged shapes; K6 and K11 at
    ResNet-50's 161 leaves as its O2 step gives them (bf16 gradients but
    for the fp32 BatchNorm leaves; fp32 masters, moments and gradients,
    the compute copies made after the kernel since their dtypes mix)."""
    import torch
    from apex_tpu_torch.amp import default_keep_fp32_filter
    from apex_tpu_torch.models import ARCHS
    named = list(ARCHS["resnet50"](device="meta").named_parameters())
    shapes = [tuple(p.shape) for _, p in named]
    dtypes = [torch.float32 if default_keep_fp32_filter(n.split("."))
              else torch.bfloat16 for n, _ in named]
    others = {"packed_scale": _scale_case(shapes, np.random.default_rng(9),
                                          dtypes=dtypes),
              "packed_adam_tree": _adam_tree_case(shapes, torch.float32,
                                                  torch.float32, False)}
    recs = [_conv1x1_case(m, cin, cout, torch.bfloat16, i, calls)
            for i, (m, cin, cout, calls) in enumerate(RN50_CONV1X1)]
    # every route off the ResNet path: fp32 and a half type off the 8 grid
    # (fma), a ragged two_role shape, one 64 x 64 dW tile (one_pass)
    extra = [_conv1x1_case(50176, 1024, 256, torch.float32, 20),
             _conv1x1_case(12345, 192, 320, torch.bfloat16, 21),
             _conv1x1_case(1001, 24, 40, torch.float32, 22),
             _conv1x1_case(1001, 20, 36, torch.bfloat16, 23),
             _conv1x1_case(1000, 24, 40, torch.float16, 24)]
    step = dict(
        k16_calls_a_step=sum(r["calls_a_step"] for r in recs),
        k16_ms_a_step=sum(r["ms"] * r["calls_a_step"] for r in recs),
        bound_ms_a_step=sum(r["bound_ms"] * r["calls_a_step"]
                            for r in recs),
        convolution_backward_ms_a_step=sum(
            r["library_ms"] * r["calls_a_step"] for r in recs),
        worst_vs_convolution_backward=max(r["ms"] / r["library_ms"]
                                          for r in recs))
    emit("resnet_kernels", **step)
    torch.cuda.empty_cache()
    return recs, extra, others, step


def _rn_loss(model, x, y):
    from apex_tpu_torch.models import resnet_loss
    return resnet_loss(model(x, train=True), y)


def _routed_convs(model) -> int:
    from apex_tpu_torch.layers import Conv
    return sum(1 for m in model.modules() if isinstance(m, Conv)
               and tuple(m.kernel.shape[:2]) == (1, 1)
               and m.strides == (1, 1))


def _rn_run(step, x, y, steps, want):
    """``steps`` timed steps; launches per step must equal ``want``."""
    import torch
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rows6 = TableRows()
    losses, scales, overflows, times = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows6.mark()
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
    counts = launch_counts()
    per_step = {k: c / steps for k, c in counts.items()}
    require(per_step == want, f"resnet launches per step {per_step}, "
                              f"want {want}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(not any(overflows), f"overflow in the resnet steps: "
                                f"{overflows}")
    p50 = float(np.median(times[2:])) * 1e3
    return counts, dict(
        losses=losses, loss_scales=scales, step_ms=[t * 1e3 for t in times],
        step_ms_p50_steps_3_to_10=p50, images_per_s=RN_B / (p50 / 1e3),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, launches_per_step=per_step,
        unscale_pointer_rows=rows6.report())


def phase_resnet_train():
    """ResNet-50 (``ARCHS["resnet50"]``, 1000 classes, seeded weights on
    the card), amp O2 + FusedAdam(lr=1e-3), B 256 x 224^2 on one fixed
    synthetic batch of ``examples/imagenet_main_amp.py``: 10 steps with
    ``APEX_TPU_FUSED_CONV1X1`` off, then 10 with it on, each with one
    profiled step; an eval pass on the running stats; an injected
    overflow skipped on the card."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ARCHS, accuracy, synthetic_batch
    from apex_tpu_torch.optimizers import FusedAdam
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = ARCHS["resnet50"]()
    setup_s = time.perf_counter() - t0
    opt = FusedAdam(model.parameters(), lr=RN_LR)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _rn_loss)
    x, y = synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                           RN_B, RN_SIZE)
    n_leaves, routed = len(a.params), _routed_convs(model)
    # 161 leaves (53 conv kernels, 53 BN scale / bias pairs, fc kernel and
    # bias), 33 routed convs
    require((n_leaves, routed) == (161, 33),
            f"resnet50: {n_leaves} leaves, {routed} routed convs")
    want_off = dict(NO_LAUNCHES, packed_scale=1, packed_adam_tree=1)
    want_on = dict(want_off, conv1x1_bwd=routed)
    runs = {}
    for on, want in ((False, want_off), (True, want_on)):
        with conv1x1_switch(on):
            counts, run = _rn_run(step, x, y, RN_STEPS, want)
            run["profile"] = profile_step(step, x, y)
        runs["switch_on" if on else "switch_off"] = (counts, run)
    losses = (runs["switch_off"][1]["losses"]
              + runs["switch_on"][1]["losses"])
    require(losses[-1] < losses[0], f"resnet loss did not fall: {losses}")
    # eval with the running stats (the example's validate: the O2 input
    # cast, fp32 logits)
    with torch.no_grad():
        logits = a.run(lambda m, t: m(t, train=False), model, x)
    require(tuple(logits.shape) == (RN_B, 1000)
            and bool(torch.isfinite(logits).all()),
            "eval logits not finite or misshapen")
    top1, top5 = (float(t) for t in accuracy(logits, y, (1, 5)))
    # one step with a non-finite gradient: skipped on the card, while the
    # forward still moves the running stats
    stats = {n: b.clone() for n, b in model.named_buffers()}
    with torch.enable_grad():
        loss = a.run(_rn_loss, model, x, y)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[3][(0,) * grads[3].dim()] = float("inf")   # a strided grad
    masters = {n: t.clone() for n, t in a.masters.items()}
    st = opt.state[a.masters["fc.kernel"]]
    moments = (st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
               int(st["step"]))
    compute = a.params[0].detach().clone()
    scale_before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    torch.cuda.synchronize()
    require(bool(info["overflow"]), "the injected inf was not seen")
    require(float(info["loss_scale"]) == scale_before / 2,
            "the scale did not halve on overflow")
    require(all(torch.equal(masters[n], t) for n, t in a.masters.items()),
            "masters changed on a skipped step")
    require(torch.equal(st["exp_avg"], moments[0])
            and torch.equal(st["exp_avg_sq"], moments[1])
            and int(st["step"]) == moments[2],
            "moments or step counts changed on a skipped step")
    require(torch.equal(a.params[0], compute),
            "compute params changed on a skipped step")
    moved = sum(not torch.equal(stats[n], b)
                for n, b in model.named_buffers())
    require(moved == len(stats), f"the overflow step's forward moved "
                                 f"{moved} of {len(stats)} running stats")
    emit("resnet_train", model="resnet50", opt_level="O2",
         optimizer="FusedAdam", lr=RN_LR, batch=RN_B, image_size=RN_SIZE,
         steps_each=RN_STEPS, parameters=sum(t.numel() for t in
                                             a.masters.values()),
         leaves=n_leaves, routed_1x1_convs=routed,
         weights_from_seed_s=setup_s,
         switch_off=runs["switch_off"][1], switch_on=runs["switch_on"][1],
         eval_top1=top1, eval_top5=top5,
         injected_overflow={"skipped": True, "loss_scale": [
             scale_before, float(info["loss_scale"])],
             "running_stats_moved": moved})
    del a, opt, model, grads, masters, step, x, y, logits
    torch.cuda.empty_cache()
    p50 = {k: r[1]["step_ms_p50_steps_3_to_10"] for k, r in runs.items()}
    STEP_P50["resnet_train"] = p50["switch_off"]
    return runs["switch_on"][0], runs["switch_off"][0], p50


#: the small ResNet's fp32 card-vs-CPU losses: both run fp32 (no TF32 on
#: either side) and sum in other orders; BatchNorm over 8 images at 1 x 1
#: in stage 3 amplifies that (the CPU tests measure 2.9e-6 against JAX
#: over the same 3 steps)
RN_REF_LOSS_TOL = 1e-4


def phase_resnet_reference():
    """A small Bottleneck ResNet (stages (1, 1, 1, 1), width 8, 10
    classes), fp32 O0 + FusedAdam, 3 steps at B 8 x 32^2 on the card
    against the same on the CPU from the same weights, with the switch
    off and on (on the card: 9 K16 launches a step, fp32)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    kw = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
    torch.manual_seed(3)
    state = ResNet(device="cpu", **kw).state_dict()
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.standard_normal((8, 32, 32, 3),
                                              dtype=np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, 8))
    out = {}
    for on in (False, True):
        runs = {}
        for dev in ("cuda", "cpu"):
            with conv1x1_switch(on):
                model = ResNet(device=dev, **kw)
                model.load_state_dict(state)
                a = amp.initialize(model, FusedAdam(model.parameters(),
                                                    lr=RN_LR, device=dev),
                                   opt_level="O0", device=dev)
                step = amp.make_train_step(a, model, _rn_loss)
                reset_launch_counts()
                losses = [float(step(xs.to(dev), ys.to(dev))["loss"])
                          for _ in range(3)]
                runs[dev] = (losses, launch_counts()["conv1x1_bwd"])
        (lg, k16), (lc, _) = runs["cuda"], runs["cpu"]
        err = max(abs(p - q) for p, q in zip(lg, lc))
        require(all(np.isfinite(lg)) and lg[-1] < lg[0],
                f"small resnet losses on the card: {lg}")
        require(err <= RN_REF_LOSS_TOL, f"fp32 resnet losses card vs CPU "
                                        f"differ by {err}")
        require(k16 == (3 * 9 if on else 0), f"K16 launched {k16} times")
        out["switch_on" if on else "switch_off"] = dict(
            losses_card=lg, losses_cpu=lc, loss_max_abs_err=err,
            k16_launches=k16)
    emit("resnet_reference", steps=3, dtype="float32", batch=8,
         image_size=32, loss_tolerance=RN_REF_LOSS_TOL, **out)


# -- the fourteenth slice: data parallelism across processes -------------

DDP_REF_STEPS = 3


def adam_drift_bound(steps: int, lr: float, betas=(0.9, 0.999)) -> float:
    """The most two Adam runs from the same masters can drift apart per
    element in ``steps`` steps, whatever their gradients: twice the sum
    of each step's largest update, ``lr * max |m_hat| / sqrt(v_hat)``,
    which Cauchy-Schwarz bounds by ``sqrt(sum(w1^2 / w2) * sum(w2)) /
    sum(w1)`` over the moments' weights ``w1 = (1 - b1) b1^(t-i)``, ``w2
    = (1 - b2) b2^(t-i)`` (1 at step 1, 1.0014 at 2, 1.0036 at 3)."""
    b1, b2 = betas
    total = 0.0
    for t in range(1, steps + 1):
        w1 = [(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)]
        w2 = [(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)]
        total += (sum(a * a / b for a, b in zip(w1, w2)) * sum(w2)) ** 0.5 \
            / sum(w1)
    return 2.0 * lr * total


#: ResNet-50 O2 at random init is chaotic in its gradients: a one-ulp
#: change of the BatchNorm means (what the synchronized merge's ``c * mean
#: / c`` makes) moves them as much as they move at all (the ``ddp`` line's
#: ``first_gradients``), so Adam's sign-like first steps send up to half
#: the masters opposite ways.  The masters are held to Adam's drift
#: bound (plus fp32 rounding of 3 updates of masters below 2 in size:
#: 1e-5), which only a non-finite or runaway master breaks; the losses
#: carry the comparison, within the card-vs-CPU bf16 limit (PERF.md
#: section 2); the CPU tests hold the same steps bitwise and against JAX
DDP_MASTER_TOL = adam_drift_bound(DDP_REF_STEPS, RN_LR) + 1e-5
DDP_LOSS_TOL = 2e-2
DDP_GLOO_B = 64
DDP_GLOO_WORLD = 2
DDP_DEADLINE_S = 600
#: the device ranges the port annotates in a DDP step
DDP_RANGES = ("ddp_bucket_pack", "ddp_bucket_unpack", "sync_bn_stats",
              "sync_bn_backward")


def _rn_loss_poisoned(model, x, y, poison):
    from apex_tpu_torch.models import resnet_loss
    return resnet_loss(model(x, train=True), y) * (1 + poison.sum())


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes in order (bitwise equality across
    processes)."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _masters_err(a_masters, b_masters) -> dict:
    errs = [float((a_masters[n] - b_masters[n]).abs().max())
            for n in a_masters]
    beyond = sum(int(((a_masters[n] - b_masters[n]).abs() > 1e-3).sum())
                 for n in a_masters)
    total = sum(t.numel() for t in a_masters.values())
    return {"max_abs_err": max(errs), "share_beyond_1e-3": beyond / total}


def _ddp_model(state, sync: bool):
    """ResNet-50 on the card from ``state``; with ``sync`` converted by
    ``convert_syncbn_model`` (every BatchNorm over the default group)."""
    from apex_tpu_torch.models import ARCHS
    from apex_tpu_torch.parallel import convert_syncbn_model
    model = ARCHS["resnet50"]()
    model.load_state_dict(state)
    return convert_syncbn_model(model) if sync else model


def _grads_err(ref, got) -> dict:
    """Each leaf's max |got - ref| over its largest |ref| (the worst and
    the median leaf), and the share of elements whose sign differs."""
    rel = sorted(float((g.float() - r.float()).abs().max()
                       / r.float().abs().max().clamp(min=1e-30))
                 for r, g in zip(ref, got))
    flips = sum(int(((g > 0) != (r > 0)).sum()) for r, g in zip(ref, got))
    return {"worst_leaf": rel[-1], "median_leaf": rel[len(rel) // 2],
            "sign_flip_share": flips / sum(r.numel() for r in ref)}


def _ddp_rank_nccl(out: Path) -> None:
    """One rank of the NCCL world-size-one run (a ``--ddp-rank nccl``
    process): ResNet-50 O2 + FusedAdam at B 256 x 224^2 from seeded
    weights, world-one and through ``convert_syncbn_model`` +
    ``DistributedDataParallel``: the first gradients of each (and of the
    world-one model twice: the card's own spread), 3 steps of each held
    against each other, then 10 timed steps of each (launches and
    collectives a step) and one profiled DDP step.  The results go to
    ``nccl.json`` before any check."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ARCHS, synthetic_batch
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (DistributedDataParallel,
                                         collective_counts, multiproc,
                                         reset_collective_counts)
    from apex_tpu_torch.parallel import sync_batchnorm as sbn
    multiproc.initialize()
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            f"nccl world: {dist.get_backend()} x {dist.get_world_size()}")
    torch.manual_seed(0)
    state = ARCHS["resnet50"]().state_dict()
    x, y = synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                           RN_B, RN_SIZE)
    want = dict(NO_LAUNCHES, packed_scale=1, packed_adam_tree=1)
    ddp = DistributedDataParallel()
    runs = {}
    for name, sync in (("world_one", False), ("ddp", True)):
        model = _ddp_model(state, sync)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=RN_LR),
                           opt_level="O2")
        runs[name] = (model, a, amp.make_train_step(
            a, model, _rn_loss, reduce_fn=ddp.reduce if sync else None))

    def first_grads(name, nudge=False):
        """The first (unscaled) gradients; ``nudge``: every BatchNorm's
        batch mean one fp32 ulp up, the model's own sensitivity."""
        model, a, _ = runs[name]
        plain = sbn.local_mean_var
        if nudge:
            def nudged(t, axes):
                mean, var, count = plain(t, axes)
                return mean * (1 + 2.0 ** -23), var, count
            sbn.local_mean_var = nudged
        try:
            with torch.enable_grad():
                loss = a.run(_rn_loss, model, x, y)
                grads = torch.autograd.grad(loss, a.params)
        finally:
            sbn.local_mean_var = plain
        return list(ddp.reduce(grads)) if name == "ddp" else list(grads)

    g_one = first_grads("world_one")
    res = {"first_gradients": {
        "world_one_again": _grads_err(g_one, first_grads("world_one")),
        "world_one_means_one_ulp_up": _grads_err(
            g_one, first_grads("world_one", nudge=True)),
        "ddp": _grads_err(g_one, first_grads("ddp"))}}
    del g_one
    snap = {}
    for name in ("world_one", "ddp"):
        model, a, step = runs[name]
        infos = [step(x, y) for _ in range(DDP_REF_STEPS)]
        snap[name] = {n: t.clone() for n, t in a.masters.items()}
        reset_collective_counts()
        counts, run = _rn_run(step, x, y, RN_STEPS, want)
        run["first_losses"] = [float(i["loss"]) for i in infos]
        run["first_overflows"] = [bool(i["overflow"]) for i in infos]
        run["collectives_a_step"] = {
            k: v / RN_STEPS for k, v in collective_counts().items()}
        if name == "ddp":
            by_dtype = {}
            for p in a.params:
                by_dtype.setdefault(str(p.dtype).replace("torch.", ""),
                                    []).append(p)
            run["buckets"] = {dt: int(ddp.plan_buckets(ps)[-1]) + 1
                              for dt, ps in by_dtype.items()}
            run["batchnorms"] = sum(1 for n, _ in model.named_buffers()
                                    if n.endswith(".mean"))
            run["profile"] = profile_step(step, x, y, ranges=DDP_RANGES)
        res[name] = run
        del runs[name], model, a, step
        torch.cuda.empty_cache()
    res["losses_max_abs_err"] = max(
        abs(p - q) for p, q in zip(res["world_one"]["first_losses"],
                                   res["ddp"]["first_losses"]))
    res["masters"] = _masters_err(snap["world_one"], snap["ddp"])
    res["step_ms_p50"] = {k: res[k]["step_ms_p50_steps_3_to_10"]
                          for k in ("world_one", "ddp")}
    (out / "nccl.json").write_text(json.dumps(res))
    expect = 3 * res["ddp"]["batchnorms"] + sum(
        res["ddp"]["buckets"].values())
    require(res["ddp"]["collectives_a_step"] == {"all_reduce": expect},
            f"collectives a step {res['ddp']['collectives_a_step']}, want "
            f"{expect} all_reduces (3 a BatchNorm and one a bucket)")
    require(res["losses_max_abs_err"] <= DDP_LOSS_TOL,
            f"ddp losses {res['ddp']['first_losses']} vs world-one "
            f"{res['world_one']['first_losses']}")
    require(res["masters"]["max_abs_err"] <= DDP_MASTER_TOL,
            f"ddp masters off the world-one ones: {res['masters']}")
    dist.destroy_process_group()


def _ddp_rank_gloo(out: Path) -> None:
    """One rank of the two-process gloo run on ``cuda:0`` (a
    ``--ddp-rank gloo`` process): ResNet-50 O2 + FusedAdam, this rank's
    32 of 64 images (``shard_rows``), 3 DDP + SyncBatchNorm steps from
    the seeded weights (``broadcast_params`` from rank 0 first), digests
    of the masters and running stats, then a step with an inf on rank 1
    only.  Rank 0 first runs the world-one reference: the whole batch, 3
    steps, local BatchNorm."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ARCHS, shard_rows, synthetic_batch
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedDataParallel, multiproc
    multiproc.initialize(backend="gloo")
    r, w = dist.get_rank(), dist.get_world_size()
    torch.manual_seed(0)
    state = ARCHS["resnet50"]().state_dict()
    x, y = synthetic_batch(torch.Generator(device="cuda").manual_seed(2),
                           DDP_GLOO_B, RN_SIZE)
    res = {"rank": r, "world": w, "backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    if r == 0:
        model = _ddp_model(state, False)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=RN_LR),
                           opt_level="O2")
        step = amp.make_train_step(a, model, _rn_loss)
        res["reference_losses"] = [float(step(x, y)["loss"])
                                   for _ in range(DDP_REF_STEPS)]
        ref = {n: t.clone() for n, t in a.masters.items()}
        del a, model, step
    model = _ddp_model(state, True)
    ddp = DistributedDataParallel()
    ddp.broadcast_params(model, root=0)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=RN_LR),
                       opt_level="O2")
    step = amp.make_train_step(a, model, _rn_loss_poisoned,
                               reduce_fn=ddp.reduce)
    xl, yl = shard_rows([x, y], r, w)
    clean = torch.zeros(xl.shape[0], device="cuda")
    infos = [step(xl, yl, clean) for _ in range(DDP_REF_STEPS)]
    res["losses"] = [float(i["loss"]) for i in infos]
    res["overflow"] = [bool(i["overflow"]) for i in infos]
    res["masters_sha256"] = _digest(a.masters.values())
    res["running_stats_sha256"] = _digest(model.buffers())
    if r == 0:
        res["masters_vs_reference"] = _masters_err(ref, a.masters)
    poison = clean.clone()
    if r == 1:
        poison[0] = float("inf")
    scale = float(a.scaler_state.loss_scale)
    info = step(xl, yl, poison)
    res["inf_on_rank_1"] = {
        "overflow": bool(info["overflow"]),
        "loss_scale": [scale, float(info["loss_scale"])],
        "masters_kept": _digest(a.masters.values())
        == res["masters_sha256"]}
    (out / f"gloo{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _spawn_ranks(mode: str, world: int, repo: Path, out: Path) -> float:
    """``python -m apex_tpu_torch.parallel.multiproc chip_smoke.py
    --ddp-rank mode`` (the port's spawner: rank 0's stdout, every rank's
    stderr in ``out``), killed with every rank at ``DDP_DEADLINE_S``;
    fails the phase with the launcher's stderr when a rank fails.
    Returns the seconds it took."""
    import signal
    env = dict(os.environ, WORLD_SIZE=str(world),
               APEX_TPU_INIT_TIMEOUT_S="300", APEX_TPU_INIT_RETRIES="0",
               PYTHONPATH=str(repo) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         str(Path(__file__).resolve()), "--repo", str(repo), "--ddp-rank",
         mode, "--ddp-out", str(out)], cwd=out, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        so, se = proc.communicate(timeout=DDP_DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"ddp {mode} ranks still running at "
                           f"{DDP_DEADLINE_S} s; killed")
    require(proc.returncode == 0, f"ddp {mode} ranks failed "
                                  f"({proc.returncode}): {se[-3000:]}")
    return time.perf_counter() - t0


def _larc_case():
    """LARC at ResNet-50's 161 fp32 leaves on the card: the per-leaf
    parameter and gradient norms of K12 (two launches) against its plain
    version, and the rescaled gradients against LARC's on the CPU."""
    import torch
    from apex_tpu_torch.models import ARCHS
    from apex_tpu_torch.ops.cuda import (launch_counts, reset_launch_counts,
                                         sumsq_per_tensor_ref)
    from apex_tpu_torch.ops.multi_tensor import (CHUNK_SIZE, ChunkTable,
                                                 per_tensor_sumsq)
    from apex_tpu_torch.optimizers import larc
    shapes = [tuple(p.shape) for p in
              ARCHS["resnet50"](device="meta").parameters()]
    gen = torch.Generator(device="cuda").manual_seed(31)
    ps = _fp32_leaves(shapes, gen, 1e-2)
    gs = _fp32_leaves(shapes, gen, 1e-3)
    rel = 0.0
    for xs in (ps, gs):
        got = per_tensor_sumsq(CHUNK_SIZE, [xs])
        ref = sumsq_per_tensor_ref(ChunkTable.of(xs), xs)
        rel = max(rel, float(((got - ref).abs()
                              / ref.abs().clamp(min=1e-30)).max()))
    require(rel <= 1e-6, f"LARC norms (K12) off by {rel} (relative)")
    reset_launch_counts()
    out = larc(gs, ps, 0.1, weight_decay=1e-4)
    torch.cuda.synchronize()
    k12 = launch_counts()["sumsq_per_tensor"]
    require(k12 == 2, f"larc launched K12 {k12} times, want 2")
    cpu = larc([g.cpu() for g in gs], [p.cpu() for p in ps], 0.1,
               weight_decay=1e-4)
    err = max(float(((o.cpu() - c).abs()
                      / c.abs().max().clamp(min=1e-30)).max())
              for o, c in zip(out, cpu))
    require(err <= 1e-5, f"LARC on the card vs the CPU: {err}")
    return dict(leaves=len(shapes), norms_rel_err=rel,
                norms_tolerance="rtol 1e-6 per leaf vs the plain sums",
                k12_launches=k12, rescaled_vs_cpu_rel_err=err,
                ms=time_ms(lambda: larc(gs, ps, 0.1, weight_decay=1e-4)))


def phase_ddp(repo: Path):
    """Data parallelism across processes: the port's ``multiproc``
    spawner re-runs this script as the ranks.  NCCL at world size one
    (ResNet-50 O2, B 256 x 224^2: DDP + SyncBatchNorm held against the
    world-one step, both timed); gloo, two processes on ``cuda:0``
    (ResNet-50 O2, B 2 x 32, against the whole-batch B 64 world-one run;
    bitwise-equal masters and running stats; an inf on rank 1 skipped
    on both); LARC's K12 norms at ResNet-50's 161 leaves.  No path across
    several cards runs here."""
    import shutil
    import torch
    torch.cuda.empty_cache()
    out = HERE / "build" / "ddp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # both runs go before a failure of either is raised
    failed, secs = [], {}
    for mode, world in (("nccl", 1), ("gloo", DDP_GLOO_WORLD)):
        try:
            secs[mode] = _spawn_ranks(mode, world, repo, out)
        except SmokeFailure as e:
            failed.append(str(e))
    for name in ("nccl.json", "gloo0.json", "gloo1.json") if failed else ():
        if (out / name).exists():
            print(f"ddp {name}: {(out / name).read_text()[:20000]}",
                  file=sys.stderr)
    require(not failed, "; ".join(failed))
    nccl_s, gloo_s = secs["nccl"], secs["gloo"]
    nccl = json.loads((out / "nccl.json").read_text())
    ranks = [json.loads((out / f"gloo{r}.json").read_text())
             for r in range(DDP_GLOO_WORLD)]
    ref = ranks[0]["reference_losses"]
    mean = [float(np.mean(ls)) for ls in zip(*(rk["losses"]
                                               for rk in ranks))]
    loss_err = max(abs(p - q) for p, q in zip(ref, mean))
    require(all(rk["backend"] == "gloo" and rk["device"] == 0
                for rk in ranks), f"gloo ranks: {ranks}")
    require(loss_err <= DDP_LOSS_TOL,
            f"gloo DDP losses {mean} vs the whole batch {ref}")
    mr = ranks[0]["masters_vs_reference"]
    require(mr["max_abs_err"] <= DDP_MASTER_TOL,
            f"gloo DDP masters off the whole batch's: {mr}")
    require(len({rk["masters_sha256"] for rk in ranks}) == 1,
            "the gloo ranks' masters differ")
    require(len({rk["running_stats_sha256"] for rk in ranks}) == 1,
            "the gloo ranks' running stats differ")
    for rk in ranks:
        inf = rk["inf_on_rank_1"]
        require(inf["overflow"] and inf["masters_kept"]
                and inf["loss_scale"][1] == inf["loss_scale"][0] / 2,
                f"rank {rk['rank']}: the inf on rank 1 was not skipped: "
                f"{inf}")
    larc_rec = _larc_case()
    emit("ddp", nccl_world_one=dict(
        model="resnet50", opt_level="O2", batch=RN_B, image_size=RN_SIZE,
        seconds=nccl_s, **nccl),
        gloo_two_processes_on_cuda0=dict(
            batch=[DDP_GLOO_WORLD, DDP_GLOO_B // DDP_GLOO_WORLD],
            seconds=gloo_s, reference_losses=ref, mean_rank_losses=mean,
            losses_max_abs_err=loss_err, loss_tolerance=DDP_LOSS_TOL,
            masters_vs_reference=mr, master_tolerance=DDP_MASTER_TOL,
            masters_bitwise_equal=True, running_stats_bitwise_equal=True,
            inf_on_rank_1=[rk["inf_on_rank_1"] for rk in ranks]),
        larc=larc_rec,
        multi_card="not run: the machine has one card")
    return nccl["ddp"]["launches"]


# -- the seventh slice: K15, K17 / K18, amp O1, MNIST, DCGAN -------------

def _nonfinite_case(what, xs, ragged_leaf, ints=()):
    """K15 over ``xs`` (the table of the floating leaves) against its plain
    version: clean, then one inf and one nan at the first, a middle and
    the last element of ``xs[ragged_leaf]``, each flag equal bit for bit
    and repeated; times, the bound, the eager per-leaf check beside it."""
    import torch
    from apex_tpu_torch.ops.cuda import (all_finite_packed,
                                         packed_nonfinite,
                                         packed_nonfinite_ref)
    from apex_tpu_torch.ops.multi_tensor import table_for
    table = table_for(xs)
    placements = []
    flat = xs[ragged_leaf].view(-1)
    for val in (None, float("inf"), float("nan")):
        for at in ((None,) if val is None else
                   (0, flat.numel() // 2, flat.numel() - 1)):
            keep = None
            if val is not None:
                keep = flat[at].clone()
                flat[at] = val
            got = packed_nonfinite(table, xs)
            again = packed_nonfinite(table, xs)
            ref = packed_nonfinite_ref(table, xs)
            whole = all_finite_packed(list(xs) + list(ints))
            torch.cuda.synchronize()
            require(torch.equal(got, ref) and torch.equal(got, again),
                    f"packed_nonfinite {what} {val} at {at}: kernel "
                    f"{int(got)} / {int(again)}, plain {int(ref)}")
            require(int(got) == (val is not None)
                    and bool(whole) == (val is None),
                    f"packed_nonfinite {what}: flag {int(got)} for {val}")
            placements.append([str(val), at, int(got)])
            if keep is not None:
                flat[at] = keep
    n_bytes = sum(t.numel() * t.element_size() for t in xs)
    ms = time_ms(lambda: packed_nonfinite(table, xs))
    plain = time_ms(lambda: packed_nonfinite_ref(table, xs), budget_s=0.2)
    eager = time_ms(lambda: torch.stack(
        [torch.isfinite(t).all() for t in xs]).all(), budget_s=0.2)
    b_ms, b_by = bound(n_bytes, sum(t.numel() for t in xs),
                       PEAK_FP32_FLOPS)
    dtypes = sorted({str(t.dtype).replace("torch.", "") for t in xs})
    return _kernel_rec(
        kernel="packed_nonfinite", case=what, leaves=len(xs),
        integer_leaves=len(ints), dtypes=dtypes, bytes=n_bytes,
        chunks=table.n_chunks, shape=f"{len(xs)} leaves, {n_bytes} bytes",
        placements=placements, max_abs_err=0.0,
        tolerance="the flag equal to the plain version's bit for bit",
        bitwise_repeat=True, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        library_null_reason="no PyTorch call computes a read-only "
                            "non-finite flag over a list (the eager "
                            "per-leaf check is printed beside it)",
        eager_all_finite_ms=eager)


def phase_nonfinite_kernels(cfg, bert_cfg):
    """K15 at gpt_small's 148 fp32 leaves (the accumulation path's
    check), bert_large's 303, and a mixed bf16 / fp16 / fp32 tree with
    integer leaves; a non-finite value at the first, a middle and the last
    element of a ragged leaf."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(29)
    shapes = _leaf_shapes(cfg)
    recs = []
    xs = _fp32_leaves(shapes, gen)
    from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE
    # the last leaf whose elements end inside a chunk (a ragged tail)
    ragged = max(i for i, s in enumerate(shapes)
                 if int(np.prod(s)) % CHUNK_SIZE)
    recs.append(_nonfinite_case("gpt_small", xs, ragged))
    del xs
    bshapes = _leaf_shapes(bert_cfg)
    xs = _fp32_leaves(bshapes, gen)
    # the largest leaf whose bytes end off a 16-byte vector (the element
    # loads of the tail) and off a chunk
    tail = max(range(len(bshapes)), key=lambda i: (
        int(np.prod(bshapes[i])) % 4 != 0,
        int(np.prod(bshapes[i])) % CHUNK_SIZE != 0, int(np.prod(bshapes[i]))))
    recs.append(_nonfinite_case("bert_large", xs, tail))
    del xs
    mixed = [(70001,), (4099,), (3, 5), (768, 3072), (131073,), (37,)]
    dts = [torch.float32, torch.bfloat16, torch.float16, torch.bfloat16,
           torch.float16, torch.float32]
    xs = [torch.randn(s, generator=gen, device="cuda").to(d)
          for s, d in zip(mixed, dts)]
    ints = (torch.arange(7, device="cuda"), torch.ones(3, 3,
                                                       dtype=torch.int32,
                                                       device="cuda"))
    recs.append(_nonfinite_case("mixed bf16 / fp16 / fp32", xs, 1, ints))
    torch.cuda.empty_cache()
    return recs


#: the multi-head flash cases: shape, causal, key mask
MH_SHAPES = (((8, 2048, 12, 64), True, False),
             ((32, 512, 16, 64), False, True),
             ((1, 4096, 6, 128), True, False),
             ((2, 1000, 4, 64), False, False))


def _mh_case(shape, causal, masked, gen):
    """K17 and K18 (the budget raised, so the fused backward runs at every
    shape) against their plain versions (over slices of heads), with a
    cotangent on the lse; bitwise repeats; once more with the budget at 0
    (the K13 / K14 route); times beside K2 / K4 on the same tensors (the
    port's strided path) and SDPA's forward and backward; the bounds.
    K17's ``ms`` is its launch on prepared operands, ``call_ms`` the
    wrapper's whole call."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import (attn_delta, flash_attn_bwd,
                                         flash_attn_bwd_dkv,
                                         flash_attn_bwd_dq, flash_attn_fwd,
                                         flash_mh_bwd, flash_mh_bwd_ref,
                                         flash_mh_fwd, flash_mh_fwd_ref,
                                         mh_partials_bytes)
    bsz, l, h, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    dlse = torch.randn((bsz, l, h), generator=gen, device="cuda") * 0.1
    mask = None
    if masked:
        mask = torch.rand((bsz, l), generator=gen, device="cuda") > 0.25
        mask[:, 0] = True
    kw = dict(causal=causal, kv_mask=mask)
    tag = f"flash_mh {shape}"
    o, lse = flash_mh_fwd(q, k, v, **kw)
    o2, lse2 = flash_mh_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    require(torch.equal(o, o2) and torch.equal(lse, lse2),
            f"{tag} forward: two runs differ")
    del o2, lse2
    ro, rlse = _plain_by_heads(flash_mh_fwd_ref, (q, k, v), kw)
    o_err, lse_err = _max_err(o, ro), _max_err(lse, rlse)
    require(o_err <= 2e-2 and lse_err <= 1e-3,
            f"{tag}: o err {o_err}, lse err {lse_err}")
    fwd_scaled = scaled_errs(f"{tag} o", o, ro)
    del ro, rlse

    def bwd_ref(q_, k_, v_, o_, lse_, do_, dlse_):
        return flash_mh_bwd_ref(q_, k_, v_, o_, lse_, do_, dlse=dlse_, **kw)

    with fused_budget(FUSED_ALWAYS):
        got = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
        again = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{tag} backward: two runs differ")
        del again
        ref = _plain_by_heads(bwd_ref, (q, k, v, o, lse, do, dlse), {})
        bwd_scaled = [scaled_errs(f"{tag} {n}", a, r)
                      for n, a, r in zip(("dq", "dk", "dv"), got, ref)]
        bwd_errs = [_max_err(a, r) for a, r in zip(got, ref)]
        ms_b = time_ms(lambda: flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse,
                                            **kw))
        k4_ms = time_ms(lambda: flash_attn_bwd(q, k, v, o, lse, do,
                                               dlse=dlse, **kw))
    two_pass = None
    if d in (64, 128):
        with fused_budget(0):
            before = (flash_mh_bwd.launches, flash_attn_bwd_dq.launches,
                      flash_attn_bwd_dkv.launches)
            tp = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
            torch.cuda.synchronize()
            after = (flash_mh_bwd.launches, flash_attn_bwd_dq.launches,
                     flash_attn_bwd_dkv.launches)
            require(after == (before[0], before[1] + 1, before[2] + 1),
                    f"{tag}: budget 0 did not take K13 + K14 ({before} -> "
                    f"{after})")
            two_pass = [scaled_errs(f"{tag} two-pass {n}", a, r)
                        for n, a, r in zip(("dq", "dk", "dv"), tp, ref)]
            del tp
    del ref, got
    plain_f = time_ms(lambda: _plain_by_heads(flash_mh_fwd_ref, (q, k, v),
                                              kw), budget_s=0.2)
    plain_b = time_ms(lambda: _plain_by_heads(
        bwd_ref, (q, k, v, o, lse, do, dlse), {}), budget_s=0.2)
    torch.cuda.empty_cache()
    ms_f = _fwd_launch_ms(q, k, v, kw)
    call_f = time_ms(lambda: flash_mh_fwd(q, k, v, **kw))
    k2_ms = time_ms(lambda: flash_attn_fwd(q, k, v, return_lse=True, **kw))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if masked or (not causal):
        am = None if mask is None else mask[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=am)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
    with torch.no_grad():
        lib_f = time_ms(sdpa)
    ot = sdpa()
    dot = do.transpose(1, 2)
    lib_b = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                retain_graph=True))
    pairs = _flash_pairs(bsz, l, h, causal, mask)
    e = bsz * l * h * d
    mbytes = bsz * l if masked else 0
    fb_ms, fb_by = bound(4 * e * 2 + 4 * bsz * l * h + mbytes,
                         4.0 * d * pairs, PEAK_BF16_FLOPS)
    # reads q, k, v, o, do, lse, dlse; writes dq, dk, dv
    bb_ms, bb_by = bound(8 * e * 2 + 8 * bsz * l * h + mbytes,
                         10.0 * d * pairs, PEAK_BF16_FLOPS)
    common = dict(shape=list(shape), causal=causal, kv_mask=masked,
                  dtype="bfloat16", bitwise_repeat=True,
                  plain="run over slices of heads (at most 2**28 fp32 "
                        "scores at once), every head compared")
    fwd = _kernel_rec(kernel="flash_mh_fwd", **common, max_abs_err=o_err,
                      lse_err=lse_err, **fwd_scaled,
                      tolerance="o within 2e-2 and the row / norm limits, "
                                "lse within 1e-3, vs the plain version on "
                                "the same bf16 inputs",
                      ms=ms_f, call_ms=call_f, plain_ms=plain_f,
                      bound_ms=fb_ms, bound_by=fb_by,
                      bound_share=fb_ms / ms_f, library_ms=lib_f,
                      library_call="F.scaled_dot_product_attention",
                      k2_same_shape_ms=k2_ms)
    bwd = _kernel_rec(kernel="flash_mh_bwd", **common,
                      max_abs_err=max(bwd_errs), errs_dq_dk_dv=bwd_errs,
                      dq_dk_dv_scaled=bwd_scaled,
                      row_rel_err=max(x["row_rel_err"] for x in bwd_scaled),
                      row_rel_tol=ROW_REL_TOL,
                      norm_rel_err=max(x["norm_rel_err"]
                                       for x in bwd_scaled),
                      norm_rel_tol=NORM_REL_TOL,
                      tolerance="dq, dk, dv (with a dlse cotangent) by the "
                                "row and norm limits vs the plain version",
                      partials_bytes=mh_partials_bytes(*shape),
                      two_pass_route_k13_k14=two_pass,
                      ms=ms_b,
                      plain_ms=plain_b, bound_ms=bb_ms,
                      bound_by=bb_by, library_ms=lib_b,
                      library_call="autograd of F.scaled_dot_product_"
                                   "attention (dq, dk, dv)",
                      k4_same_shape_ms=k4_ms)
    del q, k, v, do, o, lse, qt, kt, vt, ot
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_flash_mh_kernels():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(31)
    fwd, bwd = [], []
    for shape, causal, masked in MH_SHAPES:
        f, b = _mh_case(shape, causal, masked, gen)
        fwd.append(f)
        bwd.append(b)
    return fwd, bwd


def phase_flash_mh():
    """The entry point a user calls, ``flash_attention_mh`` with autograd,
    forward and backward once at BERT's shape with a key mask (K18 with
    its q^ prologue and finish pass: its planes fit the default budget)
    and once at the GPT train shape (causal: K13 + K14 at the default
    budget), the counts reset before each and read after."""
    import torch
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.ops.experimental import flash_attention_mh
    gen = torch.Generator(device="cuda").manual_seed(37)
    runs = {}
    for shape, causal, masked in (((32, 512, 16, 64), False, True),
                                  ((8, 2048, 12, 64), True, False)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16).requires_grad_() for _ in range(3))
        mask = None
        if masked:
            mask = torch.rand(shape[:2], generator=gen, device="cuda") > 0.25
            mask[:, 0] = True
        reset_launch_counts()
        o = flash_attention_mh(q, k, v, causal=causal, kv_mask=mask)
        o.float().square().mean().backward()
        torch.cuda.synchronize()
        counts = launch_counts()
        require(all(torch.isfinite(t.grad).all() for t in (q, k, v)),
                f"flash_attention_mh {shape}: non-finite gradients")
        runs[str(shape)] = {n: c for n, c in counts.items() if c}
        require(counts["flash_mh_fwd"] == 1,
                f"flash_attention_mh {shape}: launches {counts}")
        del q, k, v, o
    first = runs[str((32, 512, 16, 64))]
    require(first.get("flash_mh_bwd") == 1
            and first.get("flash_bwd_finish") == 1,
            f"flash_attention_mh at BERT's shape did not run K18: {first}")
    emit("flash_mh", launches=runs)
    torch.cuda.empty_cache()
    return first


#: the cases the card's kernels refused before the repairs (fp16, fp32,
#: head widths other than 64 / 128, and above 512): (shape, dtype, causal,
#: masked)
REPAIR_CASES = (((8, 2048, 12, 64), "float16", True, False),
                ((2, 1024, 12, 64), "float32", True, True),
                ((2, 1000, 4, 40), "bfloat16", True, False),
                ((2, 1000, 4, 96), "float16", False, True),
                ((1, 1024, 4, 192), "bfloat16", True, False),
                ((1, 1024, 4, 256), "float16", False, False),
                ((1, 512, 4, 256), "float32", True, False),
                ((1, 256, 2, 520), "float32", True, True),
                ((1, 256, 2, 1024), "bfloat16", False, False))


def _repair_case(shape, dtype, causal, masked, gen):
    """``flash_attention_mh`` and ``attention`` (with rope) with autograd
    on one repaired case: o and the three gradients (a cotangent on the
    lse for the multi-head one) against the plain versions on the same
    inputs (over slices of heads), by the row and norm limits; returns
    the errors."""
    import torch
    from apex_tpu_torch.attention import attention
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd_ref,
                                         flash_attn_fwd_ref,
                                         flash_mh_bwd_ref, flash_mh_fwd_ref)
    from apex_tpu_torch.ops.experimental import flash_attention_mh
    bsz, l, h, d = shape
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    dlse = torch.randn((bsz, l, h), generator=gen, device="cuda") * 0.1
    mask = None
    if masked:
        mask = torch.rand((bsz, l), generator=gen, device="cuda") > 0.25
        mask[:, 0] = True
    tag = f"repair {shape} {dtype}"
    errs = {}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_attention_mh(*leaves, causal=causal, kv_mask=mask,
                                return_lse=True)
    torch.autograd.backward((o, lse), (do, dlse))
    kw = dict(causal=causal, kv_mask=mask)
    ro, _ = _plain_by_heads(flash_mh_fwd_ref, (q, k, v), kw)
    errs["mh_o"] = scaled_errs(f"{tag} mh o", o, ro)
    ref = _plain_by_heads(
        lambda q_, k_, v_, o_, l_, do_, dl_: flash_mh_bwd_ref(
            q_, k_, v_, o_, l_, do_, dlse=dl_, **kw),
        (q, k, v, o.detach(), lse.detach(), do, dlse), {})
    for n, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        require(t.grad.dtype == dt, f"{tag}: mh {n} is {t.grad.dtype}")
        errs[f"mh_{n}"] = scaled_errs(f"{tag} mh {n}", t.grad, r)
    del leaves, o, lse, ro, ref
    tables = _tables(bsz, l, d, dt)
    kw = dict(causal=causal, kv_mask=mask, rope=tables)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = attention(*leaves, return_lse=True, **kw)
    o.backward(do)
    ro, _ = _plain_by_heads(flash_attn_fwd_ref, (q, k, v), kw)
    errs["attention_o"] = scaled_errs(f"{tag} attention o", o, ro)
    ref = _plain_by_heads(
        lambda q_, k_, v_, o_, l_, do_: flash_attn_bwd_ref(
            q_, k_, v_, o_, l_, do_, causal=causal, kv_mask=mask,
            rope=tables),
        (q, k, v, o.detach(), lse.detach(), do), {})
    for n, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        errs[f"attention_{n}"] = scaled_errs(f"{tag} attention {n}",
                                             t.grad, r)
    del leaves, o, lse, ro, ref, q, k, v, do
    torch.cuda.empty_cache()
    return {n: e["row_rel_err"] for n, e in errs.items()}


#: the generic kernels' recorded causal shapes, (shape, dtype, rope): the
#: row comparable with earlier PRs', the O0 GPT step's (with rope),
#: gpt_small_tpu's 6 heads of 128, and a half type above D 128
SIMT_SHAPES = (((2, 1024, 12, 64), "float32", False),
               ((8, 2048, 12, 64), "float32", True),
               ((8, 2048, 6, 128), "float32", False),
               ((1, 1024, 4, 256), "bfloat16", False))


def _device_kernels(fn):
    """The device kernels one call of ``fn`` ran (the profiler's names,
    cut to 100 characters) with their device ms, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {k[:100]: ms for k, ms in device_kernel_ms(prof).items()}


def _simt_case(shape, dtype, rope, gen, profile):
    """The generic kernels against their plain versions at one causal
    shape, ``(fwd, bwd, sdpa_kernels)`` (SDPA's device kernels when
    ``profile``, else None): in fp32 o and lse within 2e-5 and
    dq, dk, dv within 1e-4 of the plain fp32 version; in bf16 (both round
    o, dk, dv and the scaled dq to bf16, and P and dS inside, at the same
    places but sum in other orders) by the row and norm limits of
    ``scaled_errs``; two runs equal bit for bit; kernel and plain times,
    SDPA's time where it computes the same function (no rope), and the
    bounds at the card's peak rate for the dtype (the kernels run on CUDA
    cores, but the card computes a half type on its tensor cores)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import cuda as kernels
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd_ref,
                                         flash_attn_fwd_ref, flash_bwd_simt,
                                         flash_fwd_simt)
    bsz, l, h, d = shape
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    kw = dict(causal=True, rope=_tables(bsz, l, d, dt) if rope else None)
    o, lse = flash_fwd_simt(q, k, v, return_lse=True, **kw)
    again = flash_fwd_simt(q, k, v, return_lse=True, **kw)
    got = flash_bwd_simt(q, k, v, o, lse, do, **kw)
    got2 = flash_bwd_simt(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    tag = f"generic kernels {dtype} {shape}"
    require(torch.equal(o, again[0]) and torch.equal(lse, again[1])
            and all(torch.equal(a, b) for a, b in zip(got, got2)),
            f"{tag}: two runs differ")
    ro, rlse = flash_attn_fwd_ref(q, k, v, **kw)
    ref = flash_attn_bwd_ref(q, k, v, o, lse, do, **kw)
    f_err = max(_max_err(o, ro), _max_err(lse, rlse))
    b_errs = [_max_err(a, r) for a, r in zip(got, ref)]
    checks = {}
    if dt == torch.float32:
        require(f_err <= 2e-5 and max(b_errs) <= 1e-4,
                f"{tag}: forward {f_err}, backward {b_errs}")
        f_tol = "o and lse within 2e-5 of the plain fp32"
        b_tol = "dq, dk, dv within 1e-4 of the plain fp32"
    else:
        # without rope the kernels pre-scale q in bf16, where the plain
        # forward scales the fp32 scores: 2 bf16 ulps of the largest lse
        require(_max_err(lse, rlse) <= bf16_tol(rlse),
                f"{tag}: lse off by {_max_err(lse, rlse)}")
        checks = {n: scaled_errs(f"{tag} {n}", t, r) for n, t, r in
                  zip(("o", "dq", "dk", "dv"), (o, *got), (ro, *ref))}
        f_tol = ("lse within 2 bf16 ulps of its largest element, o by "
                 "the row and norm limits of the plain version in bf16")
        b_tol = "dq, dk, dv by the row and norm limits"
    del ro, rlse, ref, again, got2
    torch.cuda.empty_cache()
    call_f = lambda: flash_fwd_simt(q, k, v, **kw)
    call_b = lambda: flash_bwd_simt(q, k, v, o, lse, do, **kw)
    ms = (time_ms(call_f), time_ms(call_b))
    plain_ms = (time_ms(lambda: flash_attn_fwd_ref(q, k, v, **kw)),
                time_ms(lambda: flash_attn_bwd_ref(q, k, v, o, lse, do,
                                                   **kw)))
    lib_f = lib_b = None
    sdpa_kernels = None
    if not rope:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        with torch.no_grad():
            sdpa_f = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            lib_f = time_ms(sdpa_f)
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa_b = lambda: torch.autograd.grad(
            ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
        lib_b = time_ms(sdpa_b)
        with torch.no_grad():
            lib_dev = {"forward": device_queued_ms(sdpa_f, 20)}
        lib_dev["backward"] = device_queued_ms(sdpa_b, 20)
        if profile:
            with torch.no_grad():
                fwd_names = _device_kernels(sdpa_f)
            sdpa_kernels = {"forward": fwd_names,
                            "backward": _device_kernels(sdpa_b)}
        del qt, kt, vt, ot
    else:
        lib_dev = {"forward": None, "backward": None}
    # the device's time a call (queued behind a device-side sleep): ``ms``
    # above times queued calls with CUDA events too, but a slow host can
    # inflate it for the short ones
    dev_f = device_queued_ms(call_f, 20)
    dev_b = device_queued_ms(call_b, 20)
    pairs = _flash_pairs(bsz, l, h, True, None)
    es = q.element_size()
    e = bsz * l * h * d
    tables = 2 * bsz * l * d * es if rope else 0
    peak = PEAK_FP32_FLOPS if dt == torch.float32 else PEAK_BF16_FLOPS
    fb = bound(4 * e * es + 4 * bsz * l * h + tables, 4.0 * d * pairs, peak)
    bb = bound(8 * e * es + 8 * bsz * l * h + tables, 10.0 * d * pairs, peak)
    common = dict(shape=list(shape), causal=True, rope=rope, dtype=dtype,
                  layout=kernels.simt_layout(dt, d), bitwise_repeat=True)
    sdpa = "F.scaled_dot_product_attention" + f" ({dtype})"
    fwd = _kernel_rec(
        kernel="flash_fwd_simt", **common, max_abs_err=f_err,
        tolerance=f_tol, checks={n: c for n, c in checks.items()
                                 if n == "o"},
        ms=ms[0], plain_ms=plain_ms[0], bound_ms=fb[0],
        bound_by=fb[1], library_ms=lib_f,
        device_ms=dev_f, library_device_ms=lib_dev["forward"],
        library_call=sdpa if lib_f is not None else None,
        library_null_reason=None if lib_f is not None else
        "no PyTorch call rotates by full-width tables inside attention")
    bwd = _kernel_rec(
        kernel="flash_bwd_simt", **common, max_abs_err=max(b_errs),
        errs_dq_dk_dv=b_errs, tolerance=b_tol,
        checks={n: c for n, c in checks.items() if n != "o"},
        ms=ms[1], plain_ms=plain_ms[1], bound_ms=bb[0],
        bound_by=bb[1], library_ms=lib_b,
        device_ms=dev_b, library_device_ms=lib_dev["backward"],
        library_call="autograd of " + sdpa if lib_b is not None else None,
        library_null_reason=None if lib_b is not None else
        "no PyTorch call rotates by full-width tables inside attention",
        flops_a_visible_pair={"bound": "10 D", "kernels": "14 D (dk / dv "
                              "8 D, dq 6 D)"})
    del q, k, v, do, o, lse, got
    torch.cuda.empty_cache()
    return fwd, bwd, sdpa_kernels


def phase_generic_kernels(profile=False):
    """The generic kernels at each of ``SIMT_SHAPES``: two lists of
    records (forward, backward), the first shape's first.  With
    ``profile`` (a partial run: a profiled run slows the host's later
    calls, and late in the whole run a session may return no kernels)
    also a line of SDPA's device kernels by shape."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(43)
    fwd, bwd, sdpa = [], [], {}
    for shape, dtype, rope in SIMT_SHAPES:
        f, b, kernels = _simt_case(shape, dtype, rope, gen, profile)
        fwd.append(f)
        bwd.append(b)
        if kernels is not None:
            sdpa[f"{dtype} {shape}"] = kernels
    if profile:
        emit("sdpa_kernels", by_shape=sdpa)
    return fwd, bwd


@fused_budget(FUSED_ALWAYS)
def _fp16_backward_times(gen):
    """K4 (with rope) and K18, each called whole on fp16 inputs at the GPT
    train shape, causal, on the fused route (the budget raised: the
    planes' 1.61 GB exceed the default), each call required to launch the
    fused kernel and its finish pass."""
    import torch
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd, flash_attn_fwd,
                                         flash_bwd_finish, flash_mh_bwd,
                                         flash_mh_fwd)
    shape = (8, 2048, 12, 64)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.float16) for _ in range(4))
    tables = _tables(shape[0], shape[1], shape[3], torch.float16)

    def fused(wrapper, call):
        before = (wrapper.launches, flash_bwd_finish.launches)
        call()
        torch.cuda.synchronize()
        after = (wrapper.launches, flash_bwd_finish.launches)
        require(after == (before[0] + 1, before[1] + 1),
                f"fp16 {wrapper.__name__}: the fused route did not run "
                f"({before} -> {after})")
        return time_ms(call)

    o, lse = flash_attn_fwd(q, k, v, causal=True, rope=tables,
                            return_lse=True)
    k4 = fused(flash_attn_bwd, lambda: flash_attn_bwd(
        q, k, v, o, lse, do, causal=True, rope=tables))
    o, lse = flash_mh_fwd(q, k, v, causal=True)
    k18 = fused(flash_mh_bwd, lambda: flash_mh_bwd(q, k, v, o, lse, do,
                                                   causal=True))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return dict(shape=list(shape), dtype="float16", causal=True,
                route="fused", k4_rope_call_ms=k4, k18_call_ms=k18)


def phase_flash_repairs():
    """The entry points on the cases the card refused before (fp16, fp32,
    head widths 40, 96, 192, 256, 520 and 1024: the routes of
    ``fwd_route`` / ``bwd_route``), each against its plain versions, the
    counts reset before and read after (the generic kernels' and the
    tensor-core kernels' launches on this path: K4 and K18 at every half
    width up to 128 at the default budget)."""
    import torch
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    gen = torch.Generator(device="cuda").manual_seed(41)
    reset_launch_counts()
    cases = [dict(shape=list(sh), dtype=dt, causal=c, kv_mask=m,
                  row_rel_errs=_repair_case(sh, dt, c, m, gen))
             for sh, dt, c, m in REPAIR_CASES]
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in ("flash_fwd_simt", "flash_bwd_simt", "flash_attn_fwd",
                 "flash_mh_fwd", "flash_fwd_prologue", "flash_attn_bwd",
                 "flash_mh_bwd", "flash_bwd_prologue", "flash_bwd_finish"):
        require(counts[name] > 0, f"flash_repairs: {name} never launched")
    emit("flash_repairs", cases=cases, row_rel_tol=ROW_REL_TOL,
         norm_rel_tol=NORM_REL_TOL,
         launches={k: c for k, c in counts.items() if c},
         fp16_backward=_fp16_backward_times(gen))
    return counts


FP16_LAYERS = 4
FP16_STEPS = 5


def phase_fp16_o2(cfg):
    """amp O2 with ``half_dtype=torch.float16`` (NVIDIA Apex's classic O2:
    fp16 compute, fp32 masters, a dynamic loss scale) at gpt_small's width
    and 4 of its layers, FusedAdam(3e-4), B 8 x L 2048, 5 steps: finite,
    falling losses, the exact launches per step (K1 / K3, K2 with its
    prologue, K13 / K14, K6 and K11 in fp16), p50, peak memory; then one
    injected overflow skipped on the card."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    fcfg = dataclasses.replace(cfg, num_layers=FP16_LAYERS)
    model = params_from_jax(gpt_small_tree(fcfg, seed=5), fcfg,
                            trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt, opt_level="O2", half_dtype=torch.float16)
    require(all(p.dtype == torch.float16 for p in model.parameters()),
            "fp16 O2: the compute parameters are not fp16")
    step = amp.make_train_step(a, model, _gpt_loss)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rows6 = TableRows()
    losses, scales, overflows, times = [], [], [], []
    for _ in range(FP16_STEPS):
        t0 = time.perf_counter()
        out = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows6.mark()
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
    counts = launch_counts()
    per_step = {k: c / FP16_STEPS for k, c in counts.items()}
    want = dict(gpt_pass_launches(fcfg), packed_scale=1, packed_adam_tree=1)
    require(per_step == want, f"fp16 O2 launches per step {per_step}, "
                              f"want {want}")
    unscale_rows = rows6.report()
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"fp16 O2 losses: {losses}")
    p50 = float(np.median(times[2:])) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    overflow = _inject_overflow(a, opt, model, ids)
    emit("fp16_o2", model=f"gpt_small width, {FP16_LAYERS} layers",
         opt_level="O2", half_dtype="float16", batch=TRAIN_B,
         seq_len=TRAIN_L, steps=FP16_STEPS, losses=losses,
         loss_scales=scales, overflows=overflows,
         step_ms=[t * 1e3 for t in times], step_ms_p50_steps_3_to_5=p50,
         tokens_per_s=TRAIN_B * TRAIN_L / (p50 / 1e3), peak_memory_gb=peak,
         launches_per_step=per_step, unscale_pointer_rows=unscale_rows,
         injected_overflow=overflow)
    del a, opt, model
    torch.cuda.empty_cache()
    return counts


#: the gpt_small O2 step p50 of the train phase (PR 6's run on an NVIDIA
#: H100 80GB HBM3 at 700.00 W), printed beside the O1 step as a record
PR6_O2_TRAIN_P50_MS = 108.1
#: the accumulated step p50 of PR 6's run (same card), before K15
PR6_ACCUM_P50_MS = 422.3


def phase_o1_train(cfg, tree):
    """gpt_small at amp O1 (the default opt level: fp32 parameters, the
    products cast to bf16 by the op layer), FusedAdam(lr 3e-4), B 8 x L
    2048, 10 steps: falling losses, p50, tokens/s, peak memory, one
    profiled step, the exact launches per step (K1 / K3 in fp32, one K6
    over the fp32 gradients, one K11 with no copies); then one injected
    overflow
    skipped on the card."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt)
    require(a.properties.opt_level == "O1" and a._copies is None,
            "the default initialize is not O1 without copies")
    step = amp.make_train_step(a, model, _gpt_loss)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    n_leaves = len(a.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rows6 = TableRows()
    losses, scales, overflows, times = [], [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows6.mark()
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = dict(gpt_pass_launches(cfg), packed_scale=1, packed_adam_tree=1)
    require(per_step == want, f"O1 launches per step {per_step}, want "
                              f"{want}")
    unscale_rows = rows6.report()
    require(all(p.dtype == torch.float32 for p in model.parameters()),
            "O1 cast a parameter")
    require(all(np.isfinite(losses)), f"non-finite O1 loss: {losses}")
    require(losses[-1] < losses[0], f"O1 loss did not fall: {losses}")
    require(not any(overflows), f"overflow in the O1 steps: {overflows}")
    p50 = float(np.median(times[2:])) * 1e3
    profile = profile_step(step, ids)
    with torch.enable_grad():
        loss = a.run(_gpt_loss, model, ids)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[5].view(-1)[-1] = float("nan")
    params = [p.detach().clone() for p in a.params]
    st = opt.state[a.masters["lm_head.kernel"]]
    moments = (st["exp_avg"].clone(), int(st["step"]))
    scale_before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    torch.cuda.synchronize()
    require(bool(info["overflow"])
            and float(info["loss_scale"]) == scale_before / 2,
            "the O1 overflow was not seen or the scale did not halve")
    require(all(torch.equal(p, q) for p, q in zip(a.params, params))
            and torch.equal(st["exp_avg"], moments[0])
            and int(st["step"]) == moments[1],
            "parameters or moments changed on a skipped O1 step")
    emit("o1_train", model="gpt_small", opt_level="O1",
         optimizer="FusedAdam", lr=3e-4, batch=TRAIN_B, seq_len=TRAIN_L,
         steps=TRAIN_STEPS, losses=losses, loss_scales=scales,
         step_ms=[t * 1e3 for t in times], step_ms_p50_steps_3_to_10=p50,
         tokens_per_s=TRAIN_B * TRAIN_L / (p50 / 1e3),
         record_o2_step_ms_p50=PR6_O2_TRAIN_P50_MS, peak_memory_gb=peak,
         launches=counts, launches_per_step=per_step, leaves=n_leaves,
         unscale_pointer_rows=unscale_rows,
         parameters_dtype="float32", profile=profile,
         injected_overflow={"skipped": True, "loss_scale": [
             scale_before, float(info["loss_scale"])]})
    del a, opt, model, grads, params
    torch.cuda.empty_cache()
    return counts


def phase_o1_reference():
    """A 2-layer GPT at O1, 3 steps on the card against the same on the
    CPU (plain versions) from the same weights: losses within 2e-2 (bf16
    products), and the card's losses finite and falling."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    tree = gpt_small_tree(cfg, seed=5)
    ids = train_stream(cfg.vocab_size, 4, 128)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = params_from_jax(tree, cfg, device=dev, trainable=True)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev), device=dev)
        step = amp.make_train_step(a, model, _gpt_loss)
        x = torch.as_tensor(ids, device=dev)
        runs[dev] = [float(step(x)["loss"]) for _ in range(3)]
    err = max(abs(x - y) for x, y in zip(runs["cuda"], runs["cpu"]))
    require(all(np.isfinite(runs["cuda"]))
            and runs["cuda"][-1] < runs["cuda"][0],
            f"O1 reference losses on the card: {runs['cuda']}")
    require(err <= 2e-2, f"O1 losses card vs CPU differ by {err}")
    emit("o1_reference", steps=3, opt_level="O1", losses_card=runs["cuda"],
         losses_cpu=runs["cpu"], loss_max_abs_err=err, loss_tolerance=2e-2)


def o0_pass_launches(cfg):
    """Launches of one fp32 GPT forward and backward pass: K1 / K3 in fp32
    (K3 twice a call), and attention on the generic kernels (one forward
    launch a layer, two backward launches: dk / dv, then dq; rope inside
    them, so no prologue); none of the tensor-core kernels'."""
    lnc = 2 * cfg.num_layers + 1
    return dict(NO_LAUNCHES, layer_norm_fwd=lnc, layer_norm_bwd=2 * lnc,
                flash_fwd_simt=cfg.num_layers,
                flash_bwd_simt=2 * cfg.num_layers)


def phase_o0_train(cfg, tree):
    """gpt_small at amp O0 (fp32 throughout, the baseline of every amp
    level: attention on the generic kernels, K1 / K3 in fp32),
    FusedAdam(lr 3e-4), B 8 x L 2048, 10 steps: falling losses, step p50
    over steps 3-10, tokens/s, peak memory, the exact launches per step
    (flash_fwd_simt 12, flash_bwd_simt 24, K1 25, K3 50, K6 1, K11 1) and
    one profiled step's device ms by group, the generic kernels named."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt, opt_level="O0")
    require(all(p.dtype == torch.float32 for p in model.parameters()),
            "O0 holds a parameter that is not fp32")
    step = amp.make_train_step(a, model, _gpt_loss)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = dict(o0_pass_launches(cfg), packed_scale=1, packed_adam_tree=1)
    require(per_step == want, f"O0 launches per step {per_step}, want "
                              f"{want}")
    require(all(np.isfinite(losses)), f"non-finite O0 loss: {losses}")
    require(losses[-1] < losses[0], f"O0 loss did not fall: {losses}")
    p50 = float(np.median(times[2:])) * 1e3
    profile = profile_step(step, ids)
    emit("o0_train", model="gpt_small", opt_level="O0",
         optimizer="FusedAdam", lr=3e-4, batch=TRAIN_B, seq_len=TRAIN_L,
         steps=TRAIN_STEPS, losses=losses, step_ms=[t * 1e3 for t in times],
         step_ms_p50_steps_3_to_10=p50,
         tokens_per_s=TRAIN_B * TRAIN_L / (p50 / 1e3), peak_memory_gb=peak,
         launches=counts, launches_per_step=per_step,
         parameters_dtype="float32", profile=profile)
    del a, opt, model, out
    torch.cuda.empty_cache()
    return counts


MNIST_STEPS = 20


def phase_mnist_o1():
    """BASELINE config 1: ``MLP((256, 256))`` at amp O1 with SGD(0.05),
    B 256 on the synthetic stream of ``examples/mnist_amp.py``, 20 steps:
    losses fall, p50, samples/s, launches per step (K6 1, nothing else
    of the port's: SGD is PyTorch's); then an injected overflow,
    skipped."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.mlp import (MLP, cross_entropy_loss,
                                           synthetic_mnist)
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    torch.manual_seed(0)
    model = MLP((256, 256))
    a = amp.initialize(model, torch.optim.SGD(model.parameters(), lr=0.05))
    step = amp.make_train_step(
        a, model, lambda m, x, y: cross_entropy_loss(m(x), y))
    xs, ys = synthetic_mnist(torch.Generator().manual_seed(1), MNIST_STEPS,
                             256)
    reset_launch_counts()
    rows6 = TableRows()
    losses, times = [], []
    for i in range(MNIST_STEPS):
        t0 = time.perf_counter()
        out = step(xs[i], ys[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows6.mark()
        losses.append(float(out["loss"]))
    counts = launch_counts()
    per_step = {k: c / MNIST_STEPS for k, c in counts.items()}
    require(per_step == dict(NO_LAUNCHES, packed_scale=1),
            f"MNIST launches per step {per_step}")
    unscale_rows = rows6.report()
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"MNIST O1 losses: {losses}")
    with torch.enable_grad():
        loss = a.run(lambda m, x, y: cross_entropy_loss(m(x), y), model,
                     xs[0], ys[0])
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[0].view(-1)[0] = float("inf")
    before = [p.detach().clone() for p in a.params]
    scale = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    require(bool(info["overflow"]) and float(info["loss_scale"]) == scale / 2
            and all(torch.equal(p, q) for p, q in zip(a.params, before)),
            "the MNIST overflow was not skipped")
    p50 = float(np.median(times[2:])) * 1e3
    emit("mnist_o1", config="BASELINE 1: MLP((256, 256)), B 256, O1, "
                            "SGD(0.05)", steps=MNIST_STEPS, losses=losses,
         step_ms=[t * 1e3 for t in times], step_ms_p50_steps_3_to_20=p50,
         samples_per_s=256 / (p50 / 1e3), launches=counts,
         launches_per_step=per_step, leaves=len(a.params),
         unscale_pointer_rows=unscale_rows,
         injected_overflow={"skipped": True,
                            "loss_scale": [scale, float(info["loss_scale"])]})
    return counts


DCGAN_STEPS = 20
#: how far below its first value each GAN loss must fall at some iteration
GAN_FALL = 0.05


def phase_dcgan_o1():
    """BASELINE config 5: the DCGAN of ``examples/dcgan_main_amp.py`` (fm
    64, zdim 100, 32^2, B 64), a generator and a discriminator each with
    its own FusedAdam(2e-4, betas (0.5, 0.999)) and its own amp O1 (one
    dynamic scaler each), 20 iterations: finite losses, each network's
    loss falling below its first value at some iteration (the two losses
    oscillate against each other, so the minimum is checked, not the
    last), p50, samples/s, launches per iteration (K6 once a network,
    K11 twice); then an iteration with D's loss overflowed,
    which halves only D's scale and skips only D's step."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.dcgan import (Discriminator, Generator,
                                             d_loss, dcgan_step,
                                             synthetic_gan_batch)
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    torch.manual_seed(0)
    G = Generator(feature_maps=64, n_upsample=2, zdim=100).train()
    D = Discriminator(feature_maps=64, n_down=3, image_size=32).train()
    a_g = amp.initialize(G, FusedAdam(G.parameters(), lr=2e-4,
                                      betas=(0.5, 0.999)))
    a_d = amp.initialize(D, FusedAdam(D.parameters(), lr=2e-4,
                                      betas=(0.5, 0.999)))
    gen = torch.Generator().manual_seed(2)
    batches = [synthetic_gan_batch(gen, 64) for _ in range(DCGAN_STEPS + 1)]
    reset_launch_counts()
    rows6 = TableRows()
    dl, gl, times, scales = [], [], [], []
    for z, real in batches[:DCGAN_STEPS]:
        t0 = time.perf_counter()
        info = dcgan_step(a_g, a_d, z, real)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows6.mark()
        dl.append(float(info["d"]["loss"]))
        gl.append(float(info["g"]["loss"]))
        scales.append([float(info["d"]["loss_scale"]),
                       float(info["g"]["loss_scale"])])
        require(not bool(info["d"]["overflow"])
                and not bool(info["g"]["overflow"]),
                f"overflow in the DCGAN steps at {len(dl)}")
    counts = launch_counts()
    per_step = {k: c / DCGAN_STEPS for k, c in counts.items()}
    # one unscale a network: D's, then G's
    want = dict(NO_LAUNCHES, packed_scale=2, packed_adam_tree=2)
    require(per_step == want, f"DCGAN launches per step {per_step}, want "
                              f"{want}")
    unscale_rows = rows6.report()
    fell = {"d": min(dl[1:]) < dl[0] - GAN_FALL,
            "g": min(gl[1:]) < gl[0] - GAN_FALL}

    def poisoned(D_, G_, z, real):
        return d_loss(D_, G_, z, real) * float("inf")

    d_before = [p.detach().clone() for p in a_d.params]
    g_before = [p.detach().clone() for p in a_g.params]
    s_d, s_g = (float(a_d.scaler_state.loss_scale),
                float(a_g.scaler_state.loss_scale))
    info = dcgan_step(a_g, a_d, *batches[-1], d_loss_fn=poisoned)
    torch.cuda.synchronize()
    require(bool(info["d"]["overflow"]) and not bool(info["g"]["overflow"]),
            "the D overflow was not seen, or G's step saw one")
    require(float(info["d"]["loss_scale"]) == s_d / 2
            and float(info["g"]["loss_scale"]) == s_g,
            "a scale other than D's moved on D's overflow")
    require(all(torch.equal(p, q) for p, q in zip(a_d.params, d_before)),
            "D's parameters moved on its skipped step")
    require(any(not torch.equal(p, q) for p, q in zip(a_g.params, g_before)),
            "G's step was skipped on D's overflow")
    p50 = float(np.median(times[2:])) * 1e3
    emit("dcgan_o1", config="BASELINE 5: DCGAN fm 64, zdim 100, 32^2, B 64, "
                            "O1, two FusedAdam(2e-4, (0.5, 0.999)), one "
                            "scaler each", steps=DCGAN_STEPS, d_losses=dl,
         g_losses=gl, loss_scales_d_g=scales,
         step_ms=[t * 1e3 for t in times], step_ms_p50_steps_3_to_20=p50,
         samples_per_s=64 / (p50 / 1e3), launches=counts,
         launches_per_step=per_step, unscale_pointer_rows=unscale_rows,
         losses_fell_below_first_by=GAN_FALL, losses_fell=fell,
         injected_d_overflow={"d_skipped": True, "g_stepped": True,
                              "d_scale": [s_d, float(info["d"]["loss_scale"])],
                              "g_scale": [s_g, float(info["g"]["loss_scale"])]})
    require(all(np.isfinite(dl + gl)), f"DCGAN losses: {dl} {gl}")
    require(all(fell.values()), f"a DCGAN loss never fell below its first: "
                                f"D {dl}, G {gl}")
    del a_g, a_d, G, D
    torch.cuda.empty_cache()
    return counts


#: the phases a partial run (``--only``) takes, by name: to time another
#: checkout of the port (``--repo``) with this script's phase code
# -- amp's legacy surface, add_params, the input pipeline, sequence
# -- parallelism ----------------------------------------------------------

#: step p50s (ms) of earlier phases of this run, for the records that
#: print a step beside them (None in a partial run that skipped them)
STEP_P50 = {}
LEGACY_STEPS = 8
LEGACY_INF_AT = 2
#: the legacy MNIST run's ``clip_norm`` (``clip_master_grads``: K9)
LEGACY_CLIP = 1.0
#: card-vs-CPU limit of bf16 losses (PERF.md section 2)
LEGACY_LOSS_TOL = 2e-2


def _legacy_mnist(device):
    """BASELINE config 1's MLP((256, 256)) in bf16 under the legacy
    ``FP16_Optimizer(SGD(0.05, momentum 0.9), dynamic_loss_scale=True)``,
    B 256, ``LEGACY_STEPS`` steps clipped at ``LEGACY_CLIP`` with an inf
    in step ``LEGACY_INF_AT``'s input, from the same seeded weights and
    data on ``device``."""
    import copy
    import torch
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.models.mlp import (MLP, cross_entropy_loss,
                                           synthetic_mnist)
    torch.manual_seed(0)
    model = copy.deepcopy(MLP((256, 256), device="cpu")).to(
        device=device, dtype=torch.bfloat16)
    xs, ys = synthetic_mnist(torch.Generator().manual_seed(1), LEGACY_STEPS,
                             256, device="cpu")
    xs = xs.to(torch.bfloat16)
    xs[LEGACY_INF_AT, 0, 0] = float("inf")
    xs, ys = xs.to(device), ys.to(device)
    opt = FP16_Optimizer(torch.optim.SGD(model.parameters(), lr=0.05,
                                         momentum=0.9),
                         dynamic_loss_scale=True)
    losses, scales, overflows, times = [], [], [], []
    for i in range(LEGACY_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = cross_entropy_loss(model(xs[i]).float(), ys[i])
        opt.backward(loss)
        info = opt.step(clip_norm=LEGACY_CLIP)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        scales.append(float(info["loss_scale"]))
        overflows.append(bool(info["overflow"]))
    grads = [p.grad for p in opt.model_params]
    return dict(losses=losses, scales=scales, overflows=overflows,
                times=times, grads=grads)


def _legacy_gpt(cfg, tree):
    """gpt_small in bf16 under the legacy ``FP16_Optimizer(FusedAdam(3e-4),
    dynamic_loss_scale=True)`` at B 8 x L 2048, 10 steps: the inner
    FusedAdam takes the overflow flag on the card and writes the bf16
    copies in its pass (K11), the unscale is K6; nothing is read back."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, dtype=torch.bfloat16, trainable=True)
    opt = FP16_Optimizer(FusedAdam(model.parameters(), lr=3e-4),
                         dynamic_loss_scale=True)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, overflows, times = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = opt.backward(_gpt_loss(model, ids))
        info = opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        overflows.append(bool(info["overflow"]))
    counts = launch_counts()
    per_step = {k: c / TRAIN_STEPS for k, c in counts.items()}
    want = dict(gpt_pass_launches(cfg), packed_scale=1, packed_adam_tree=1)
    require(per_step == want, f"legacy FP16_Optimizer launches per step "
                              f"{per_step}, want {want}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0]
            and not any(overflows),
            f"legacy FP16_Optimizer losses {losses}, overflows {overflows}")
    p50 = float(np.median(times[2:])) * 1e3
    grads = [p.grad for p in opt.model_params]
    run = dict(model="gpt_small", dtype="bfloat16", batch=TRAIN_B,
               seq_len=TRAIN_L, optimizer="FP16_Optimizer(FusedAdam(3e-4))",
               steps=TRAIN_STEPS, losses=losses,
               step_ms=[t * 1e3 for t in times],
               step_ms_p50_steps_3_to_10=p50,
               amp_o2_train_step_ms_p50=STEP_P50.get("train"),
               tokens_per_s=TRAIN_B * TRAIN_L / (p50 / 1e3),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches_per_step=per_step, host_reads_a_step=0)
    return counts, run, grads, model, opt


def _add_params_case(cfg, tree):
    """gpt_small O2 + FusedAdam(3e-4), B 8 x L 2048: 2 steps, then
    ``Amp.add_params`` of a new ``Dense(768, 768)`` (an auxiliary loss on
    the embeddings uses it), then one step: K6 1 and K11 1 over all 150
    leaves, the old leaves at step 3 and the new at 1, and the masters,
    moments equal bit for bit to the plain Adam on the CPU from that
    step's gradients (the kept buffers) and the states before it."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.layers import Dense
    from apex_tpu_torch.ops.cuda import (launch_counts, packed_adam_tree_ref,
                                         reset_launch_counts)
    from apex_tpu_torch.ops.multi_tensor import ChunkTable, cached_tables
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.fused_adam import \
        bias_corrected_step_sizes
    model = params_from_jax(tree, cfg, trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt, opt_level="O2")
    torch.manual_seed(5)
    extra = Dense(cfg.hidden_size, cfg.hidden_size, device="cuda")
    grown = []

    def loss_fn(m, ids):
        loss = _gpt_loss(m, ids)
        if grown:
            aux = extra(m.tok_emb(ids)).float().square().mean()
            loss = loss + 1e-3 * aux
        return loss

    step = amp.make_train_step(a, model, loss_fn)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    before = [float(step(ids)["loss"]) for _ in range(2)]
    a.add_params(extra, prefix="extra")
    grown.append(True)
    names = list(a.masters)
    cpu = {k: [t.detach().cpu() for t in ts] for k, ts in (
        ("p", [a.masters[n] for n in names]),
        ("m", [opt.state[a.masters[n]]["exp_avg"]
               if "exp_avg" in opt.state[a.masters[n]]
               else torch.zeros_like(a.masters[n]) for n in names]),
        ("v", [opt.state[a.masters[n]]["exp_avg_sq"]
               if "exp_avg_sq" in opt.state[a.masters[n]]
               else torch.zeros_like(a.masters[n]) for n in names]))}
    torch.cuda.synchronize()
    reset_launch_counts()
    info = step(ids)
    torch.cuda.synchronize()
    counts = launch_counts()
    require(not bool(info["overflow"]), "add_params: the step overflowed")
    require(counts["packed_scale"] == 1 and counts["packed_adam_tree"] == 1,
            f"add_params: K6 {counts['packed_scale']}, K11 "
            f"{counts['packed_adam_tree']} launches in the step, want 1 / 1")
    n = len(names)
    k11_leaves = sum(t.n_leaves for t in opt.tables)
    k6_leaves = cached_tables()[-1].n_leaves
    require(n == 150 and k11_leaves == n and k6_leaves == n,
            f"add_params: {n} leaves, K11's tables {k11_leaves}, K6's "
            f"{k6_leaves}")
    steps = torch.stack([opt.state[a.masters[x]]["step"] for x in names])
    require(steps[:-2].eq(3).all() and steps[-2:].eq(1).all(),
            f"add_params: step counts {steps.tolist()}")
    sizes = bias_corrected_step_sizes(3e-4, 0.9, 0.999, steps).cpu()
    grads = [g.detach().cpu() for g in a.grad_buffers()]
    packed_adam_tree_ref(ChunkTable.of(cpu["p"]), cpu["p"], cpu["m"],
                         cpu["v"], grads, sizes, torch.ones(1), None,
                         beta1=0.9, beta2=0.999, eps=1e-8)
    same = all(torch.equal(a.masters[x].cpu(), p)
               and torch.equal(opt.state[a.masters[x]]["exp_avg"].cpu(), m)
               and torch.equal(opt.state[a.masters[x]]["exp_avg_sq"].cpu(),
                               v)
               for x, p, m, v in zip(names, cpu["p"], cpu["m"], cpu["v"]))
    require(same, "add_params: masters or moments differ from the plain "
                  "Adam on the CPU")
    rec = dict(model="gpt_small", opt_level="O2", grown_by="Dense(768, 768)",
               leaves_before=n - 2, leaves_after=n,
               losses_before=before, loss_after=float(info["loss"]),
               launches_in_the_step=counts, k11_table_leaves=k11_leaves,
               k6_table_leaves=k6_leaves,
               step_counts={"old": 3, "new": 1},
               masters_and_moments_equal_cpu_plain_adam=True)
    shapes = [tuple(a.masters[x].shape) for x in names]
    del a, opt, model, extra, step, cpu, grads
    torch.cuda.empty_cache()
    return counts, rec, shapes


def phase_amp_surface(cfg, tree):
    """The rest of amp's surface on the card: the legacy
    ``FP16_Optimizer`` on BASELINE config 1's MLP (bf16, SGD with
    momentum, dynamic scaling, clipped, an inf in step 2) against the
    same run on the CPU (scales and skips equal, losses within 2e-2) and on
    gpt_small (FusedAdam, 10 steps, timed beside the amp O2 step);
    ``Amp.add_params`` growing a gpt_small O2 state mid-run; K15 (the
    legacy ``DynamicLossScaler.has_overflow``) and K6 (the legacy
    unscale) against their plain versions on these leaf lists."""
    import torch
    from apex_tpu_torch.fp16_utils import DynamicLossScaler
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    reset_launch_counts()
    card = _legacy_mnist("cuda")
    mnist_counts = launch_counts()
    host = _legacy_mnist("cpu")
    require(card["overflows"] == host["overflows"]
            and card["overflows"][LEGACY_INF_AT]
            and sum(card["overflows"]) == 1,
            f"legacy MNIST skips: card {card['overflows']}, CPU "
            f"{host['overflows']}")
    require(card["scales"] == host["scales"]
            and card["scales"][LEGACY_INF_AT] == 2.0 ** 15,
            f"legacy MNIST scales: card {card['scales']}, CPU "
            f"{host['scales']}")
    taken = [i for i, o in enumerate(card["overflows"]) if not o]
    loss_err = max(abs(card["losses"][i] - host["losses"][i])
                   for i in taken)
    require(loss_err <= LEGACY_LOSS_TOL, f"legacy MNIST losses: card "
            f"{card['losses']}, CPU {host['losses']}")
    require(mnist_counts["packed_scale"] == LEGACY_STEPS
            and mnist_counts["packed_sumsq"] == LEGACY_STEPS
            and sum(mnist_counts.values()) == 2 * LEGACY_STEPS,
            f"legacy MNIST launches {mnist_counts}: want K6 (the "
            f"unscale) and K9 (the clip's norm) once a step")
    gpt_counts, gpt_run, gpt_grads, model, opt = _legacy_gpt(cfg, tree)
    # the legacy scaler's overflow scan (one K15 launch, one host read)
    # and unscale (K6) on the two runs' gradient lists
    scaler = DynamicLossScaler()
    require(not scaler.has_overflow(gpt_grads), "legacy scan: overflow")
    nf = [_nonfinite_case("legacy_mnist_bf16_grads", card["grads"], 4),
          _nonfinite_case("legacy_gpt_small_bf16_grads", gpt_grads, 3)]
    del model, opt, gpt_grads
    torch.cuda.empty_cache()
    addp_counts, addp, grown = _add_params_case(cfg, tree)
    # K6 as the legacy unscale runs it (bf16 into fp32 buffers) on the
    # MLP's leaves, and on gpt_small's 150 after the growth
    rng = np.random.default_rng(15)
    # (the MLP's leaves last to first: the case plants its inf in leaf 5)
    k6 = [_scale_case([tuple(g.shape) for g in card["grads"]][::-1], rng),
          _scale_case(grown, rng)]
    emit("amp_surface",
         legacy_mnist=dict(
             config="BASELINE 1: MLP((256, 256)) in bf16, B 256, "
                    "FP16_Optimizer(SGD(0.05, momentum=0.9), "
                    "dynamic_loss_scale=True), step(clip_norm=1.0)",
             steps=LEGACY_STEPS, inf_at=LEGACY_INF_AT,
             losses=card["losses"], cpu_losses=host["losses"],
             losses_max_abs_err=loss_err, loss_tolerance=LEGACY_LOSS_TOL,
             scales=card["scales"], overflows=card["overflows"],
             step_ms=[t * 1e3 for t in card["times"]],
             launches=mnist_counts, host_reads_a_step=1),
         legacy_gpt_small=gpt_run, add_params=addp,
         k15_cases=[{k: r[k] for k in ("case", "leaves", "ms", "plain_ms",
                                        "bound_ms")} for r in nf],
         k6_cases=[{k: r[k] for k in ("leaves", "ms", "plain_ms",
                                       "bound_ms")} for r in k6])
    return dict(legacy_gpt=gpt_counts, legacy_mnist=mnist_counts,
                add_params=addp_counts, k6=k6, k15=nf)


DP_PAIRS = 10


def phase_data_prefetch():
    """ResNet-50 O2 + FusedAdam at B 256 x 224^2 fed uint8 host batches
    (``host_synthetic_loader``) through ``DataPrefetcher`` with
    ``normalize_uint8`` (pinned copies and the normalize on a side
    stream), in turns with steps on a batch already on the card: the two
    p50s, the exact launches a step (K6 1, K11 1), and the normalized
    batches equal bit for bit to ``normalize_uint8`` on the CPU."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.data import (DataPrefetcher, host_synthetic_loader,
                                     normalize_uint8)
    from apex_tpu_torch.models import ARCHS
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    torch.manual_seed(0)
    model = ARCHS["resnet50"]()
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=RN_LR),
                       opt_level="O2")
    step = amp.make_train_step(a, model, _rn_loss)
    host = list(host_synthetic_loader(4, RN_B, RN_SIZE, seed=0))
    staged = [t.cuda() for t in normalize_uint8(
        (torch.from_numpy(host[0][0]), torch.from_numpy(host[0][1])))]
    pf = DataPrefetcher(host_synthetic_loader(DP_PAIRS + 2, RN_B, RN_SIZE,
                                              seed=0),
                        transform=normalize_uint8)
    first = pf.next()
    want = normalize_uint8((torch.from_numpy(host[0][0]),
                            torch.from_numpy(host[0][1])))
    bitwise = torch.equal(first[0].cpu(), want[0]) \
        and torch.equal(first[1].cpu(), want[1])
    require(bitwise, "the prefetched batch differs from normalize_uint8 "
                     "on the CPU")
    step(*first)                                   # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    times = {"prefetched": [], "staged": []}
    for _ in range(DP_PAIRS):
        for kind in ("prefetched", "staged"):
            t0 = time.perf_counter()
            batch = pf.next() if kind == "prefetched" else staged
            out = step(*batch)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            require(np.isfinite(float(out["loss"])),
                    "data_prefetch: a non-finite loss")
    counts = launch_counts()
    per_step = {k: c / (2 * DP_PAIRS) for k, c in counts.items()}
    require(per_step == dict(NO_LAUNCHES, packed_scale=1,
                             packed_adam_tree=1),
            f"data_prefetch launches per step {per_step}")
    p50 = {k: float(np.median(v[2:])) * 1e3 for k, v in times.items()}
    emit("data_prefetch", model="resnet50", opt_level="O2", batch=RN_B,
         image_size=RN_SIZE, lookahead=2, pairs=DP_PAIRS,
         uint8_batch_mb=host[0][0].nbytes / 1e6,
         step_ms={k: [t * 1e3 for t in v] for k, v in times.items()},
         step_ms_p50_steps_3_to_10=p50,
         prefetched_over_staged=p50["prefetched"] / p50["staged"],
         resnet_train_step_ms_p50=STEP_P50.get("resnet_train"),
         normalized_equal_cpu_bitwise=True, launches_per_step=per_step)
    del a, model, step, pf, staged
    torch.cuda.empty_cache()
    return counts


#: the ring's and Ulysses' local calls at gpt_small's width: (shape,
#: causal, masked) of the ring's causal diagonal block and full block at
#: L 8192 a rank (K13 + K14: K4's planes, 3.2 GB, pass the budget), and
#: of a masked block with a batch row whose keys are all masked (K4)
SP_BLOCKS = (((1, 8192, 12, 64), True, False),
             ((1, 8192, 12, 64), False, False),
             ((4, 1024, 16, 64), False, True))
SP_WORLD = 2
SP_STEPS = 3
SP_L = 16384
SP_PAIRS = 10
SP_LOSS_TOL = 2e-2
SP_DEADLINE_S = 600


def _sp_block_case(shape, causal, masked, gen):
    """K2 with ``return_lse`` and the backward with a cotangent on the lse
    (the ring's merge differentiates through it) at one ring block,
    against their plain versions (over slices of heads) by ``bf16_tol``
    and the row and norm limits; the route the backward takes; times and
    the bounds."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd, flash_attn_bwd_ref,
                                         flash_attn_fwd, flash_attn_fwd_ref,
                                         launch_counts, reset_launch_counts)
    b, l, h, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    dlse = torch.randn((b, l, h), generator=gen, device="cuda") * 0.1
    mask = None
    if masked:
        mask = torch.rand((b, l), generator=gen, device="cuda") > 0.3
        mask[-1] = False                   # a row of keys all masked
    kw = dict(causal=causal, kv_mask=mask, scale=d ** -0.5)
    reset_launch_counts()
    o, lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
    grads = flash_attn_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
    torch.cuda.synchronize()
    launches = {n: c for n, c in launch_counts().items() if c}
    ro, rlse = _plain_by_heads(flash_attn_fwd_ref, (q, k, v), kw)
    ref = _plain_by_heads(
        lambda q_, k_, v_, o_, lse_, do_, dlse_, **kw_: flash_attn_bwd_ref(
            q_, k_, v_, o_, lse_, do_, dlse=dlse_, **kw_),
        (q, k, v, o, lse, do, dlse), kw)
    errs = {"o": _max_err(o, ro)}
    require(errs["o"] <= bf16_tol(ro), f"ring block {shape}: o off by "
                                       f"{errs['o']}")
    live = rlse > -1e29
    require(torch.equal(live, lse > -1e29)
            and _max_err(lse[live], rlse[live]) <= 1e-3,
            f"ring block {shape}: lse differs from the plain version's")
    scaled = scaled_errs(f"ring block {shape} o", o, ro)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        errs[name] = _max_err(g, r)
        require(errs[name] <= bf16_tol(r) and torch.isfinite(
            g.float()).all(), f"ring block {shape}: {name} off by "
                              f"{errs[name]} (limit {bf16_tol(r)})")
        scaled_errs(f"ring block {shape} {name}", g, r)
    fused = fused_route(b, l, h, d)
    fwd_ms = time_ms(lambda: flash_attn_fwd(q, k, v, return_lse=True, **kw))
    bwd_ms = time_ms(lambda: flash_attn_bwd(q, k, v, o, lse, do, dlse=dlse,
                                            **kw))
    plain_fwd = time_ms(lambda: _plain_by_heads(flash_attn_fwd_ref,
                                                (q, k, v), kw))
    plain_bwd = time_ms(lambda: _plain_by_heads(
        lambda q_, k_, v_, o_, lse_, do_, dlse_, **kw_: flash_attn_bwd_ref(
            q_, k_, v_, o_, lse_, do_, dlse=dlse_, **kw_),
        (q, k, v, o, lse, do, dlse), kw))
    attn_mask = None if mask is None else mask[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal))
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    elem = b * l * h * d
    f_ms, f_by = bound(2 * (4 * elem) + 4 * b * l * h, 4 * d * pairs,
                       PEAK_BF16_FLOPS)
    b_ms, b_by = bound(2 * (7 * elem) + 8 * b * l * h, 10 * d * pairs,
                       PEAK_BF16_FLOPS)
    return _kernel_rec(
        kernel="ring_block", shape=list(shape), causal=causal,
        kv_mask=masked, all_masked_key_row=masked, launches=launches,
        backward_route="fused (K4)" if fused else "two-pass (K13 + K14)",
        max_abs_err=max(errs.values()), errs=errs, **scaled,
        fwd_ms=fwd_ms, fwd_plain_ms=plain_fwd, fwd_bound_ms=f_ms,
        fwd_bound_by=f_by, fwd_library_ms=sdpa,
        fwd_library_call="scaled_dot_product_attention (no lse)",
        bwd_ms=bwd_ms, bwd_plain_ms=plain_bwd, bwd_bound_ms=b_ms,
        bwd_bound_by=b_by,
        bwd_library_ms=None,
        bwd_library_null_reason="no PyTorch call's attention backward "
                                "takes a cotangent on the lse")


def _sp_batch(ids, rank, world):
    """This rank's block of ``ids (B, L)``: the ids, their global
    positions, the next tokens and the mask hiding the global last
    position (which has none)."""
    import torch
    b, l = ids.shape
    n = l // world
    lo, hi = rank * n, (rank + 1) * n
    nxt = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
    mask = torch.ones((b, n), device=ids.device)
    if rank == world - 1:
        mask[:, -1] = 0
    pos = torch.arange(lo, hi, device=ids.device)[None].expand(b, n)
    return ids[:, lo:hi], pos, nxt[:, lo:hi], mask


def _sp_loss(model, ids, pos, tgt, mask):
    from apex_tpu_torch.models import lm_loss
    return lm_loss(model(ids, pos), tgt, mask,
                   seq_axis_name=model.cfg.seq_axis_name)


def _sp_engines(rank, world, gen_seed=21):
    """``ring_attention`` and ``ulysses_attention`` (flash engine) on this
    rank's block at two gpt_small-width shapes, against the local kernel
    call on the whole sequence (the same inputs on every rank): the
    output and dq / dk / dv under a random cotangent within
    ``bf16_tol``; launches and collectives a call."""
    import torch
    from apex_tpu_torch.attention import (local_attention, ring_attention,
                                          ulysses_attention)
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.parallel import (collective_counts,
                                         reset_collective_counts)
    out = []
    for shape, causal, masked in (((1, SP_L, 12, 64), True, False),
                                  ((4, 2048, 16, 64), False, True)):
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        mask = None
        b, l = shape[:2]
        n = l // world
        if masked:
            mask = torch.rand((b, l), generator=gen, device="cuda") > 0.3
            mask[-1, n:] = False           # rank 1's block of keys masked
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_o = local_attention(*leaves, causal=causal, kv_mask=mask)
        ref_o.backward(do)
        sl = slice(rank * n, (rank + 1) * n)
        refs = [ref_o.detach()[:, sl]] + [t.grad[:, sl] for t in leaves]
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            mine = [t[:, sl].clone().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.synchronize()
            reset_launch_counts()
            reset_collective_counts()
            t0 = time.perf_counter()
            o = fn(*mine, "data", causal=causal,
                   kv_mask=None if mask is None else mask[:, sl])
            o.backward(do[:, sl])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = [o.detach()] + [t.grad for t in mine]
            errs = {}
            for part, g, r in zip(("o", "dq", "dk", "dv"), got, refs):
                errs[part] = _max_err(g, r)
                require(errs[part] <= bf16_tol(r)
                        and torch.isfinite(g.float()).all(),
                        f"rank {rank} {name} {shape}: {part} off the local "
                        f"call by {errs[part]} (limit {bf16_tol(r)})")
            out.append(dict(engine=name, shape=list(shape), causal=causal,
                            kv_mask=masked, errs=errs,
                            launches={k_: c for k_, c in
                                      launch_counts().items() if c},
                            collectives=collective_counts(),
                            seconds=secs))
    return out


def _sp_train(cfg, tree, ids, rank, world, impl, reference_grads=None):
    """``SP_STEPS`` steps of gpt_small O2 + FusedAdam(3e-4) with remat and
    ``seq_axis_name="data"`` on this rank's block, the gradients summed
    over the group; the first step's summed gradients against
    ``reference_grads`` where given; the global losses, the masters'
    sha256, launches and collectives a step."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (Reducer, all_reduce,
                                         collective_counts,
                                         reset_collective_counts)
    scfg = dataclasses.replace(cfg, remat=True, seq_axis_name="data",
                               seq_impl=impl)
    model = params_from_jax(tree, scfg, trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-4),
                       opt_level="O2")
    reducer = Reducer(gradient_average=False)
    batch = _sp_batch(ids, rank, world)
    res = {}
    # every rank takes part (the hops and the sum); rank 0 compares
    with torch.enable_grad():
        loss = a.run(_sp_loss, model, *batch)
        grads = reducer.reduce(list(torch.autograd.grad(loss, a.params)))
    if reference_grads is not None:
        res["first_gradients"] = _grads_vs(reference_grads, grads)
    del grads
    step = amp.make_train_step(a, model, _sp_loss, reduce_fn=reducer.reduce)
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_collective_counts()
    losses, times = [], []
    for _ in range(SP_STEPS):
        t0 = time.perf_counter()
        info = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(all_reduce(info["loss"])))
    counts = launch_counts()
    colls = collective_counts()
    colls["all_reduce"] -= SP_STEPS          # the reported losses
    res.update(losses=losses, step_s=times,
               launches_per_step={k: c / SP_STEPS for k, c in counts.items()
                                  if c},
               collectives_per_step={k: c / SP_STEPS
                                     for k, c in colls.items()},
               masters_sha256=_digest(a.masters.values()))
    del a, model, step
    torch.cuda.empty_cache()
    return res


#: the sequence-parallel first gradients against the whole sequence's,
#: in bf16 ulps (2**-8 of each leaf's largest |ref|): twice the flash
#: rows' 2, since each rank's partial gradient and their sum are rounded
#: to bf16, two roundings the whole-sequence gradient does not make (the
#: averaging reducer's error is half of every gradient: 128 such ulps)
SP_GRAD_ULPS = 4


def _grads_vs(ref, got) -> dict:
    """Each leaf's max |got - ref| in units of ``2**-8`` of the leaf's
    largest |ref| (``SP_GRAD_ULPS`` is the limit, which the phase
    checks): the worst and the median leaf."""
    ulps = sorted((_max_err(g, r) / (2.0 ** -8 * max(
        float(r.float().abs().max()), 1e-30)), i)
        for i, (r, g) in enumerate(zip(ref, got)))
    return {"worst_leaf_ulps": ulps[-1][0], "worst_leaf": ulps[-1][1],
            "median_leaf_ulps": ulps[len(ulps) // 2][0],
            "limit_ulps": SP_GRAD_ULPS}


def _sp_rank_gloo(out: Path) -> None:
    """One rank of the two-process gloo run on ``cuda:0`` (a ``--ddp-rank
    sp_gloo`` process): the engines against the local call; rank 0 then
    runs gpt_small's whole-sequence reference (B 1 x L 16384, remat, O2,
    3 steps, and its first gradients); then both ranks the ring and the
    Ulysses sequence-parallel steps from the same weights, 8192 tokens a
    rank.  Every block travels through the host (gloo)."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import gpt_small
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import multiproc
    multiproc.initialize(backend="gloo")
    r, w = dist.get_rank(), dist.get_world_size()
    res = {"rank": r, "world": w, "backend": dist.get_backend(),
           "device": torch.cuda.current_device(),
           "engines": _sp_engines(r, w)}
    cfg = gpt_small()
    tree = gpt_small_tree(cfg, seed=0)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, 1, SP_L),
                          device="cuda")
    ref_grads = None
    if r == 0:
        rcfg = dataclasses.replace(cfg, remat=True)
        model = params_from_jax(tree, rcfg, trainable=True)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-4),
                           opt_level="O2")
        with torch.enable_grad():
            loss = a.run(_gpt_loss, model, ids)
            ref_grads = [g.clone() for g in
                         torch.autograd.grad(loss, a.params)]
        step = amp.make_train_step(a, model, _gpt_loss)
        res["reference_losses"] = [float(step(ids)["loss"])
                                   for _ in range(SP_STEPS)]
        del a, model, step
        torch.cuda.empty_cache()
    for impl in ("ring", "ulysses"):
        res[impl] = _sp_train(cfg, tree, ids, r, w, impl, ref_grads)
    (out / f"sp_gloo{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _sp_nccl_world_one(cfg, tree):
    """NCCL at world size 1 in this process: gpt_small O2 + FusedAdam,
    remat, B 1 x L 16384, ``seq_axis_name`` set (the ring at one rank: no
    hop), ``SP_PAIRS`` steps in turns with the local remat model of the
    ``long_context`` phase from the same weights; both p50s, the launches
    and collectives a sequence-parallel step."""
    import socket
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (Reducer, collective_counts,
                                         reset_collective_counts)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        ids = torch.as_tensor(train_stream(cfg.vocab_size, 1, SP_L),
                              device="cuda")
        steps = {}
        for kind, c in (("local", dataclasses.replace(cfg, remat=True)),
                        ("seq_parallel", dataclasses.replace(
                            cfg, remat=True, seq_axis_name="data"))):
            model = params_from_jax(tree, c, trainable=True)
            a = amp.initialize(model, FusedAdam(model.parameters(),
                                                lr=3e-4), opt_level="O2")
            if kind == "local":
                steps[kind] = (amp.make_train_step(a, model, _gpt_loss),
                               (ids,))
            else:
                steps[kind] = (amp.make_train_step(
                    a, model, _sp_loss,
                    reduce_fn=Reducer(gradient_average=False).reduce),
                    _sp_batch(ids, 0, 1))
        times = {k: [] for k in steps}
        losses = {k: [] for k in steps}
        counts = {}
        for _ in range(SP_PAIRS):
            for kind, (step, batch) in steps.items():
                torch.cuda.synchronize()
                reset_launch_counts()
                reset_collective_counts()
                t0 = time.perf_counter()
                info = step(*batch)
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
                losses[kind].append(float(info["loss"]))
                for k_, c in launch_counts().items():
                    counts.setdefault(kind, dict(NO_LAUNCHES))[k_] += c
                if kind == "seq_parallel":
                    colls = collective_counts()
        per_step = {k: {n: c / SP_PAIRS for n, c in v.items()}
                    for k, v in counts.items()}
        # the same kernels as the local step, but the prologues: q and k
        # arrive rotated (no k^ prologue before K2)
        prologues = ("flash_fwd_prologue", "flash_bwd_prologue")
        sp = per_step["seq_parallel"]
        same = {k: v for k, v in per_step["local"].items()
                if k not in prologues}
        require({k: sp[k] for k in same} == same
                and sp["flash_fwd_prologue"] == 0,
                f"sequence-parallel launches per step {sp}, want {same} "
                f"and no forward prologue")
        loss_err = max(abs(p - q) for p, q in zip(losses["local"],
                                                  losses["seq_parallel"]))
        require(loss_err <= SP_LOSS_TOL and all(np.isfinite(
            losses["seq_parallel"])), f"NCCL world-one losses "
                                      f"{losses['seq_parallel']} vs local "
                                      f"{losses['local']}")
        p50 = {k: float(np.median(v[2:])) * 1e3 for k, v in times.items()}
        rec = dict(model="gpt_small", remat=True, opt_level="O2", batch=1,
                   seq_len=SP_L, steps_each=SP_PAIRS, in_turns=True,
                   losses=losses, losses_max_abs_err=loss_err,
                   step_ms={k: [t * 1e3 for t in v]
                            for k, v in times.items()},
                   step_ms_p50_steps_3_to_10=p50,
                   seq_parallel_over_local=p50["seq_parallel"]
                   / p50["local"],
                   long_context_phase_step_ms_p50=STEP_P50.get(
                       "long_context"),
                   launches_per_step=per_step,
                   collectives_per_step=colls, hop_via_host=False,
                   backend="nccl")
        del steps
        torch.cuda.empty_cache()
        return counts["seq_parallel"], rec
    finally:
        dist.destroy_process_group()


def phase_seq_parallel(cfg, tree, repo: Path):
    """Sequence parallelism at gpt_small's width: the ring's block calls
    (K2 with its lse, the backward with the lse's cotangent) against their
    plain versions; NCCL at world size 1 in this process (the step in
    turns with the local one); two gloo processes on ``cuda:0`` (the
    engines against the local call, then gpt_small's ring and Ulysses
    steps against the whole-sequence run).  No path across several cards
    runs here (one card), and gloo moves every block through the host."""
    import shutil
    import torch
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(13)
    blocks = [_sp_block_case(s, c, m, gen) for s, c, m in SP_BLOCKS]
    require(blocks[0]["launches"].get("flash_attn_bwd_dq") == 1
            and blocks[2]["launches"].get("flash_attn_bwd") == 1,
            f"ring block routes: {[b['launches'] for b in blocks]}")
    torch.cuda.empty_cache()
    nccl_counts, nccl = _sp_nccl_world_one(cfg, tree)
    out = HERE / "build" / "sp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        secs = _spawn_ranks("sp_gloo", SP_WORLD, repo, out)
    except SmokeFailure:
        for r in range(SP_WORLD):
            if (out / f"sp_gloo{r}.json").exists():
                print(f"sp rank {r}: "
                      f"{(out / f'sp_gloo{r}.json').read_text()[:20000]}",
                      file=sys.stderr)
        raise
    ranks = [json.loads((out / f"sp_gloo{r}.json").read_text())
             for r in range(SP_WORLD)]
    require(all(rk["backend"] == "gloo" and rk["device"] == 0
                for rk in ranks), "sp gloo ranks not gloo on cuda:0")
    ref = ranks[0]["reference_losses"]
    gloo = {}
    for impl in ("ring", "ulysses"):
        runs = [rk[impl] for rk in ranks]
        err = max(abs(p - q) for p, q in zip(ref, runs[0]["losses"]))
        require(err <= SP_LOSS_TOL, f"gloo {impl} losses "
                                    f"{runs[0]['losses']} vs whole-sequence "
                                    f"{ref}")
        require(len({r_["masters_sha256"] for r_ in runs}) == 1,
                f"gloo {impl}: the ranks' masters differ")
        first = runs[0]["first_gradients"]
        require(first["worst_leaf_ulps"] <= SP_GRAD_ULPS,
                f"gloo {impl}: summed first gradients off the "
                f"whole-sequence ones: {first}")
        gloo[impl] = dict(losses=runs[0]["losses"],
                          reference_losses=ref, losses_max_abs_err=err,
                          loss_tolerance=SP_LOSS_TOL,
                          first_gradients=runs[0]["first_gradients"],
                          masters_bitwise_equal=True,
                          step_s=[r_["step_s"] for r_ in runs],
                          launches_per_step_by_rank=[
                              r_["launches_per_step"] for r_ in runs],
                          collectives_per_step_by_rank=[
                              r_["collectives_per_step"] for r_ in runs])
    for rk in ranks:
        for e in rk["engines"]:
            want = "flash_attn_bwd" if e["kv_mask"] else "flash_attn_bwd_dq"
            require(e["launches"].get("flash_attn_fwd", 0) > 0
                    and e["launches"].get(want, 0) > 0,
                    f"rank {rk['rank']} {e['engine']} {e['shape']}: "
                    f"launches {e['launches']}")
    emit("seq_parallel", ring_blocks=[
        {k: b[k] for k in ("shape", "causal", "kv_mask", "backward_route",
                           "launches", "errs", "fwd_ms", "bwd_ms",
                           "fwd_bound_ms", "bwd_bound_ms")} for b in blocks],
        nccl_world_one=nccl,
        gloo_two_processes_on_cuda0=dict(
            world=SP_WORLD, tokens_a_rank=SP_L // SP_WORLD,
            hop_via_host=True, seconds=secs, gpt_small=gloo,
            engines=[rk["engines"] for rk in ranks]),
        multi_card="not run: the machine has one card")
    return nccl_counts, blocks


# -- the sixteenth slice: the RNN stack and weight norm, pipeline and
# -- expert parallelism ------------------------------------------------------

RNN_MODES = ("relu", "tanh", "gru", "lstm", "mlstm")
#: the card-against-CPU check of every mode: T x B x F -> H, both
#: directions, ragged lengths
RNN_T, RNN_B, RNN_F, RNN_H = 32, 16, 64, 512
RNN_TOL = {"fp32": 1e-4, "bf16_o2": 2e-2}
#: the mLSTM at flax's ``[0, 1/sqrt(H))`` init is chaotic: one fp32
#: rounding of its weights moves its outputs by 1.2e-6 of their largest
#: element (the fp32 case's ``rounding_response``, in fp64), the other
#: modes' by 1e-8 to 1.1e-7, and the card parts from the CPU by 12 to 120
#: times that response in every mode: 1.4e-4 / 3.1e-4 (outputs /
#: gradients) for the mLSTM, 2.3e-2 / 7.3e-2 at O2 (on an NVIDIA H100
#: 80GB HBM3 at 700 W)
RNN_TOL_MLSTM = {"fp32": 1e-3, "bf16_o2": 0.1}
#: the byte-level mLSTM of Radford et al. (arXiv:1704.01444, section 3):
#: 256 bytes embedded in 64, one mLSTM of 4096, a 4096 -> 256 decoder,
#: minibatches of 128 subsequences of 256 bytes
LM_VOCAB, LM_EMBED, LM_HIDDEN = 256, 64, 4096
LM_B, LM_T, LM_STEPS = 128, 256, 10
LM_LR = 5e-4
LM_FP32_TOL = 2e-2


def _rel_max_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    g, r = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))


def _flat_states(finals):
    import torch
    if isinstance(finals, torch.Tensor):
        return [finals]
    return [t for f in finals for t in _flat_states(f)]


def _rnn_case(mode: str, kind: str, seed: int) -> dict:
    """One mode, bidirectional, ragged lengths: the card against the CPU
    from the same weights, fp32 (``kind="fp32"``) or amp O2: outputs,
    final states and the gradients of every parameter and of the input
    under a random cotangent, each tensor's error over its largest
    element."""
    import copy
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.rnn import RNN
    gen = torch.Generator().manual_seed(seed)
    cpu = RNN(mode, RNN_F, RNN_H, bidirectional=True, device="cpu",
              generator=gen)
    card = copy.deepcopy(cpu).cuda()
    x = torch.randn((RNN_T, RNN_B, RNN_F), generator=gen)
    lengths = torch.randint(1, RNN_T + 1, (RNN_B,), generator=gen)
    lengths[0] = RNN_T
    cot = torch.randn((RNN_T, RNN_B, 2 * RNN_H), generator=gen)
    got = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        if kind == "fp32":
            params, run = list(model.parameters()), (lambda f, *a: f(*a))
        else:
            a = amp.initialize(model, FusedAdam(model.parameters(),
                                                device=dev),
                               opt_level="O2", device=dev)
            params, run = a.params, a.run
        xd = x.to(dev).requires_grad_(True)
        with torch.enable_grad():
            ys, finals = run(model, xd, None, lengths.to(dev))
            grads = torch.autograd.grad((ys.float() * cot.to(dev)).sum(),
                                        params + [xd])
        got[dev] = ([ys] + _flat_states(finals), list(grads))
    errs = {part: max(_rel_max_err(g, r) for g, r in
                      zip(got["cuda"][i], got["cpu"][i]))
            for i, part in enumerate(("outputs", "grads"))}
    tol = (RNN_TOL_MLSTM if mode == "mlstm" else RNN_TOL)[kind]
    require(max(errs.values()) <= tol,
            f"rnn {mode} {kind}: card vs CPU {errs} over {tol}")
    rec = dict(mode=mode, kind=kind, errs=errs, tolerance=tol)
    if kind == "fp32":
        rec["rounding_response"] = _rounding_response(cpu, x, lengths)
    return rec


def _rounding_response(model, x, lengths) -> float:
    """How far one fp32 rounding of the weights (relative noise of
    2**-24) moves the outputs, in fp64 on the CPU, over their largest
    element: the check's conditioning."""
    import copy
    import torch
    m64 = copy.deepcopy(model).double()
    with torch.no_grad():
        y0, _ = m64(x.double(), None, lengths)
        gen = torch.Generator().manual_seed(1)
        for p in m64.parameters():
            p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=gen,
                                                  dtype=torch.float64))
        y1, _ = m64(x.double(), None, lengths)
    return float((y1 - y0).abs().max() / y0.abs().max())


def byte_stream(b: int, t: int, seed: int = 0):
    """``(t, b)`` bytes, each column counting up by one from a seeded
    start (the next byte is the byte plus one)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, LM_VOCAB, (1, b))
    return (base + np.arange(t)[:, None]) % LM_VOCAB


def byte_lm(generator):
    """The byte-level mLSTM language model on the card: a 256 -> 64
    embedding, ``mLSTM(64, 4096)`` with every weight of at least 2
    dimensions weight-normed (the module form), and a ``Dense`` 4096 ->
    256 decoder; ``forward(ids (T, B)) -> logits (T, B, 256)``."""
    import torch
    from torch import nn
    from apex_tpu_torch.layers import Dense, Embed
    from apex_tpu_torch.reparameterization import apply_weight_norm
    from apex_tpu_torch.rnn import mLSTM

    class ByteLM(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = Embed(LM_VOCAB, LM_EMBED, device="cuda")
            self.rnn = apply_weight_norm(mLSTM(LM_EMBED, LM_HIDDEN,
                                               generator=generator))
            self.decoder = Dense(LM_HIDDEN, LM_VOCAB, device="cuda")

        def forward(self, ids):
            h, _ = self.rnn(self.embed(ids))
            return self.decoder(h)

    torch.manual_seed(0)
    return ByteLM()


def _byte_loss(model, ids):
    from apex_tpu_torch.models import lm_loss
    logits = model(ids).transpose(0, 1)
    return lm_loss(logits[:, :-1], ids.t()[:, 1:])


def _skipped(a, grads, opt, leaf: str, **apply_kw) -> dict:
    """``apply_gradients(grads)`` must skip: masters, ``leaf``'s moments
    and step count unchanged, the scale halved."""
    import torch
    masters = {n: t.clone() for n, t in a.masters.items()}
    st = opt.state[a.masters[leaf]]
    moments = (st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
               int(st["step"]))
    before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads, **apply_kw)
    torch.cuda.synchronize()
    ok = (bool(info["overflow"])
          and float(info["loss_scale"]) == before / 2
          and all(torch.equal(masters[n], t) for n, t in a.masters.items())
          and torch.equal(st["exp_avg"], moments[0])
          and torch.equal(st["exp_avg_sq"], moments[1])
          and int(st["step"]) == moments[2])
    return {"skipped": ok, "overflow": bool(info["overflow"]),
            "loss_scale": [before, float(info["loss_scale"])]}


def _wn_recompute_ms(model) -> float:
    """Device ms of one forward and backward of every weight-norm
    recompute of ``model`` (the hooks' own computation, CUDA events)."""
    import torch
    hooks = [(m, h) for m in model.modules()
             for h in m.__dict__.get("_reparam_hooks", {}).values()]

    def run():
        with torch.enable_grad():
            ws = [h.compute(m) for m, h in hooks]
            torch.autograd.backward(ws, [torch.ones_like(w) for w in ws])

    ms = time_ms(run)
    for p in model.parameters():
        p.grad = None
    return ms


def rnn_card_vs_cpu():
    """Every mode, fp32 and amp O2, card against CPU (``_rnn_case``)."""
    return [_rnn_case(mode, kind, 40 + i)
            for i, mode in enumerate(RNN_MODES)
            for kind in ("fp32", "bf16_o2")]


def byte_lm_run():
    """The byte-level mLSTM language model at full width, amp O2 +
    FusedAdam: losses, p50, bytes/s, peak memory, launches, one profiled
    step, the weight-norm recompute timed alone, an injected overflow
    skipped, the first O2 loss against an fp32 forward of the same
    weights.  Returns ``(record, launch counts)``."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    gen = torch.Generator().manual_seed(0)
    model = byte_lm(gen)
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.as_tensor(byte_stream(LM_B, LM_T), device="cuda")
    with torch.no_grad():
        fp32_loss = float(_byte_loss(model, ids))
    opt = FusedAdam(model.parameters(), lr=LM_LR)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _byte_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        info = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(info["loss"]))
        require(not bool(info["overflow"]), "lm step overflowed")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: c / LM_STEPS for k, c in counts.items()}
    want = dict(NO_LAUNCHES, packed_scale=1, packed_adam_tree=1)
    require(per_step == want, f"lm launches per step {per_step}, want "
                              f"{want}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"lm losses {losses}")
    require(abs(losses[0] - fp32_loss) <= LM_FP32_TOL,
            f"lm first O2 loss {losses[0]} vs fp32 {fp32_loss}")
    p50 = float(np.median(times[2:])) * 1e3
    profile = profile_step(step, ids)
    wn_ms = _wn_recompute_ms(model)
    with torch.enable_grad():
        grads = list(torch.autograd.grad(
            a.scale_loss(a.run(_byte_loss, model, ids)), a.params))
    grads[0].view(-1)[0] = float("inf")
    inf = _skipped(a, grads, opt, "decoder.kernel")
    require(inf["skipped"], f"lm injected inf not skipped: {inf}")
    groups = profile.get("by_group_ms", {})
    rec = dict(
        model="mLSTM 4096, 64-wide byte embedding, weight norm",
        source="Radford et al. arXiv:1704.01444 section 3",
        parameters=n_params, batch=LM_B, seq_len=LM_T, opt_level="O2",
        optimizer="FusedAdam", lr=LM_LR, steps=LM_STEPS, losses=losses,
        fp32_first_loss=fp32_loss,
        first_loss_vs_fp32=abs(losses[0] - fp32_loss),
        first_loss_tolerance=LM_FP32_TOL,
        step_ms=[t * 1e3 for t in times], step_ms_p50_steps_3_to_10=p50,
        bytes_per_s=LM_B * LM_T / (p50 / 1e3), peak_memory_gb=peak,
        launches_per_step={k: v for k, v in per_step.items() if v},
        profile=profile,
        device_ms_by_group=dict(
            gemms=groups.get("matmuls (cuBLAS)"),
            optimizer=(groups.get("adam_tree (K11)", 0.0)
                       + groups.get("packed_scale (K6)", 0.0))
            if groups else None,
            elementwise_cell_math_and_other=groups.get(
                "other PyTorch kernels"),
            weight_norm_recompute_fwd_bwd_alone_ms=wn_ms),
        injected_overflow=inf)
    del a, opt, model, step, grads
    torch.cuda.empty_cache()
    return rec, counts


def phase_rnn():
    """The RNN stack: every mode card against CPU (fp32 and amp O2), then
    the byte-level mLSTM language model at full width."""
    import torch
    torch.cuda.empty_cache()
    cases = rnn_card_vs_cpu()
    lm, counts = byte_lm_run()
    emit("rnn", card_vs_cpu=dict(
        shape=dict(steps=RNN_T, batch=RNN_B, features=RNN_F, hidden=RNN_H,
                   bidirectional=True, seq_lengths="ragged"),
        cases=cases), byte_lm=lm)
    return counts


PM_MICRO = 4
PM_PAIRS = 10
PM_GLOO_WORLD = 2
PM_GLOO_STEPS = 3
PM_LOSS_TOL = 2e-2
PM_LR = 3e-4
PM_MASTER_TOL = adam_drift_bound(PM_GLOO_STEPS, PM_LR) + 1e-5
#: the expert mode of examples/pipeline_moe.py at gpt_small's FFN width
MOE_D, MOE_HIDDEN, MOE_EXPERTS = 768, 3072, 8
MOE_TOKENS, MOE_CF, MOE_LR, MOE_STEPS = 16384, 2.0, 3e-3, 10
MOE_MASTER_TOL = adam_drift_bound(PM_GLOO_STEPS, MOE_LR) + 1e-5


def piped_gpt(full, blocks):
    """gpt_small with ``blocks`` (this rank's) as its pipeline stage over
    ``"pipe"``, ``PM_MICRO`` microbatches; the embedding, ``ln_f`` and
    the head outside the pipeline, on every rank."""
    from torch import nn
    import torch
    from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables
    from apex_tpu_torch.parallel import pipeline_apply

    class PipedGPT(nn.Module):
        def __init__(self):
            super().__init__()
            self.cfg = full.cfg
            self.tok_emb, self.ln_f = full.tok_emb, full.ln_f
            self.lm_head = full.lm_head
            self.stage = nn.ModuleList(blocks)

        def forward(self, ids):
            c = self.cfg
            b, l = ids.shape
            mb = b // PM_MICRO
            x = self.tok_emb(ids)
            pos = torch.arange(l, device=ids.device)[None].expand(mb, l)
            rope = rope_kernel_tables(
                *rope_tables(pos, c.head_dim, c.rope_theta), mb, l,
                c.head_dim, x.dtype)

            def stage(blks, h):
                for blk in blks:
                    h = blk(h, rope)
                return h

            y = pipeline_apply(stage, self.stage, x, "pipe",
                               n_microbatches=PM_MICRO, stacked=False)
            return self.lm_head(self.ln_f(y))

    return PipedGPT()


def _embedding_reduce(a, axis):
    """``reduce_fn`` of the pipelined GPT: the embedding feeds stage 0
    alone, so its gradient is summed over the pipe group; the head's and
    ``ln_f``'s are whole on every rank, the blocks' are the stage's."""
    from apex_tpu_torch.parallel import all_reduce
    names = list(a.masters)
    emb = names.index("tok_emb.embedding")

    def reduce_fn(grads):
        grads = list(grads)
        grads[emb] = all_reduce(grads[emb], axis)
        return grads

    return reduce_fn


def _pipe_launches(cfg, stage_layers, ticks):
    """A pipelined gpt_small step's launches: ``ticks`` runs of a stage
    of ``stage_layers`` blocks on a microbatch, ``ln_f`` once, one
    unscale and one Adam."""
    mb = TRAIN_B // PM_MICRO
    blk = gpt_pass_launches(dataclasses.replace(cfg,
                                                num_layers=stage_layers),
                            micro_batches=ticks, b=mb)
    # gpt_pass_launches counts a ln_f a pass: the pipeline's runs once
    blk["layer_norm_fwd"] -= ticks - 1
    blk["layer_norm_bwd"] -= 2 * (ticks - 1)
    return dict(blk, packed_scale=1, packed_adam_tree=1)


def moe_data(seed: int = 5):
    """The expert mode's tokens, targets and weights (numpy): ``x``
    ``(16384, 768)`` normal, ``tanh(x W)`` targets, experts 768 -> 3072
    -> 768 and the router drawn N(0, 1/fan_in) as gpt_small's kernels."""
    rng = np.random.default_rng(seed)
    d, h, e = MOE_D, MOE_HIDDEN, MOE_EXPERTS
    x = rng.standard_normal((MOE_TOKENS, d), np.float32)
    t = np.tanh(x @ (rng.standard_normal((d, d), np.float32) * d ** -0.5))
    return dict(x=x, target=t.astype(np.float32),
                wi=rng.standard_normal((e, d, h), np.float32) * d ** -0.5,
                wo=rng.standard_normal((e, h, d), np.float32) * h ** -0.5,
                router=rng.standard_normal((d, e), np.float32) * d ** -0.5)


def moe_model(data, first: int, count: int):
    """Experts ``first .. first + count - 1`` and the router, on the
    card."""
    import torch
    from torch import nn
    m = nn.Module()
    for k in ("wi", "wo"):
        setattr(m, k, nn.Parameter(torch.as_tensor(
            data[k][first:first + count], device="cuda")))
    m.router = nn.Parameter(torch.as_tensor(data["router"], device="cuda"))
    return m


def _moe_ffn(p, h):
    import torch.nn.functional as F
    return F.gelu(h @ p["wi"], approximate="tanh") @ p["wo"]


def moe_loss(model, xb, tgt, axis="expert"):
    """The example's loss: the residual, its mean square error, and 0.01
    times the aux loss; ``(loss, y, aux)``."""
    from apex_tpu_torch.parallel import moe_apply
    y, aux = moe_apply(_moe_ffn, {"wi": model.wi, "wo": model.wo},
                       model.router, xb, axis, capacity_factor=MOE_CF)
    out = xb + y
    return ((out - tgt).float() ** 2).mean() + 0.01 * aux.float(), y, aux


def _router_mean(a, axis, world):
    from apex_tpu_torch.parallel import all_reduce
    i = list(a.masters).index("router")

    def reduce_fn(grads):
        grads = list(grads)
        grads[i] = all_reduce(grads[i], axis) / world
        return grads

    return reduce_fn


def _timed_steps(steps, n):
    """``n`` rounds of every step of ``steps`` (name: (step, batch)), in
    turns: seconds and losses by name, and the launches and collectives
    of each name's steps."""
    import torch
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.parallel import (collective_counts,
                                         reset_collective_counts)
    times = {k: [] for k in steps}
    losses = {k: [] for k in steps}
    counts = {k: dict(NO_LAUNCHES) for k in steps}
    colls = {k: {} for k in steps}
    for _ in range(n):
        for k, (step, batch) in steps.items():
            torch.cuda.synchronize()
            reset_launch_counts()
            reset_collective_counts()
            t0 = time.perf_counter()
            info = step(*batch)
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
            losses[k].append(float(info["loss"]))
            require(not bool(info["overflow"]), f"{k} step overflowed")
            for name, c in launch_counts().items():
                counts[k][name] += c
            for name, c in collective_counts().items():
                colls[k][name] = colls[k].get(name, 0) + c
    per = {k: {n_: c / n for n_, c in v.items()} for k, v in counts.items()}
    per_coll = {k: {n_: c / n for n_, c in v.items()}
                for k, v in colls.items()}
    return times, losses, per, per_coll


def _pm_nccl_world_one(cfg, tree):
    """NCCL at world size 1 in this process: gpt_small's 12 blocks as one
    stage (4 microbatches) in turns with the local O2 step; the expert
    mode with all 8 experts local.  p50s, launches and collectives a
    step."""
    import socket
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        make_mesh((1,), ("pipe",))
        ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                              device="cuda")
        steps = {}
        for kind in ("local", "pipelined"):
            model = params_from_jax(tree, cfg, trainable=True)
            if kind == "pipelined":
                model = piped_gpt(model, model.blocks)
            a = amp.initialize(model, FusedAdam(model.parameters(),
                                                lr=PM_LR), opt_level="O2")
            kw = {} if kind == "local" else dict(
                reduce_fn=_embedding_reduce(a, "pipe"),
                finite_axes=("pipe",))
            steps[kind] = (amp.make_train_step(a, model, _gpt_loss, **kw),
                           (ids,))
        times, losses, per, colls = _timed_steps(steps, PM_PAIRS)
        want = _pipe_launches(cfg, cfg.num_layers, PM_MICRO)
        require(per["pipelined"] == want, f"pipelined launches "
                                          f"{per['pipelined']}, want {want}")
        err = max(abs(p - q) for p, q in zip(losses["local"],
                                             losses["pipelined"]))
        require(err <= PM_LOSS_TOL, f"pipelined losses "
                                    f"{losses['pipelined']} vs local "
                                    f"{losses['local']}")
        p50 = {k: float(np.median(v[2:])) * 1e3 for k, v in times.items()}
        profiles = {k: profile_step(step, *batch)
                    for k, (step, batch) in steps.items()}
        pipe = dict(model="gpt_small", opt_level="O2", batch=TRAIN_B,
                    seq_len=TRAIN_L, microbatches=PM_MICRO, stages=1,
                    steps_each=PM_PAIRS, in_turns=True, losses=losses,
                    losses_max_abs_err=err,
                    step_ms={k: [t * 1e3 for t in v]
                             for k, v in times.items()},
                    step_ms_p50_steps_3_to_10=p50,
                    pipelined_over_local=p50["pipelined"] / p50["local"],
                    train_phase_step_ms_p50=STEP_P50.get("train"),
                    launches_per_step=per, collectives_per_step=colls,
                    profiles=profiles,
                    flash_backward_route_a_microbatch="fused (K4)"
                    if fused_route(TRAIN_B // PM_MICRO, TRAIN_L,
                                   cfg.num_heads, cfg.head_dim)
                    else "two-pass (K13 + K14)")
        pipe_counts = {k: c * PM_PAIRS for k, c in per["pipelined"].items()}
        del steps
        torch.cuda.empty_cache()
        make_mesh((1,), ("expert",))
        data = moe_data()
        model = moe_model(data, 0, MOE_EXPERTS)
        opt = FusedAdam(model.parameters(), lr=MOE_LR)
        a = amp.initialize(model, opt, opt_level="O2")
        xb = torch.as_tensor(data["x"], device="cuda")
        tgt = torch.as_tensor(data["target"], device="cuda")
        step = amp.make_train_step(
            a, model, lambda m, x_: moe_loss(m, x_, tgt)[0],
            reduce_fn=_router_mean(a, "expert", 1), finite_axes=("expert",))
        torch.cuda.reset_peak_memory_stats()
        times, losses, per, colls = _timed_steps({"moe": (step, (xb,))},
                                                 MOE_STEPS)
        require(per["moe"]["packed_scale"] == 1
                and per["moe"]["packed_adam_tree"] == 1,
                f"moe launches per step {per['moe']}")
        require(all(np.isfinite(losses["moe"]))
                and losses["moe"][-1] < losses["moe"][0],
                f"moe losses {losses['moe']}")
        p50 = float(np.median(times["moe"][2:])) * 1e3
        profile = profile_step(step, xb)
        moe = dict(d=MOE_D, hidden=MOE_HIDDEN, experts=MOE_EXPERTS,
                   tokens=MOE_TOKENS, capacity_factor=MOE_CF,
                   opt_level="O2", lr=MOE_LR, steps=MOE_STEPS,
                   losses=losses["moe"],
                   step_ms=[t * 1e3 for t in times["moe"]],
                   step_ms_p50_steps_3_to_10=p50,
                   tokens_per_s=MOE_TOKENS / (p50 / 1e3),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches_per_step={k: v for k, v in per["moe"].items()
                                      if v},
                   collectives_per_step=colls["moe"], profile=profile)
        moe_counts = {k: c * MOE_STEPS for k, c in per["moe"].items()}
        del a, opt, model, step
        torch.cuda.empty_cache()
        return pipe, pipe_counts, moe, moe_counts
    finally:
        dist.destroy_process_group()


def _pm_rank_gloo(out: Path) -> None:
    """One rank of the two-process gloo run on ``cuda:0`` (a ``--ddp-rank
    pm_gloo`` process).  Pipeline: gpt_small's unpipelined O2 reference
    (B 8 x L 2048, 3 steps, on each rank), then 6 blocks a stage over the
    2 ranks (4 microbatches), 3 steps, then one step whose gradients hold
    an inf on rank 1 alone.  Experts: 4 a rank, 8192 tokens a rank: the
    first forward against one process holding all 8 (each rank's shard
    alone, a group of one rank), then 3 steps against that process's
    steps, and an inf on rank 1 alone.  Every hop and all-to-all goes
    through the host (gloo)."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import gpt_small
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (collective_counts, make_mesh,
                                         multiproc, reset_collective_counts)
    multiproc.initialize(backend="gloo")
    r, w = dist.get_rank(), dist.get_world_size()
    res = {"rank": r, "world": w, "backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    make_mesh((w,), ("pipe",))
    cfg = gpt_small()
    tree = gpt_small_tree(cfg, seed=0)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    model = params_from_jax(tree, cfg, trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=PM_LR),
                       opt_level="O2")
    step = amp.make_train_step(a, model, _gpt_loss)
    ref_losses = [float(step(ids)["loss"]) for _ in range(PM_GLOO_STEPS)]
    ref = {n: t.detach().clone() for n, t in a.masters.items()}
    del a, model, step
    torch.cuda.empty_cache()
    per = cfg.num_layers // w
    full = params_from_jax(tree, cfg, trainable=True)
    mine = list(range(r * per, (r + 1) * per))
    model = piped_gpt(full, [full.blocks[i] for i in mine])
    del full
    opt = FusedAdam(model.parameters(), lr=PM_LR)
    a = amp.initialize(model, opt, opt_level="O2")
    reduce_fn = _embedding_reduce(a, "pipe")
    step = amp.make_train_step(a, model, _gpt_loss, reduce_fn=reduce_fn,
                               finite_axes=("pipe",))
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_collective_counts()
    losses, times = [], []
    for _ in range(PM_GLOO_STEPS):
        t0 = time.perf_counter()
        info = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(info["loss"]))
    counts = {k: c / PM_GLOO_STEPS for k, c in launch_counts().items() if c}
    colls = {k: c / PM_GLOO_STEPS for k, c in collective_counts().items()}

    def ref_name(n):
        if not n.startswith("stage."):
            return n
        i, rest = n[len("stage."):].split(".", 1)
        return f"block_{mine[int(i)]}.{rest}"

    err = max(float((t - ref[ref_name(n)]).abs().max())
              for n, t in a.masters.items())
    with torch.enable_grad():
        grads = list(torch.autograd.grad(
            a.scale_loss(a.run(_gpt_loss, model, ids)), a.params))
    grads = reduce_fn(grads)
    if r == 1:
        grads[-1].view(-1)[0] = float("inf")
    inf = _skipped(a, grads, opt, "lm_head.kernel", finite_axes=("pipe",))
    res["pipeline"] = dict(
        stages=w, blocks_a_stage=per, microbatches=PM_MICRO,
        reference_losses=ref_losses, losses=losses,
        masters_vs_reference_max_abs_err=err, step_s=times,
        launches_per_step=counts, collectives_per_step=colls,
        inf_on_rank_1=inf)
    del a, opt, model, step, grads, ref
    torch.cuda.empty_cache()
    res["moe"] = _moe_gloo(r, w)
    (out / f"pm_gloo{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _moe_gloo(r, w):
    """The expert mode over the two gloo ranks against one process
    holding all 8 experts (each rank's shard through a group of its
    own)."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (all_reduce, collective_counts,
                                         make_mesh, reset_collective_counts)
    make_mesh((w,), ("expert",))
    alone = [dist.new_group([i]) for i in range(w)]
    data = moe_data()
    el, t = MOE_EXPERTS // w, MOE_TOKENS // w
    xs = torch.as_tensor(data["x"], device="cuda")
    ts = torch.as_tensor(data["target"], device="cuda")
    shard = slice(r * t, (r + 1) * t)
    # one process holding all 8 experts: every shard's loss, summed (the
    # group's objective), the router's gradient divided by W (the
    # group's reduce_fn averages it)
    ref_model = moe_model(data, 0, MOE_EXPERTS)
    ref_opt = FusedAdam(ref_model.parameters(), lr=MOE_LR)
    ra = amp.initialize(ref_model, ref_opt, opt_level="O2")
    with torch.no_grad():
        _, y_ref, aux_ref = ra.run(moe_loss, ref_model, xs[shard],
                                   ts[shard], alone[r])

    def ref_loss(m, x_):
        return sum(moe_loss(m, x_[i * t:(i + 1) * t], ts[i * t:(i + 1) * t],
                            alone[r])[0] for i in range(w))

    ri = list(ra.masters).index("router")

    def ref_reduce(grads):
        grads = list(grads)
        grads[ri] = grads[ri] / w
        return grads

    ref_step = amp.make_train_step(ra, ref_model, ref_loss,
                                   reduce_fn=ref_reduce)
    ref_losses = [float(ref_step(xs)["loss"]) / w
                  for _ in range(PM_GLOO_STEPS)]
    ref = {n: v.detach().clone() for n, v in ra.masters.items()}
    del ra, ref_opt, ref_model, ref_step
    torch.cuda.empty_cache()
    model = moe_model(data, r * el, el)
    opt = FusedAdam(model.parameters(), lr=MOE_LR)
    a = amp.initialize(model, opt, opt_level="O2")
    with torch.no_grad():
        _, y, aux = a.run(moe_loss, model, xs[shard], ts[shard])
    aux_ref_mean = float(all_reduce(aux_ref.float().reshape(1))) / w
    first = dict(y_err=_rel_max_err(y, y_ref),
                 aux=float(aux), aux_reference=aux_ref_mean,
                 aux_err=abs(float(aux) - aux_ref_mean),
                 tokens_dropped=int((y.float().abs().sum(-1) == 0).sum()),
                 tokens_dropped_reference=int(
                     (y_ref.float().abs().sum(-1) == 0).sum()))
    step = amp.make_train_step(
        a, model, lambda m, x_: moe_loss(m, x_, ts[shard])[0],
        reduce_fn=_router_mean(a, "expert", w), finite_axes=("expert",))
    reset_collective_counts()
    losses, times = [], []
    for _ in range(PM_GLOO_STEPS):
        t0 = time.perf_counter()
        info = step(xs[shard])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(all_reduce(info["loss"].reshape(1))) / w)
    colls = collective_counts()
    colls["all_reduce"] -= PM_GLOO_STEPS          # the reported losses
    err = max(float((v - ref[n] if n == "router"
                     else v - ref[n][r * el:(r + 1) * el]).abs().max())
              for n, v in a.masters.items())
    with torch.enable_grad():
        grads = list(torch.autograd.grad(a.scale_loss(a.run(
            lambda m, x_: moe_loss(m, x_, ts[shard])[0], model,
            xs[shard])), a.params))
    grads = _router_mean(a, "expert", w)(grads)
    if r == 1:
        grads[0].view(-1)[0] = float("inf")
    inf = _skipped(a, grads, opt, "router", finite_axes=("expert",))
    return dict(experts_a_rank=el, tokens_a_rank=t, first_forward=first,
                reference_losses=ref_losses, losses=losses,
                masters_vs_reference_max_abs_err=err, step_s=times,
                collectives_per_step={k: c / PM_GLOO_STEPS
                                      for k, c in colls.items()},
                inf_on_rank_1=inf)


def phase_pipeline_moe(cfg, tree, repo: Path):
    """Pipeline and expert parallelism: NCCL at world size 1 in this
    process (the pipelined gpt_small step in turns with the local one;
    the expert mode's step), then two gloo processes on ``cuda:0`` (6
    blocks a stage, 4 experts a rank) against one-process references,
    and one rank's inf skipping both ranks' step.  No path across several
    cards runs here (one card), and gloo moves every hop through the
    host."""
    import shutil
    import torch
    torch.cuda.empty_cache()
    pipe, pipe_counts, moe, moe_counts = _pm_nccl_world_one(cfg, tree)
    out = HERE / "build" / "pm"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        secs = _spawn_ranks("pm_gloo", PM_GLOO_WORLD, repo, out)
    except SmokeFailure:
        for r in range(PM_GLOO_WORLD):
            if (out / f"pm_gloo{r}.json").exists():
                print(f"pm rank {r}: "
                      f"{(out / f'pm_gloo{r}.json').read_text()[:20000]}",
                      file=sys.stderr)
        raise
    ranks = [json.loads((out / f"pm_gloo{r}.json").read_text())
             for r in range(PM_GLOO_WORLD)]
    require(all(rk["backend"] == "gloo" and rk["device"] == 0
                for rk in ranks), "pm gloo ranks not gloo on cuda:0")
    for rk in ranks:
        p, m = rk["pipeline"], rk["moe"]
        perr = max(abs(a - b) for a, b in zip(p["losses"],
                                              p["reference_losses"]))
        require(perr <= PM_LOSS_TOL, f"rank {rk['rank']} pipelined losses "
                                     f"{p['losses']} vs "
                                     f"{p['reference_losses']}")
        require(p["masters_vs_reference_max_abs_err"] <= PM_MASTER_TOL,
                f"rank {rk['rank']} pipelined masters off: "
                f"{p['masters_vs_reference_max_abs_err']}")
        require(p["inf_on_rank_1"]["skipped"],
                f"rank {rk['rank']}: rank 1's inf not skipped: "
                f"{p['inf_on_rank_1']}")
        f = m["first_forward"]
        require(f["y_err"] <= PM_LOSS_TOL and f["aux_err"] <= PM_LOSS_TOL,
                f"rank {rk['rank']} moe first forward {f}")
        merr = max(abs(a - b) for a, b in zip(m["losses"],
                                              m["reference_losses"]))
        require(merr <= PM_LOSS_TOL, f"rank {rk['rank']} moe losses "
                                     f"{m['losses']} vs "
                                     f"{m['reference_losses']}")
        require(m["masters_vs_reference_max_abs_err"] <= MOE_MASTER_TOL,
                f"rank {rk['rank']} moe masters off: "
                f"{m['masters_vs_reference_max_abs_err']}")
        require(m["inf_on_rank_1"]["skipped"],
                f"rank {rk['rank']}: moe rank 1's inf not skipped")
        p["losses_max_abs_err"], m["losses_max_abs_err"] = perr, merr
    emit("pipeline_moe", pipeline_nccl_world_one=pipe,
         moe_nccl_world_one=moe,
         gloo_two_processes_on_cuda0=dict(
             world=PM_GLOO_WORLD, seconds=secs, hop_via_host=True,
             loss_tolerance=PM_LOSS_TOL,
             pipeline_master_tolerance=PM_MASTER_TOL,
             moe_master_tolerance=MOE_MASTER_TOL,
             pipeline=[rk["pipeline"] for rk in ranks],
             moe=[rk["moe"] for rk in ranks]),
         multi_card="not run: the machine has one card")
    return pipe_counts, moe_counts


# -- resilience: durable checkpoints and the self-healing loop ----------------

RES_STEPS = 12
RES_EVERY = 4
RES_PREEMPT_AT = 8
RES_MIN_SCALE = 2.0 ** 14
RES_KEEP = 2
RES_WATCHDOG_S = 2.0
RES_HANG_S = 4.0
RES_TURNS = 2
#: the storm: poisoned from step index 8 for 4 firings; with the scale's
#: floor at 2**14 (from 2**16) it pins at step 9, and 2 pinned overflows
#: in a row (steps 9 and 10) call the rewind before the save of step 11
RES_STORM = dict(step=8, duration=4)
RES_PATIENCE = 2
#: the corrupted commit: the snapshot of step index 7 (8 steps done)
RES_CORRUPT_AT = 7


def _res_batches(cfg):
    """The resilience phase's batches, a function of the step index: the
    train stream shifted by the index, and a zero poison row (the
    floating tensor a NaN storm poisons; ``_gpt_loss_poisoned``), on the
    card, made once."""
    import torch
    base = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                           device="cuda")
    made = [((base + i) % cfg.vocab_size,
             torch.zeros(TRAIN_B, device="cuda"))
            for i in range(RES_STEPS)]
    return lambda i: made[i]


def _res_amp(cfg, tree, device="cuda"):
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, trainable=True, device=device)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-4,
                                        device=device),
                       opt_level="O2", min_loss_scale=RES_MIN_SCALE,
                       device=device)
    return a, amp.make_train_step(a, model, _gpt_loss_poisoned)


def _host_state(a):
    """``{leaf name: CPU tensor}`` of an amp state's checkpoint payload."""
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.resilience.durable import tree_leaves_with_path
    return dict(tree_leaves_with_path(checkpoint.state_dict(a)))


def _state_diff(got: dict, want: dict) -> dict:
    """Bitwise equality of two host states, and the largest absolute
    difference of the masters and of each moment where they differ."""
    import torch
    require(list(got) == list(want), "the states name other leaves")
    out = {"bitwise": True, "masters": 0.0, "m": 0.0, "v": 0.0,
           "counts_equal": True}
    for k, w in want.items():
        g = got[k]
        if torch.equal(g, w):
            continue
        out["bitwise"] = False
        if k.startswith("['master_params']"):
            cat = "masters"
        elif k.startswith("['opt_state'].m"):
            cat = "m"
        elif k.startswith("['opt_state'].v"):
            cat = "v"
        else:
            out["counts_equal"] = False
            continue
        out[cat] = max(out[cat], float((g.double() - w.double()).abs()
                                       .max()))
    return out


def _timed_step(step, stamps):
    def timed(*batch):
        stamps.append(time.perf_counter())
        return step(*batch)
    return timed


def _p50_intervals(stamps):
    gaps = np.diff(np.asarray(stamps)) * 1e3
    return float(np.median(gaps)), gaps.tolist()


def _plain_run(step, batch, n):
    """The plain loop: each step queued, its loss's copy queued right
    behind it (``HostCopy``: a pinned buffer and an event), and the
    previous step's copy read after the next step is queued — the
    resilient loop's one-step lag, without waiting for the step just
    queued."""
    import torch
    from apex_tpu_torch.obs.metrics import HostCopy
    stamps, losses, prev = [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        stamps.append(time.perf_counter())
        copy = HostCopy([step(*batch(i))["loss"]])
        if prev is not None:
            losses.append(float(prev.result()[0]))
        prev = copy
    losses.append(float(prev.result()[0]))
    torch.cuda.synchronize()
    return stamps, losses, time.perf_counter() - t0


def _timed_manager(directory, **kw):
    """A durable manager whose ``save`` (the training thread's blocking
    part) and commits (the writer thread: from the save hook to the
    commit hook) are timed."""
    from apex_tpu_torch.resilience import DurableCheckpointManager
    rec = {"save_ms": [], "writer_ms": [], "commits": []}
    starts = []
    mgr = DurableCheckpointManager(
        directory, max_to_keep=RES_KEEP,
        io_hook=lambda op: starts.append(time.perf_counter())
        if op == "save" else None,
        on_commit=lambda s, p: (rec["writer_ms"].append(
            (time.perf_counter() - starts[-1]) * 1e3),
            rec["commits"].append(s)), **kw)
    save = mgr.save

    def timed_save(step, state, extras=None):
        t0 = time.perf_counter()
        save(step, state, extras)
        rec["save_ms"].append((time.perf_counter() - t0) * 1e3)

    mgr.save = timed_save
    return mgr, rec


def _snapshot_bytes(path) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return sum(m["bytes"] for m in json.load(f)["leaves"].values())


def phase_resilience(cfg, tree):
    """Durable checkpoints and the self-healing loop on gpt_small O2 +
    FusedAdam at B 8 x L 2048 (12 layers, seeded weights; batches a
    function of the step index), under a temporary directory deleted at
    the end (at most 2 snapshots of ~1.5 GB kept): (a) the plain loop and
    ``run_resilient`` (a checkpoint every 4 steps) in turns, from the same
    initial state restored in place each time; (b) a preemption at step
    8, then a fresh model, Amp and manager restore and run to step 12;
    (c) a NaN storm that pins the scale after the snapshot of step index
    7 was corrupted on commit: the rewind skips it and lands on step
    index 3; (d) a flaky save absorbed by ``retry_io``; (e) a hung step
    under a 2 s watchdog; (f) the card's snapshot restored into a CPU
    template, bit for bit."""
    import shutil
    import tempfile
    import torch
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.resilience import (
        CorruptCheckpoint, DurableCheckpointManager, FaultInjector, FlakyIO,
        HangStep, NaNStorm, Preempt, ResilienceConfig, SimulatedPreemption,
        WatchdogTimeout, read_snapshot, run_resilient, validate_incident)
    from apex_tpu_torch.obs import Registry
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="apex_tpu_torch_resilience_")
    try:
        a, step = _res_amp(cfg, tree)
        batch = _res_batches(cfg)
        init = checkpoint.state_dict(a)
        step(*batch(0))                       # warm-up, then back to init
        torch.cuda.synchronize()

        def reset():
            checkpoint.load_state_dict(a, init)
            torch.cuda.synchronize()

        cfg_a = ResilienceConfig(checkpoint_every=RES_EVERY,
                                 watchdog_timeout_s=120.0)
        # (a) the loop's overhead, in turns with the plain loop
        plain, resil, ref, spread, runs = [], [], None, [], []
        counts = None
        for turn in range(RES_TURNS):
            reset()
            stamps, losses, wall = _plain_run(step, batch, RES_STEPS)
            p50, gaps = _p50_intervals(stamps)
            plain.append(dict(step_ms_p50=p50, step_gaps_ms=gaps,
                              wall_s=wall, losses=losses))
            state = _host_state(a)
            if ref is None:
                ref, ref_losses = state, losses
            else:
                spread.append(_state_diff(state, ref))
            runs.append(("plain", losses))
            reset()
            d = os.path.join(root, f"overhead{turn}")
            mgr, rec = _timed_manager(d)
            stamps = []
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = run_resilient(_timed_step(step, stamps), a, batch,
                                   RES_STEPS, manager=mgr, config=cfg_a,
                                   registry=Registry())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if counts is None:
                counts = launch_counts()
            p50, gaps = _p50_intervals(stamps)
            losses = [v for _, v in result.losses]
            resil.append(dict(step_ms_p50=p50, step_gaps_ms=gaps,
                              wall_s=wall, losses=losses,
                              save_blocking_ms=rec["save_ms"],
                              writer_ms=rec["writer_ms"],
                              commits=rec["commits"],
                              on_disk=mgr.all_steps()))
            spread.append(_state_diff(_host_state(a), ref))
            runs.append(("resilient", losses))
            require(rec["commits"] == [3, 7, 11],
                    f"commits {rec['commits']}, want [3, 7, 11]")
            require(mgr.all_steps() == [7, 11],
                    f"retention kept {mgr.all_steps()}")
            if turn == RES_TURNS - 1:
                # restore timing on this run's last snapshot (warm reads),
                # and (f): the card's snapshot into a CPU template
                path = mgr.path_of(11)
                nbytes = _snapshot_bytes(path)
                t0 = time.perf_counter()
                read_snapshot(path)
                read_ms = (time.perf_counter() - t0) * 1e3
                final = _host_state(a)
                reset()
                t0 = time.perf_counter()
                mgr.restore(a)
                torch.cuda.synchronize()
                restore_ms = (time.perf_counter() - t0) * 1e3
                require(_state_diff(_host_state(a), final)["bitwise"],
                        "the card's restore is not bit for bit")
                cpu_a, _ = _res_amp(cfg, tree, device="cpu")
                t0 = time.perf_counter()
                DurableCheckpointManager(d).restore(cpu_a)
                cpu_restore_ms = (time.perf_counter() - t0) * 1e3
                to_cpu = _state_diff(_host_state(cpu_a), final)
                require(to_cpu["bitwise"],
                        f"card -> CPU restore not bitwise: {to_cpu}")
                compute_ok = all(
                    torch.equal(p, m.to(torch.bfloat16)) for p, m in
                    zip(cpu_a.params, cpu_a.masters.values()))
                require(compute_ok, "the CPU compute params are not the "
                                    "bf16 rounding of the restored masters")
                del cpu_a, final
            mgr.close()
            shutil.rmtree(d)
        deterministic = all(s["bitwise"] for s in spread) and all(
            l == ref_losses for _, l in runs)
        per = {k: v / RES_STEPS for k, v in counts.items()}
        want = dict(gpt_pass_launches(cfg), packed_scale=1,
                    packed_adam_tree=1,
                    packed_nonfinite=3 / RES_STEPS)    # the save's check
        require(per == want, f"resilient launches a step {per}, want "
                             f"{want}")
        p_p50 = float(np.median([r["step_ms_p50"] for r in plain]))
        r_p50 = float(np.median([r["step_ms_p50"] for r in resil]))
        overhead = dict(
            turns=RES_TURNS, plain=plain, resilient=resil,
            plain_step_ms_p50=p_p50, resilient_step_ms_p50=r_p50,
            overhead_p50=r_p50 / p_p50 - 1.0,
            plain_wall_s=[r["wall_s"] for r in plain],
            resilient_wall_s=[r["wall_s"] for r in resil],
            save_blocking_ms=[x for r in resil for x in
                              r["save_blocking_ms"]],
            writer_ms=[x for r in resil for x in r["writer_ms"]],
            snapshot_bytes=nbytes, restore_read_verify_ms=read_ms,
            restore_ms=restore_ms, restore_upload_ms=restore_ms - read_ms,
            restore_into_cpu_ms=cpu_restore_ms,
            uninterrupted_runs_spread=spread, deterministic=deterministic)

        # (b) preempted at step 8, resumed by a fresh model, Amp, manager
        reset()
        d = os.path.join(root, "preempt")
        mgr = DurableCheckpointManager(d, max_to_keep=RES_KEEP)
        inj = FaultInjector([Preempt(step=RES_PREEMPT_AT)])
        inc = os.path.join(root, "INCIDENT_preempt.json")
        try:
            run_resilient(step, a, batch, RES_STEPS, manager=mgr,
                          config=ResilienceConfig(
                              checkpoint_every=RES_EVERY,
                              watchdog_timeout_s=120.0, incident_path=inc),
                          injector=inj, registry=Registry())
            raise SmokeFailure("the preemption did not fire")
        except SimulatedPreemption:
            pass
        mgr.close()
        with open(inc) as f:
            rec = json.load(f)
        require(rec["status"] == "preempted" and validate_incident(rec) == [],
                f"preemption incident {rec.get('status')}: "
                f"{validate_incident(rec)}")
        b, step_b = _res_amp(cfg, tree)
        mgr_b = DurableCheckpointManager(d, max_to_keep=RES_KEEP)
        mgr_b.restore(b)
        restored_at = mgr_b.last_restore["step"]
        require(restored_at == RES_PREEMPT_AT - 1,
                f"restored step {restored_at}, want {RES_PREEMPT_AT - 1}")
        resumed = run_resilient(step_b, b, batch, RES_STEPS, manager=mgr_b,
                                config=cfg_a, registry=Registry(),
                                start_step=RES_PREEMPT_AT)
        mgr_b.close()
        resumed_losses = [v for _, v in resumed.losses]
        vs_ref = _state_diff(_host_state(b), ref)
        loss_err = max(abs(x - y) for x, y in
                       zip(resumed_losses, ref_losses[RES_PREEMPT_AT:]))
        if deterministic:
            require(vs_ref["bitwise"] and loss_err == 0.0,
                    f"the resumed run is not bit for bit: {vs_ref}, "
                    f"losses {resumed_losses}")
            held = "bitwise (the uninterrupted runs agree bit for bit)"
        else:
            worst = {c: max(s[c] for s in spread)
                     for c in ("masters", "m", "v")}
            require(all(vs_ref[c] <= worst[c] for c in worst)
                    and vs_ref["counts_equal"],
                    f"the resumed run {vs_ref} is outside the spread "
                    f"{worst} of the uninterrupted runs")
            held = f"within the uninterrupted runs' spread {worst}"
        preempt = dict(preempt_at=RES_PREEMPT_AT, restored_step=restored_at,
                       resumed_losses=resumed_losses,
                       uninterrupted_losses=ref_losses[RES_PREEMPT_AT:],
                       loss_max_abs_err=loss_err, vs_uninterrupted=vs_ref,
                       held=held, incident_status=rec["status"])
        del b, step_b
        shutil.rmtree(d)
        torch.cuda.empty_cache()

        # (c) a NaN storm pinning the scale after a corrupted commit
        reset()
        d = os.path.join(root, "storm")
        inj = FaultInjector([CorruptCheckpoint(step=RES_CORRUPT_AT,
                                               kind="corrupt"),
                             NaNStorm(**RES_STORM)], seed=0)
        mgr = DurableCheckpointManager(d, max_to_keep=RES_KEEP, fsync=False,
                                       on_commit=inj.on_commit)
        reset_launch_counts()
        storm = run_resilient(
            step, a, batch, RES_STEPS, manager=mgr,
            config=ResilienceConfig(checkpoint_every=RES_EVERY,
                                    overflow_patience=RES_PATIENCE,
                                    max_rewinds=2, watchdog_timeout_s=120.0),
            injector=inj, registry=Registry())
        storm_counts = launch_counts()
        last = mgr.last_restore
        mgr.close()
        rewinds = [e for e in storm.events if e["event"] == "rewind"]
        require(storm.rewinds == 1 and rewinds[0]["to_step"] == 3,
                f"storm rewinds {storm.events}")
        require(last["step"] == 3 and [s["step"] for s in last["skipped"]]
                == [RES_CORRUPT_AT],
                f"the rewind did not skip the corrupt snapshot: {last}")
        # resolving step 10 (the second pinned overflow) called the rewind
        at = [j for j, _ in storm.losses].index(10)
        after = [v for _, v in storm.losses[at + 1:]]
        require(all(np.isfinite(after)) and after[-1] < after[0],
                f"losses after the rewind do not fall: {storm.losses}")
        require(float(a.scaler_state.loss_scale) > RES_MIN_SCALE,
                "the scaler was not re-initialized by the rewind")
        storm_rec = dict(
            events=storm.events, injector_events=[
                {k: v for k, v in e.items() if k != "utc"}
                for e in inj.events],
            last_restore={"step": last["step"],
                          "skipped": [s["step"] for s in last["skipped"]]},
            losses=storm.losses, losses_after_rewind=after,
            steps_dispatched=storm_counts["packed_adam_tree"],
            steps_resolved=len(storm.losses),
            launches_k6=storm_counts["packed_scale"],
            launches_k11=storm_counts["packed_adam_tree"],
            loss_scale_after=float(a.scaler_state.loss_scale))
        shutil.rmtree(d)

        # (d) a flaky save, absorbed by retry_io
        reset()
        d = os.path.join(root, "flaky")
        inj = FaultInjector([FlakyIO(op="save", fails=2)])
        mgr = DurableCheckpointManager(d, async_save=False, io_retries=0,
                                       fsync=False, io_hook=inj.io_hook)
        flaky = run_resilient(
            step, a, batch, RES_EVERY, manager=mgr,
            config=ResilienceConfig(checkpoint_every=RES_EVERY,
                                    io_retries=3, io_backoff_s=0.05,
                                    watchdog_timeout_s=120.0),
            injector=inj, registry=Registry())
        retries = [e for e in flaky.events if e["event"] == "save_retry"]
        require(len(retries) == 2 and mgr.all_steps() == [RES_EVERY - 1],
                f"flaky save: {flaky.events}, on disk {mgr.all_steps()}")
        mgr.close()
        shutil.rmtree(d)

        # (e) a hung step under a 2 s watchdog
        reset()
        inc = os.path.join(root, "INCIDENT_watchdog.json")
        inj = FaultInjector([HangStep(step=2, seconds=RES_HANG_S)])
        t0 = time.time()
        try:
            run_resilient(step, a, batch, 4, config=ResilienceConfig(
                watchdog_timeout_s=RES_WATCHDOG_S, watchdog_poll_s=0.05,
                incident_path=inc), injector=inj, registry=Registry())
            raise SmokeFailure("the watchdog did not fire")
        except WatchdogTimeout:
            raised_s = time.time() - t0
        hang_start = next(e for e in inj.events if e["fault"] == "hang_step")
        with open(inc) as f:
            rec = json.load(f)
        written_s = os.path.getmtime(inc) - t0
        require(rec["status"] == "watchdog-timeout"
                and validate_incident(rec) == [],
                f"watchdog incident {rec.get('status')}: "
                f"{validate_incident(rec)}")
        # the record lands while the hang still holds the loop
        require(written_s < RES_HANG_S, f"incident written {written_s} s "
                                        f"after the run began")
        hang = dict(budget_s=RES_WATCHDOG_S, hang_s=RES_HANG_S,
                    incident_written_s=written_s, raised_s=raised_s,
                    hang_step=hang_start["step"],
                    flight_kinds=sorted({e["kind"] for e in
                                         rec["flight"]["events"]}))
        emit("resilience", model="gpt_small", opt_level="O2",
             optimizer="FusedAdam", lr=3e-4, batch=TRAIN_B, seq_len=TRAIN_L,
             steps=RES_STEPS, checkpoint_every=RES_EVERY,
             min_loss_scale=RES_MIN_SCALE, max_to_keep=RES_KEEP,
             fsync={"overhead_and_preempt": True, "storm_and_flaky": False},
             overhead=overhead, launches=counts,
             launches_per_resolved_step=per, preempt_and_resume=preempt,
             nan_storm_on_corrupt_snapshot=storm_rec,
             flaky_save={"retries": retries, "events": flaky.events},
             hang=hang,
             card_to_cpu_restore={"bitwise": True,
                                  "restore_ms": cpu_restore_ms},
             seconds=time.perf_counter() - t_phase)
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# -- fp8 training (amp O4) and the int8 KV cache ---------------------------

#: H100 SXM dense fp8 tensor-core rate (the data sheet's, at 700 W)
PEAK_FP8_FLOPS = 1979e12
#: gpt_small's ffn_in product at B 8 x L 2048: (16384 x 768) @ (768 x 3072)
QUANT_MM = (TRAIN_B * TRAIN_L, 768, 3072)
#: the O4 card-against-CPU reference: its steps, the loss bound (the
#: train reference's bf16 one) and the scales' relative bounds, by class,
#: stated before the first run (the CPU tests' bounds against JAX: a
#: one-ulp bf16 difference of an operand flips an e4m3 rounding, 2**-3)
O4_REF_STEPS = 4
O4_REF_LOSS_TOL = 2e-2
O4_SCALE_RTOL = {"input": 2.0 ** -5, "weight": 2.0 ** -7,
                 "grad": 2.0 ** -3}
#: ``scaled_matmul`` on the card against its plain version, relative to
#: the largest output: the fp8 tensor cores keep fewer bits than fp32 in
#: their partial sums (measured 2.6e-4 at K 768 on an NVIDIA H100 80GB
#: HBM3 at 700.00 W)
MM_REL_TOL = 2.0 ** -10
#: int8 against dense greedy tokens on the trained toy LM (the JAX
#: package's documented tolerance)
INT8_MATCH_MIN = 0.9
#: the accumulated O4 steps: micro-batches of B 4
O4_ACCUM = 2


def serve_requests(cfg):
    """The serve phase's 16 requests: prompts of 32-512 tokens, 32-128
    new tokens each, from seed 1."""
    rng = np.random.default_rng(1)
    return [(f"r{i}", rng.integers(0, cfg.vocab_size,
                                   int(rng.integers(32, 513))),
             int(rng.integers(32, 129))) for i in range(16)]


def _same_bits(got, want) -> bool:
    """Bit for bit on the host, NaN payloads aside."""
    import torch
    g, w = got.cpu(), want.cpu()
    if g.dtype != w.dtype or g.shape != w.shape:
        return False
    gn, wn = torch.isnan(g.float()), torch.isnan(w.float())
    size = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[g.element_size()]
    return bool(torch.equal(gn, wn)) and bool(torch.equal(
        g.contiguous().view(size)[~wn], w.contiguous().view(size)[~wn]))


def _quant_functions():
    """``quantize`` / ``dequantize`` / ``qdq`` (e4m3 and e5m2, fp32 and
    bf16 in), ``quantize_int8`` (per tensor and per channel),
    ``quantize_kv`` and ``record_amax`` on the card against the same calls
    on the CPU, bit for bit (NaN payloads aside), over 2**20 values with
    the edges (zeros, the fp8 maxima and past them, halfway points,
    subnormals, infinities, a NaN)."""
    import torch
    from apex_tpu_torch.quant import fp8, int8
    rng = np.random.default_rng(12)
    n = 1 << 20
    x = rng.standard_normal(n).astype(np.float32) * rng.choice(
        np.float32([1e-7, 1e-3, 1, 30, 500, 3e4, 1e5]), n)
    x[:16] = [0.0, -0.0, 448.0, -448.0, 464.0, 57344.0, -61440.0, 1.0625,
              1.1875, 2.0 ** -10, 1e-40, np.inf, -np.inf, np.nan, 3e38, 0.5]
    x = torch.from_numpy(x)
    cases, bad = 0, []

    def check(what, got, want):
        nonlocal cases
        cases += 1
        if not _same_bits(got, want):
            bad.append(what)
    for scale in (1.0, 0.37, 1536.0):
        s, sd = torch.tensor(scale), torch.tensor(scale, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            xc = x.to(dtype)
            xd = xc.cuda()
            for fmt in (fp8.FP8_E4M3, fp8.FP8_E5M2):
                name = f"{str(fmt)[6:]}/{str(dtype)[6:]}/{scale}"
                q, qd = fp8.quantize(xc, s, fmt), fp8.quantize(xd, sd, fmt)
                check(f"quantize {name}", qd, q)
                check(f"dequantize {name}", fp8.dequantize(qd, sd),
                      fp8.dequantize(q, s))
                check(f"qdq {name}", fp8.qdq(xd, sd, fmt),
                      fp8.qdq(xc, s, fmt))
        w = x[16:16 + 1024 * 768].reshape(1024, 768) * scale
        for axis in (None, 0, 1):
            q, sc = int8.quantize_int8(w, axis)
            qd, scd = int8.quantize_int8(w.cuda(), axis)
            check(f"quantize_int8 axis={axis}/{scale}", qd, q)
            check(f"quantize_int8 scale axis={axis}/{scale}", scd, sc)
        kv = (x[16:16 + 64 * 16 * 12 * 64].reshape(64, 16, 12, 64)
              * scale).bfloat16()
        kv[5, 3] = 0
        q, sc = int8.quantize_kv(kv)
        qd, scd = int8.quantize_kv(kv.cuda())
        check(f"quantize_kv/{scale}", qd, q)
        check(f"quantize_kv scales/{scale}", scd, sc)
    st = fp8.init_delayed_scaling(16, device="cpu")
    sd = fp8.init_delayed_scaling(16, device="cuda")
    for a in (2.0, float("inf"), 8.0, float("nan"), 1e-40, 3e38, 0.3):
        st = fp8.record_amax(st, torch.tensor(a), fp8.FP8_E5M2, 1)
        sd = fp8.record_amax(sd, torch.tensor(a, device="cuda"),
                             fp8.FP8_E5M2, 1)
        check(f"record_amax {a} history", sd.amax_history, st.amax_history)
        check(f"record_amax {a} scale", sd.scale, st.scale)
    require(not bad, f"quant functions on the card differ from the CPU: "
                     f"{bad}")
    return dict(values=n, cases=cases, all_bitwise=True)


@contextlib.contextmanager
def _counting_scaled_mm():
    """Counts the ``torch._scaled_mm`` calls made inside the block."""
    import torch
    orig, calls = torch._scaled_mm, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)
    torch._scaled_mm = counted
    try:
        yield calls
    finally:
        torch._scaled_mm = orig


def _scaled_matmul_case():
    """``scaled_matmul`` at gpt_small's ``ffn_in`` product (16384 x 768 @
    768 x 3072, bf16 in, delayed-style scales 448 / amax): its product
    through ``torch._scaled_mm`` against the plain version (the fp32
    product of the upcast fp8 operands), its time and the whole call's,
    the plain version's, the bf16 ``torch.matmul``'s, and the bound
    (the fp8 operands read and the fp32 output written once, over 3.35
    TB/s; 2 m k n operations over the dense fp8 rate); then a ragged
    (100, 72, 40) that ``_scaled_mm`` takes padded to 16."""
    import torch
    from apex_tpu_torch.quant import fp8
    m, k, n = QUANT_MM
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(k, n, device="cuda", generator=gen)
         * k ** -0.5).bfloat16()
    sx = 448.0 / fp8.tensor_amax(x)
    sw = 448.0 / fp8.tensor_amax(w)
    qx, qw = fp8.quantize(x, sx), fp8.quantize(w, sw)
    with _counting_scaled_mm() as calls:
        got = fp8.scaled_mm_product(qx, qw, sx, sw)
        whole = fp8.scaled_matmul(x, w, sx, sw)
    require(calls[0] == 2, f"_scaled_mm called {calls[0]} times, want 2")
    require(whole.dtype == torch.bfloat16 and whole.shape == (m, n),
            f"scaled_matmul gave {whole.dtype} {tuple(whole.shape)}")
    want = fp8.scaled_mm_product_ref(qx, qw, sx, sw)
    rel = float((got - want).abs().max() / want.abs().max())
    require(rel <= MM_REL_TOL, f"scaled_matmul relative error {rel} > "
                               f"{MM_REL_TOL}")
    ms = time_ms(lambda: fp8.scaled_mm_product(qx, qw, sx, sw))
    whole_ms = time_ms(lambda: fp8.scaled_matmul(x, w, sx, sw))
    plain_ms = time_ms(lambda: fp8.scaled_mm_product_ref(qx, qw, sx, sw))
    bf16_ms = time_ms(lambda: torch.matmul(x, w))
    bound_ms, by = bound(m * k + k * n + m * n * 4, 2.0 * m * k * n,
                         PEAK_FP8_FLOPS)
    xr = torch.randn(100, 72, device="cuda", generator=gen)
    wr = torch.randn(72, 40, device="cuda", generator=gen)
    s1, s2 = torch.tensor(64.0, device="cuda"), \
        torch.tensor(32.0, device="cuda")
    with _counting_scaled_mm() as calls:
        gr = fp8.scaled_matmul(xr, wr, s1, s2, out_dtype=torch.float32)
    rr = fp8.scaled_mm_product_ref(fp8.quantize(xr, s1),
                                   fp8.quantize(wr, s2), s1, s2)
    rel_r = float((gr - rr).abs().max() / rr.abs().max())
    require(calls[0] == 1 and rel_r <= MM_REL_TOL,
            f"ragged scaled_matmul: {calls[0]} calls, error {rel_r}")
    return dict(shape=[m, k, n], scaled_mm_calls=2, max_rel_err=rel,
                tolerance=MM_REL_TOL, ms=ms, whole_call_ms=whole_ms,
                plain_ms=plain_ms, bf16_matmul_ms=bf16_ms,
                bound_ms=bound_ms, bound_by=by,
                bound_share=bound_ms / ms,
                ragged={"shape": [100, 72, 40], "max_rel_err": rel_r})


#: the eager fp8 functions, timed as ranges in the profiled O4 step
FP8_RANGES = ("fp8_quantize", "fp8_dequantize", "fp8_amax")


@contextlib.contextmanager
def _fp8_ranges():
    """Each call of the fp8 module's quantize, dequantize and amax
    functions inside a ``record_function`` range (the op layer and the
    step reach them through the module's attributes), so a profile sums
    their kernels."""
    from torch.profiler import record_function
    from apex_tpu_torch.quant import fp8
    saved = []
    for name, rng in (("quantize", "fp8_quantize"),
                      ("dequantize", "fp8_dequantize"),
                      ("tensor_amax", "fp8_amax"), ("tree_amax", "fp8_amax")):
        orig = getattr(fp8, name)

        def ranged(*args, _orig=orig, _rng=rng, **kwargs):
            with record_function(_rng):
                return _orig(*args, **kwargs)
        saved.append((name, orig))
        setattr(fp8, name, ranged)
    try:
        yield
    finally:
        for name, orig in saved:
            setattr(fp8, name, orig)


def _o4_profile(step, *batch):
    """One O4 step profiled, its eager fp8 functions as their own group
    (taken out of "other PyTorch kernels")."""
    with _fp8_ranges():
        prof = profile_step(step, *batch, ranges=FP8_RANGES)
    if "by_group_ms" in prof:
        fp8_ms = sum(r["device_ms"] for r in prof["ranges"].values())
        prof["by_group_ms"]["fp8 quantize / dequantize / amax (eager)"] = \
            fp8_ms
        prof["by_group_ms"]["other PyTorch kernels"] -= fp8_ms
    return prof


def _o4_train(cfg, tree):
    """gpt_small at O4 and at O2 (each FusedAdam lr 3e-4 from the seeded
    weights, B 8 x L 2048), ``TRAIN_STEPS`` steps each in turns: losses,
    p50s, tokens/s, peak memory, the O4 step's exact launches (each O4
    step counted alone), the sync-debug warnings of each, the fp8
    metrics; one profiled O4 step; an injected overflow; then 2
    accumulated O4 steps (``accum_steps=2``) with their launches."""
    import warnings

    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    runs = {}
    for level in ("O2", "O4"):
        model = params_from_jax(tree, cfg, trainable=True)
        opt = FusedAdam(model.parameters(), lr=3e-4)
        a = amp.initialize(model, opt, opt_level=level)
        runs[level] = dict(model=model, opt=opt, amp=a, times=[], losses=[],
                           warnings=0, peak=0.0, step_peak=0.0,
                           step=amp.make_train_step(a, model,
                                                    _gpt_loss_poisoned))
    require(runs["O4"]["amp"].fp8_state is not None
            and runs["O2"]["amp"].fp8_state is None,
            "O4 has no fp8 state, or O2 has one")
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    clean = torch.zeros(TRAIN_B, device="cuda")
    counts = dict(NO_LAUNCHES)
    metrics = None
    for i in range(TRAIN_STEPS):
        for level in (("O2", "O4") if i % 2 == 0 else ("O4", "O2")):
            r = runs[level]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_launch_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    out = r["step"](ids, clean)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            r["times"].append(time.perf_counter() - t0)
            got = launch_counts()
            if level == "O4":
                counts = {k: counts[k] + got[k] for k in counts}
                metrics = out
            r["warnings"] += sum("synchroniz" in str(w.message).lower()
                                 for w in caught)
            peak = torch.cuda.max_memory_allocated()
            r["peak"] = max(r["peak"], peak / 1e9)
            r["step_peak"] = max(r["step_peak"], (peak - resident) / 1e9)
            r["losses"].append(float(out["loss"]))
            require(not bool(out["overflow"]), f"{level} overflow at step "
                                               f"{i}")
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = dict(gpt_pass_launches(cfg), packed_scale=1, packed_adam_tree=1)
    require(per_step == want, f"O4 launches per step {per_step}, want "
                              f"{want}")
    for level, r in runs.items():
        require(all(np.isfinite(r["losses"]))
                and r["losses"][-1] < r["losses"][0],
                f"{level} losses {r['losses']}")
    a4 = runs["O4"]["amp"]
    scales = {c: float(getattr(a4.fp8_state, c).scale)
              for c in ("input", "weight", "grad")}
    require(all(s != 1.0 for s in scales.values()),
            f"an fp8 scale did not move off 1: {scales}")
    p50 = {lv: float(np.median(r["times"][2:])) * 1e3
           for lv, r in runs.items()}
    fp8_last = {"fp8_amax_saturation":
                float(metrics["fp8_amax_saturation"]),
                "fp8_rescales": int(metrics["fp8_rescales"])}
    stats = {lv: dict(losses=r["losses"],
                      step_ms=[t * 1e3 for t in r["times"]],
                      peak_memory_gb=r["peak"],
                      step_peak_over_resident_gb=r["step_peak"],
                      sync_debug_warnings=r["warnings"])
             for lv, r in runs.items()}
    del runs["O2"]
    torch.cuda.empty_cache()
    r4 = runs["O4"]
    profile = _o4_profile(r4["step"], ids, clean)

    # an overflow: skipped on the card, the histories roll all the same
    opt, model = r4["opt"], r4["model"]
    masters = {n: t.clone() for n, t in a4.masters.items()}
    st = opt.state[a4.masters["lm_head.kernel"]]
    moments = (st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
               int(st["step"]))
    hist = [c.amax_history.clone() for c in a4.fp8_state]
    scale_before = float(a4.scaler_state.loss_scale)
    poison = clean.clone()
    poison[3] = float("inf")
    out = r4["step"](ids, poison)
    torch.cuda.synchronize()
    require(bool(out["overflow"])
            and float(out["loss_scale"]) == scale_before / 2,
            "the O4 overflow was not seen or the scale did not halve")
    require(all(torch.equal(masters[n], t) for n, t in a4.masters.items())
            and torch.equal(st["exp_avg"], moments[0])
            and torch.equal(st["exp_avg_sq"], moments[1])
            and int(st["step"]) == moments[2],
            "masters or moments changed on a skipped O4 step")
    rolled = all(torch.equal(c.amax_history[1:], h[:-1])
                 for c, h in zip(a4.fp8_state, hist))
    newest = {c: float(getattr(a4.fp8_state, c).amax_history[0])
              for c in ("input", "weight", "grad")}
    require(rolled and newest["grad"] == 0.0 and newest["input"] > 0.0
            and newest["weight"] > 0.0,
            f"the overflow step's fp8 roll: rolled {rolled}, newest "
            f"{newest}")
    del masters, moments

    # accumulation: 2 steps of 2 micro-batches of B 4
    acc_step = amp.make_train_step(a4, model, _gpt_loss_poisoned,
                                   accum_steps=O4_ACCUM)
    acc_step(ids, clean)                     # its buffers, then counted
    torch.cuda.synchronize()
    reset_launch_counts()
    acc_losses = [float(acc_step(ids, clean)["loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    acc_counts = launch_counts()
    acc_want = dict(gpt_pass_launches(cfg, O4_ACCUM, b=TRAIN_B // O4_ACCUM),
                    packed_axpby=O4_ACCUM, packed_nonfinite=1,
                    packed_adam_tree=1)
    require({k: v / 2 for k, v in acc_counts.items()} == acc_want,
            f"O4 accum launches per step {acc_counts} / 2, want "
            f"{acc_want}")
    require(all(np.isfinite(acc_losses)), f"O4 accum losses {acc_losses}")
    require(stats["O4"]["sync_debug_warnings"]
            <= stats["O2"]["sync_debug_warnings"],
            f"the O4 steps synchronize more than O2's: "
            f"{stats['O4']['sync_debug_warnings']} against "
            f"{stats['O2']['sync_debug_warnings']} warnings")
    rec = dict(
        model="gpt_small", optimizer="FusedAdam", lr=3e-4, batch=TRAIN_B,
        seq_len=TRAIN_L, steps=TRAIN_STEPS,
        order="O2 and O4 alternated step by step (both models resident)",
        by_level=stats, step_ms_p50_steps_3_to_10=p50,
        o4_over_o2=p50["O4"] / p50["O2"],
        tokens_per_s={lv: TRAIN_B * TRAIN_L / (p / 1e3)
                      for lv, p in p50.items()},
        launches=counts, launches_per_step=per_step,
        fp8_scales=scales, last_step=fp8_last, profile=profile,
        injected_overflow={"skipped": True,
                           "loss_scale": [scale_before,
                                          float(out["loss_scale"])],
                           "histories_rolled": rolled,
                           "newest_amax": newest},
        accum={"accum_steps": O4_ACCUM, "losses": acc_losses,
               "launches_per_step": acc_want})
    return rec, counts, acc_counts


def _o4_reference():
    """A 2-layer narrow GPT at O4, ``O4_REF_STEPS`` steps on the card and
    on the CPU from the same weights: losses within ``O4_REF_LOSS_TOL``,
    each class's scale after each step within ``O4_SCALE_RTOL``."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    tree = gpt_small_tree(cfg, seed=9)
    ids = train_stream(cfg.vocab_size, 4, 128)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = params_from_jax(tree, cfg, device=dev, trainable=True)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev),
                           opt_level="O4", device=dev)
        step = amp.make_train_step(a, model, _gpt_loss)
        x = torch.as_tensor(ids, device=dev)
        losses, scales = [], []
        for _ in range(O4_REF_STEPS):
            losses.append(float(step(x)["loss"]))
            scales.append({c: float(getattr(a.fp8_state, c).scale)
                           for c in O4_SCALE_RTOL})
        runs[dev] = (losses, scales)
    (lg, sg), (lc, sc) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(x - y) for x, y in zip(lg, lc))
    scale_err = {c: max(abs(g[c] - w[c]) / abs(w[c]) for g, w in zip(sg, sc))
                 for c in O4_SCALE_RTOL}
    require(all(np.isfinite(lg)) and lg[-1] < lg[0],
            f"O4 reference losses on the card: {lg}")
    require(loss_err <= O4_REF_LOSS_TOL,
            f"O4 losses card vs CPU differ by {loss_err}")
    require(all(scale_err[c] <= O4_SCALE_RTOL[c] for c in O4_SCALE_RTOL),
            f"O4 scales card vs CPU differ by {scale_err} (bounds "
            f"{O4_SCALE_RTOL})")
    return dict(steps=O4_REF_STEPS, losses_card=lg, losses_cpu=lc,
                loss_max_abs_err=loss_err, loss_tolerance=O4_REF_LOSS_TOL,
                scales_card=sg, scales_cpu=sc, scale_max_rel_err=scale_err,
                scale_rel_tolerance=O4_SCALE_RTOL)


def _pool_bytes(eng) -> int:
    return sum(t.numel() * t.element_size()
               for t in (eng.kc, eng.vc, eng.ks, eng.vs) if t is not None)


def _serve_run(model, cfg, requests, kv_dtype):
    """One drained run of ``requests`` through a fresh engine (the serve
    phase's shapes): outputs, the launches, tokens/s, decode p50 / p99,
    the pools' bytes and the int8 error gauge."""
    import torch
    from apex_tpu_torch.obs import Registry
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    scfg = ServeConfig(num_slots=8, block_size=16, max_blocks_per_slot=64,
                       num_blocks=8 * 64 + 1, prefill_chunk=64,
                       kv_dtype=kv_dtype)
    reg = Registry()
    eng = ServeEngine(model, cfg, scfg, registry=reg)
    for uid, prompt, n in requests:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    chunks = int(reg.counter("serve_prefill_chunks_total").value)
    require(len(out) == len(requests), f"{kv_dtype}: not every request "
                                       f"finished")
    require(counts == dict(NO_LAUNCHES, layer_norm_fwd=(
        2 * cfg.num_layers + 1) * (eng.steps + chunks)),
        f"{kv_dtype} serve launched {counts}")
    h = reg.histogram("serve_decode_step_seconds")
    generated = int(reg.counter("serve_tokens_total").value)
    err = reg.gauge("serve_kv_quant_error").value \
        if kv_dtype == "int8" else None
    return out, counts, dict(
        tokens_per_s=generated / wall, wall_s=wall,
        generated_tokens=generated, decode_steps=eng.steps,
        prefill_chunks=chunks, decode_step_p50_ms=h.quantile(0.5) * 1e3,
        decode_step_p99_ms=h.quantile(0.99) * 1e3,
        pool_bytes=_pool_bytes(eng), serve_kv_quant_error=err)


def _int8_serve(cfg, tree, requests):
    """The serve phase's 16 requests through the dense and the int8
    engine in turns (dense, int8, int8, dense); the int8 runs equal each
    other; then 4 of them through solo int8 ``generate()`` (K2 once a
    layer, the full prefill), equal to the int8 engine under the solo
    phase's near-tie rule."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    model = params_from_jax(tree, cfg, dtype=torch.bfloat16)
    recs = {"dense": [], "int8": []}
    outs = {}
    counts = dict(NO_LAUNCHES)
    for kind in ("dense", "int8", "int8", "dense"):
        out, got, rec = _serve_run(model, cfg, requests,
                                   None if kind == "dense" else "int8")
        if kind in outs:
            require(all(np.array_equal(outs[kind][u], out[u]) for u in out),
                    f"two {kind} engine runs differ")
        outs[kind] = out
        if kind == "int8":
            counts = {k: counts[k] + got[k] for k in counts}
        recs[kind].append(rec)
    dense_b, int8_b = recs["dense"][0]["pool_bytes"], \
        recs["int8"][0]["pool_bytes"]
    per_token = (cfg.num_heads * cfg.head_dim + 4) / (
        2 * cfg.num_heads * cfg.head_dim)
    require(int8_b / dense_b == per_token,
            f"int8 pools {int8_b} B against bf16 {dense_b} B, want "
            f"{per_token}")
    err = recs["int8"][0]["serve_kv_quant_error"]
    require(0.0 < err < 0.1, f"serve_kv_quant_error {err}")
    agree = np.mean([np.mean(outs["dense"][u] == outs["int8"][u])
                     for u in outs["int8"]])
    solo_total = dict(NO_LAUNCHES)
    rows = []
    for uid, prompt, n in requests[:4]:
        reset_launch_counts()
        seq = generate(model, cfg, prompt[None], n,
                       kv_dtype="int8")[0].cpu().numpy()
        torch.cuda.synchronize()
        got = launch_counts()
        require(got["flash_attn_fwd"] == cfg.num_layers,
                f"{uid}: int8 solo flash_attn_fwd {got['flash_attn_fwd']}")
        solo_total = {k: solo_total[k] + got[k] for k in solo_total}
        t = first_divergence(seq[len(prompt):], outs["int8"][uid])
        margin = None
        if t is not None:
            margin = float(margins_of(model, seq, len(prompt))[t])
            require(margin <= NEAR_TIE_BF16,
                    f"{uid}: int8 engine and solo differ at step {t} with "
                    f"top-2 margin {margin} > {NEAR_TIE_BF16}")
        rows.append(dict(uid=uid, new=n,
                         equal_prefix=n if t is None else t,
                         near_tie_margin=margin))
    p50 = {k: float(np.mean([r["decode_step_p50_ms"] for r in v]))
           for k, v in recs.items()}
    tps = {k: float(np.mean([r["tokens_per_s"] for r in v]))
           for k, v in recs.items()}
    del model
    torch.cuda.empty_cache()
    rec = dict(order="dense, int8, int8, dense", runs=recs,
               tokens_per_s_mean=tps,
               int8_over_dense_tokens_per_s=tps["int8"] / tps["dense"],
               decode_step_p50_ms_mean=p50,
               pool_bytes={"bf16": dense_b, "int8": int8_b},
               pool_ratio=int8_b / dense_b, pool_ratio_want=per_token,
               serve_kv_quant_error=err,
               int8_dense_token_agreement=float(agree),
               launches_per_int8_run=counts["layer_norm_fwd"] / 2,
               solo=dict(calls=4, requests=rows, launches=solo_total,
                         near_tie_rule=f"divergence only at top-2 margin "
                                       f"<= {NEAR_TIE_BF16} (bf16 logits)"))
    return rec, counts, solo_total


def _int8_toy():
    """The port's ``train_toy_lm`` trained on the card (gpt_tiny, O2, 50
    steps): int8 against dense greedy tokens >= ``INT8_MATCH_MIN``, two
    int8 runs bitwise equal, the int8 engine's streams equal to solo int8
    ``generate()``."""
    import torch
    from apex_tpu_torch.models import train_toy_lm
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.obs import Registry
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    t0 = time.perf_counter()
    cfg, model, ids = train_toy_lm()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    prompt = ids[:2, :8]
    dense = generate(model, cfg, prompt, 12).cpu().numpy()
    q = generate(model, cfg, prompt, 12, kv_dtype="int8").cpu().numpy()
    q2 = generate(model, cfg, prompt, 12, kv_dtype="int8").cpu().numpy()
    match = float(np.mean(dense[:, 8:] == q[:, 8:]))
    require(match >= INT8_MATCH_MIN, f"toy LM int8 against dense {match}")
    require(np.array_equal(q, q2), "two int8 generate runs differ")
    eng = ServeEngine(model, cfg, ServeConfig(
        num_slots=2, block_size=4, num_blocks=11, max_blocks_per_slot=5,
        prefill_chunk=4, kv_dtype="int8"), registry=Registry())
    asks = {"a": prompt[0], "b": prompt[1][:5]}
    for uid, p in asks.items():
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    outs = eng.run()
    for uid, p in asks.items():
        solo = generate(model, cfg, p[None], 6,
                        kv_dtype="int8")[0].cpu().numpy()[len(p):]
        require(np.array_equal(outs[uid], solo),
                f"toy LM int8 engine {outs[uid]} against solo {solo}")
    return dict(train_s=train_s, int8_dense_match=match,
                match_min=INT8_MATCH_MIN, int8_runs_bitwise=True,
                engine_equals_solo=True,
                serve_kv_quant_error=eng.metrics.gauge(
                    "serve_kv_quant_error").value)


def phase_quant(cfg, tree, requests):
    """fp8 / int8 (``quant``): the functions on the card against the CPU
    bit for bit and ``scaled_matmul`` (``torch._scaled_mm``) against its
    plain version; gpt_small at O4 in turns with O2; a 2-layer O4 model
    card against CPU; int8-KV serving at full width in turns with dense,
    and solo int8; the int8 cache on the trained toy LM."""
    import torch
    t0 = time.perf_counter()
    functions = _quant_functions()
    mm = _scaled_matmul_case()
    # the host-bound serving runs before the O4 step's profiler session
    serve, int8_counts, solo_counts = _int8_serve(cfg, tree, requests)
    toy = _int8_toy()
    train, o4_counts, acc_counts = _o4_train(cfg, tree)
    torch.cuda.empty_cache()
    reference = _o4_reference()
    emit("quant", functions=functions, scaled_matmul=mm, o4_train=train,
         o4_reference=reference, int8_serve=serve, int8_toy_lm=toy,
         seconds=time.perf_counter() - t0)
    return dict(o4_train=o4_counts, o4_accum=acc_counts,
                int8_serve=int8_counts, int8_solo=solo_counts)


# -- speculative decoding and the disaggregated fleet (serve_fleet) ------

#: the draft of the spec runs: gpt_small's first 2 of 12 blocks, k 4
FLEET_DRAFT_LAYERS = 2
FLEET_SPEC_K = 4
#: the toy LM's serving shapes and requests: 8 prompts of 8 tokens from
#: its training stream, 48 new tokens each
TOY_SCFG = dict(num_slots=4, block_size=16, num_blocks=17,
                max_blocks_per_slot=4, prefill_chunk=16)
TOY_NEW = 48
#: fleet steps before the kill: the replicas hold decoding requests
FLEET_KILL_AFTER = 6
#: the fleet's prefill slice and two decode slices: one card, shared
FLEET_DEVICES = ("cuda:0",) * 3


def _serve_cfg(**kw):
    from apex_tpu_torch.serve import ServeConfig
    return ServeConfig(**dict(dict(num_slots=8, block_size=16,
                                   max_blocks_per_slot=64,
                                   num_blocks=8 * 64 + 1,
                                   prefill_chunk=64), **kw))


def _host_clock(obj, name: str, acc: list) -> None:
    """Wrap the bound method ``obj.name`` to add its host seconds and
    calls to ``acc`` (``[seconds, calls]``)."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t0
            acc[1] += 1
    setattr(obj, name, timed)


def _drain(make, requests):
    """A fresh engine from ``make(registry)``, the requests submitted,
    drained with the launch counters reset around the run: outputs,
    launches, wall seconds, the registry, the engine, and the host
    seconds of its admissions (``_run_prefill``: chunks and the first
    token, which ends in a read-back)."""
    import torch
    from apex_tpu_torch.obs import Registry
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.serve import Request
    reg = Registry()
    eng = make(reg)
    admit = [0.0, 0]
    _host_clock(eng, "_run_prefill", admit)
    for uid, prompt, n in requests:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(len(out) == len(requests), "not every request finished")
    eng.admission_s = admit[0]
    return out, launch_counts(), wall, reg, eng


def _wall_split(reg, eng, wall) -> dict:
    """A drained run's wall seconds split into its steps' (the exact sum
    of ``serve_decode_step_seconds``), its admissions' and the rest, with
    the exact mean step (the p50 / p99 interpolate inside buckets a
    factor 2 wide)."""
    h = reg.histogram("serve_decode_step_seconds")
    return dict(step_mean_ms=h.sum / max(h.count, 1) * 1e3,
                steps_s=h.sum, admissions_s=eng.admission_s,
                other_s=wall - h.sum - eng.admission_s)


def _near_tie_check(what, model, requests, got, want, rule):
    """``got`` against ``want`` request by request: equal, or first
    different at a top-2 margin of ``want``'s own logits at most ``rule``
    (``None``: exactly equal).  Returns the rows."""
    rows = []
    for uid, prompt, n in requests:
        g, w = got[uid], want[uid]
        require(g.shape == (n,) and g.min() >= 0, f"{what} {uid}: {g.shape}")
        t = first_divergence(g, w)
        margin = None
        if t is not None:
            require(rule is not None,
                    f"{what} {uid}: differs at step {t}: {g} against {w}")
            margin = float(margins_of(model, np.concatenate([prompt, w]),
                                      len(prompt))[t])
            require(margin <= rule,
                    f"{what} {uid}: differs at step {t} with top-2 margin "
                    f"{margin} > {rule}")
        rows.append(dict(uid=uid, new=n, equal_prefix=n if t is None else t,
                         near_tie_margin=margin))
    return rows


def _spec_record(reg, eng, counts, wall, cfg, dcfg):
    """tokens/s, p50 / p99 a round, the spec counters and K1's launches
    against ``(k + 1)(2 L_d + 1) + 2 L + 1`` a round plus the draft's and
    the target's prefill chunks."""
    k = FLEET_SPEC_K
    rounds = int(reg.counter("serve_spec_rounds_total").value)
    chunks = int(reg.counter("serve_prefill_chunks_total").value)
    dchunks = reg.histogram("span_seconds__serve_spec_draft_prefill").count
    per_round = (k + 1) * (2 * dcfg.num_layers + 1) + 2 * cfg.num_layers + 1
    want = rounds * per_round + dchunks * (2 * dcfg.num_layers + 1) \
        + chunks * (2 * cfg.num_layers + 1)
    require(counts == dict(NO_LAUNCHES, layer_norm_fwd=want),
            f"spec engine launched {counts}, want K1 {want}")
    h = reg.histogram("serve_decode_step_seconds")
    generated = int(reg.counter("serve_tokens_total").value)
    proposed = reg.counter("serve_spec_proposed_total").value
    accepted = reg.counter("serve_spec_accepted_total").value
    return dict(
        tokens_per_s=generated / wall, wall_s=wall,
        generated_tokens=generated, rounds=rounds,
        prefill_chunks=chunks, draft_prefill_chunks=dchunks,
        round_p50_ms=h.quantile(0.5) * 1e3,
        round_p99_ms=h.quantile(0.99) * 1e3,
        proposed=proposed, accepted=accepted,
        acceptance_rate=reg.gauge("serve_spec_acceptance_rate").value,
        draft_steps=reg.counter("serve_spec_draft_steps_total").value,
        tokens_per_slot_round=(generated - len(eng._outputs)) / max(
            proposed / k, 1),
        k1_launches=counts["layer_norm_fwd"], k1_per_round=per_round,
        verify_ms_mean=_mean_ms(reg, "span_seconds__serve_spec_verify"),
        draft_ms_mean=_mean_ms(reg, "span_seconds__serve_spec_draft"),
        draft_prefill_ms_mean=_mean_ms(
            reg, "span_seconds__serve_spec_draft_prefill"),
        **_wall_split(reg, eng, wall))


def _mean_ms(reg, name: str) -> float:
    h = reg.histogram(name)
    return h.sum / max(h.count, 1) * 1e3


def _dense_record(reg, eng, counts, wall, cfg):
    chunks = int(reg.counter("serve_prefill_chunks_total").value)
    require(counts == dict(NO_LAUNCHES, layer_norm_fwd=(
        2 * cfg.num_layers + 1) * (eng.steps + chunks)),
        f"dense engine launched {counts}")
    h = reg.histogram("serve_decode_step_seconds")
    generated = int(reg.counter("serve_tokens_total").value)
    return dict(tokens_per_s=generated / wall, wall_s=wall,
                generated_tokens=generated, decode_steps=eng.steps,
                prefill_chunks=chunks, step_p50_ms=h.quantile(0.5) * 1e3,
                step_p99_ms=h.quantile(0.99) * 1e3,
                **_wall_split(reg, eng, wall))


def _spec_vs_dense(model, cfg, requests, scfg, tie_rule):
    """The spec engine (a truncated draft, k 4) and the dense engine in
    turns (spec, dense, dense, spec): each pair of runs of one engine
    equal, spec against dense under ``tie_rule``."""
    from apex_tpu_torch.serve import (ServeEngine, SpecConfig, SpecEngine,
                                      truncated_draft)
    draft, dcfg = truncated_draft(model, cfg, FLEET_DRAFT_LAYERS
                                  if cfg.num_layers > FLEET_DRAFT_LAYERS
                                  else 1)
    recs = {"spec": [], "dense": []}
    outs = {}
    counts = {"spec": dict(NO_LAUNCHES), "dense": dict(NO_LAUNCHES)}
    for kind in ("spec", "dense", "dense", "spec"):
        if kind == "spec":
            def make(reg):
                return SpecEngine(model, cfg, scfg, draft, dcfg,
                                  SpecConfig(k=FLEET_SPEC_K), registry=reg)
        else:
            def make(reg):
                return ServeEngine(model, cfg, scfg, registry=reg)
        out, got, wall, reg, eng = _drain(make, requests)
        rec = (_spec_record(reg, eng, got, wall, cfg, dcfg) if kind == "spec"
               else _dense_record(reg, eng, got, wall, cfg))
        if kind in outs:
            require(all(np.array_equal(outs[kind][u], out[u]) for u in out),
                    f"two {kind} runs differ")
        outs[kind] = out
        recs[kind].append(rec)
        counts[kind] = {c: counts[kind][c] + got[c] for c in got}
    rows = _near_tie_check("spec against dense", model, requests,
                           outs["spec"], outs["dense"], tie_rule)
    tps = {k: float(np.mean([r["tokens_per_s"] for r in v]))
           for k, v in recs.items()}
    return outs, counts, dict(
        order="spec, dense, dense, spec", draft_layers=dcfg.num_layers,
        k=FLEET_SPEC_K, runs=recs, tokens_per_s_mean=tps,
        spec_over_dense_tokens_per_s=tps["spec"] / tps["dense"],
        spec_against_dense=rows,
        equal_requests=sum(r["equal_prefix"] == r["new"] for r in rows))


def _timed_fleet(router):
    """CUDA events around each shipment's gather, wire and install in a
    run of ``router``; returns the lists of (start, end) pairs."""
    import torch
    from apex_tpu_torch.serve import transfer
    spans_ = {"gather": [], "wire": [], "install": []}

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans_[name].append((a, b))
            return out
        return wrapped

    router.prefill._gather = timed("gather", router.prefill._gather)
    for rep in router.replicas:
        rep._install = timed("install", rep._install)
    return spans_, timed("wire", transfer.ship)


def _fleet_run(model, cfg, requests, scfg, mode, kill=False):
    """The requests through ``DisaggRouter`` on ``FLEET_DEVICES``;
    ``kill``: the busiest replica killed after ``FLEET_KILL_AFTER``
    steps.  Outputs, launches, and the run's record."""
    import torch
    from apex_tpu_torch.obs import Registry
    from apex_tpu_torch.obs.fleet import merged_quantile
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.serve import (DisaggRouter, Request, RouterConfig,
                                      transfer)
    reg = Registry()
    router = DisaggRouter(model, cfg, scfg, RouterConfig(transfer=mode),
                          devices=FLEET_DEVICES, registry=reg)
    require(router.replicas[0].eng.model is model,
            "replicas on one card must share the model")
    spans_, wire = _timed_fleet(router)
    route, steps_acc = [0.0, 0], [0.0, 0]
    _host_clock(router, "_route_one", route)
    for rep in router.replicas:
        _host_clock(rep, "step", steps_acc)
    for uid, prompt, n in requests:
        router.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    torch.cuda.synchronize()
    reset_launch_counts()
    orig_ship, transfer.ship = transfer.ship, wire
    rerouted = []
    try:
        t0 = time.perf_counter()
        if kill:
            for _ in range(FLEET_KILL_AFTER):
                router.step()
            victim = max(router.replicas,
                         key=lambda r: r.eng.sched.n_active()).index
            rerouted = router.kill_replica(victim)
            require(rerouted, "the kill hit no request")
        out = router.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        transfer.ship = orig_ship
    counts = launch_counts()
    require(len(out) == len(requests), f"{mode}: not every request finished")
    engines = [router.prefill.eng] + [r.eng for r in router.replicas]
    steps = sum(e.steps for e in engines)
    chunks = sum(int(e.metrics.counter("serve_prefill_chunks_total").value)
                 for e in engines)
    require(counts == dict(NO_LAUNCHES, layer_norm_fwd=(
        2 * cfg.num_layers + 1) * (steps + chunks)),
        f"fleet ({mode}) launched {counts}")
    generated = sum(int(e.metrics.counter("serve_tokens_total").value)
                    for e in engines)
    shipments = int(reg.counter("serve_kv_shipments_total").value)
    nbytes = int(reg.counter("serve_kv_transfer_bytes").value)
    pool = router.replicas[0].eng.kc
    kv_bytes = 2 * cfg.num_layers * scfg.max_blocks_per_slot \
        * scfg.block_size * cfg.hidden_size * pool.element_size()
    key_bytes = len(torch.Generator().get_state())
    direct = reg.counter("serve_prefix_direct_admissions_total").value
    if mode == "ship":
        # every admission ships once, but a prefix hit sent straight to
        # a replica; a rerouted request is admitted again
        require(shipments + direct == len(requests) + len(rerouted),
                f"{shipments} shipments and {direct} prefix-direct "
                f"admissions for {len(requests)} requests and "
                f"{len(rerouted)} reroutes")
        require(nbytes == shipments * (kv_bytes + key_bytes),
                f"{nbytes} bytes shipped, want {shipments} x "
                f"({kv_bytes} + {key_bytes})")
    else:
        require(shipments == 0 and nbytes == 0, "recompute shipped")
    ev_ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans_.items()}
    rec = dict(
        mode=mode, tokens_per_s=generated / wall, wall_s=wall,
        generated_tokens=generated, decode_steps=steps,
        prefill_chunks=chunks, shipments=shipments,
        transfer_bytes=nbytes, kv_bytes_per_shipment=kv_bytes,
        generator_state_bytes=key_bytes,
        shipment_event_ms_mean={k: float(np.mean(v)) if v else None
                                for k, v in ev_ms.items()},
        prefix_direct_admissions=int(direct),
        replica_decode_p99_ms=[r.p99() * 1e3 for r in router.replicas],
        # the fleet's p99: one quantile over the union of the replicas'
        # buckets, each over the window its own p99 reads
        fleet_decode_p99_ms=merged_quantile(
            [(r._hist, r._p99_window) for r in router.replicas],
            0.99) * 1e3,
        replica_decode_p50_ms=[
            r._hist.quantile(0.5) * 1e3 for r in router.replicas],
        replica_decode_mean_ms=[
            r._hist.sum / max(r._hist.count, 1) * 1e3
            for r in router.replicas],
        decode_steps_s=sum(r._hist.sum for r in router.replicas),
        replica_step_calls_s=steps_acc[0], routing_s=route[0],
        other_s=wall - steps_acc[0] - route[0],
        slices=router.slices.describe(),
        slices_share_one_card=len(set(FLEET_DEVICES)) == 1)
    if kill:
        rec.update(killed=victim, rerouted=len(rerouted),
                   reroutes=int(reg.counter("serve_reroute_total").value))
    return out, counts, rec, router


def _shipment_times(router, scfg):
    """One full shipment's gather, wire and install timed alone (CUDA
    events over repeated calls), beside the bytes each moves and its
    bound (read + write over the memory rate)."""
    import torch
    from apex_tpu_torch.serve import KVShipment, Request, transfer
    rep = router.replicas[0]
    pre = router.prefill
    dev = rep.placement
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, device=dev)
    pre_row = torch.arange(1, pre.scfg.num_blocks, device=dev)
    kv = pre._gather(pre.eng.pools, pre_row)
    key = pre.eng.generators[0].get_state()
    shp = KVShipment(request=Request(uid="t", prompt=np.ones(4, np.int64),
                                     max_new_tokens=1),
                     kv=kv, first_token=0, prompt_len=4, key=key)
    moved = transfer.shipment_bytes(kv, key) - key.numel()
    gens = list(rep.eng.generators)
    out = {}
    for name, fn in (
            ("gather", lambda: pre._gather(pre.eng.pools, pre_row)),
            ("wire", lambda: transfer.ship(shp, dev)),
            ("install", lambda: rep._install(rep.eng.pools, gens, row, kv, 0,
                                             key))):
        ms = time_ms(fn)
        b, by = bound(2 * moved, 0, PEAK_BF16_FLOPS)
        out[name] = dict(ms=ms, bytes_read_and_written=2 * moved,
                         bound_ms=b, bound_by=by)
    return out


def _toy_fleet(cfg, model, requests, dense_out):
    """The toy LM's requests through the fleet, ship and recompute, and
    through a kill: exactly the dense engine's streams."""
    from apex_tpu_torch.serve import ServeConfig
    scfg = ServeConfig(**TOY_SCFG)
    rows = {}
    for mode, kill in (("ship", False), ("recompute", False),
                       ("ship", True)):
        out, _, rec, _ = _fleet_run(model, cfg, requests, scfg, mode, kill)
        _near_tie_check(f"toy fleet {mode}", model, requests, out,
                        dense_out, None)
        rows[mode + ("_kill" if kill else "")] = dict(
            tokens_per_s=rec["tokens_per_s"], equal=True,
            rerouted=rec.get("rerouted"))
    return rows


def phase_serve_fleet(cfg, tree, requests):
    """Speculative decoding and the disaggregated fleet at gpt_small's
    full width (bf16 from the seeded tree, the serve phase's 16 requests
    and shapes), then on the trained toy LM; every gate fails the run."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import train_toy_lm
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.serve import ServeConfig
    t_phase = time.perf_counter()
    model = params_from_jax(tree, cfg, dtype=torch.bfloat16)
    scfg = _serve_cfg()
    outs, spec_counts, spec = _spec_vs_dense(model, cfg, requests, scfg,
                                             NEAR_TIE_BF16)
    dense_out = outs["dense"]
    fleet, fleet_counts = {}, dict(NO_LAUNCHES)
    for mode, kill in (("ship", False), ("recompute", False),
                       ("ship", True)):
        out, got, rec, router = _fleet_run(model, cfg, requests, scfg, mode,
                                           kill)
        rec["against_monolithic"] = _near_tie_check(
            f"fleet {mode}{' kill' if kill else ''}", model, requests, out,
            dense_out, NEAR_TIE_BF16)
        rec["equal_requests"] = sum(
            r["equal_prefix"] == r["new"] for r in rec["against_monolithic"])
        fleet[mode + ("_kill" if kill else "")] = rec
        fleet_counts = {k: fleet_counts[k] + got[k] for k in got}
        if mode == "ship" and not kill:
            fleet["shipment_alone"] = _shipment_times(router, scfg)
        del router
    del model
    torch.cuda.empty_cache()
    # the trained toy LM: spec, dense, the fleet and solo exactly equal
    tcfg, toy, ids = train_toy_lm()
    toy_reqs = [(f"t{i}", ids[0, i:i + 8], TOY_NEW) for i in range(8)]
    tscfg = ServeConfig(**TOY_SCFG)
    toy_outs, _, toy_spec = _spec_vs_dense(toy, tcfg, toy_reqs, tscfg, None)
    reset_launch_counts()
    solo = {uid: generate(toy, tcfg, p[None], n)[0].cpu().numpy()[len(p):]
            for uid, p, n in toy_reqs}
    solo_counts = launch_counts()
    require(solo_counts["flash_attn_fwd"] == tcfg.num_layers * len(toy_reqs),
            f"toy solo flash_attn_fwd {solo_counts['flash_attn_fwd']}")
    _near_tie_check("toy spec against solo", toy, toy_reqs, toy_outs["spec"],
                    solo, None)
    toy_fleet = _toy_fleet(tcfg, toy, toy_reqs, toy_outs["dense"])
    emit("serve_fleet", model="gpt_small", dtype="bfloat16",
         requests=len(requests), spec=spec, fleet=fleet,
         toy_lm=dict(spec=toy_spec, solo_equal=True,
                     solo_launches=solo_counts, fleet=toy_fleet),
         near_tie_rule=f"divergence only at top-2 margin <= "
                       f"{NEAR_TIE_BF16} (bf16 logits); the toy LM exact",
         seconds=time.perf_counter() - t_phase)
    return dict(spec_serve=spec_counts["spec"], fleet_serve=fleet_counts,
                toy_solo=solo_counts)


# -- the elastic training fleet, the lagged registry, the trace parser and
# -- the native host runtime ---------------------------------------------

#: the drill: JAX's schedule (24 steps, a snapshot every 4, rank 1 killed
#: at step 10) at gpt_small's MLP widths, a rank's batch one gpt_small
#: step's tokens (B 4 x L 2048); two ranks share the one card, so gloo
FLEET_DRILL = dict(num_steps=24, checkpoint_every=4, world_size=2, seed=0,
                   lease_ttl_s=2.0, heartbeat_s=0.25, poll_s=0.1,
                   init_timeout_s=120.0, stall_budget_s=180.0,
                   step_delay_s=0.25, d_in=768, hidden=3072, batch=8192,
                   faults=("rank_kill@10:1",), device="cuda",
                   backend="gloo")
FLEET_DRILL_TIMEOUT_S = 300.0
#: wrapped / bare gpt_small O2 steps a turn, and the turns
LAG_STEPS, LAG_TURNS = 10, 2
#: calls timed of each bucket plan (native and plain) in ``native``
NATIVE_REPS = 200


def phase_train_fleet(repo: Path):
    """The elastic fleet's drill on ``cuda:0`` (``FLEET_DRILL``): two
    supervisors, rank 1 killed (child and supervisor) at step 10, the
    survivor's shrink to one rank, the killed rank started again once
    the shrunken generation has committed a snapshot, the regrow to two;
    then the post-kill and post-regrow schedules replayed from the
    drill's own snapshots in fresh ledgers.  Fails unless the shrink,
    regrow and cross-rank verdicts are all bitwise true.  Launches: the
    generation children's (K6, K11 a step; K15 a checkpoint)."""
    import shutil
    import tempfile
    from apex_tpu_torch.resilience.fleet import FleetConfig
    from apex_tpu_torch.testing import run_fleet_drill
    t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="apex_tpu_torch_fleet_",
                            dir=str(repo / "build"))
    cfg = FleetConfig(**FLEET_DRILL)
    try:
        out = run_fleet_drill(base, cfg, timeout_s=FLEET_DRILL_TIMEOUT_S)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    counts = dict(NO_LAUNCHES, **out["launches"])
    gens = out["generations"]
    require(all(out["bitwise"].values()),
            f"fleet drill verdicts {out['bitwise']}")
    require([g["members"] for g in gens[:3]] == [[0, 1], [0], [0, 1]],
            f"generations {gens}")
    require(out["steps_lost"] <= cfg.checkpoint_every,
            f"{out['steps_lost']} steps lost")
    require(counts["packed_scale"] > 0 and counts["packed_adam_tree"] > 0
            and counts["packed_nonfinite"] > 0,
            f"the fleet's children launched {out['launches']}")
    emit("train_fleet", device="cuda:0", backend=cfg.backend,
         ranks_share_one_card=True, workload=dict(
             d_in=cfg.d_in, hidden=cfg.hidden, batch_per_rank=cfg.batch,
             opt_level="O2", optimizer="FusedAdam", dtype="bfloat16"),
         schedule=dict(num_steps=cfg.num_steps,
                       checkpoint_every=cfg.checkpoint_every,
                       faults=list(cfg.faults), lease_ttl_s=cfg.lease_ttl_s,
                       poll_s=cfg.poll_s, step_delay_s=cfg.step_delay_s),
         generations=gens, kill_step=out["kill_step"],
         shrink_restore=out["shrink_restore"],
         regrow_restore=out["regrow_restore"],
         steps_lost=out["steps_lost"],
         detection_latency_s=out["detection_latency_s"],
         detection_bound_s=cfg.lease_ttl_s + cfg.poll_s,
         train_fleet_recovery_seconds=out["recovery_seconds"],
         bitwise=out["bitwise"], finals=out["finals"],
         replays={k: {"world": v["world"],
                      "restore_step": v["restore_step"],
                      "final_step": v["final_step"]}
                  for k, v in out["replays"].items()},
         launches=out["launches"], drill_wall_s=out["wall_s"],
         seconds=time.perf_counter() - t0)
    return counts


def _lag_run(step, ids, reg=None, scrape=None):
    """``LAG_STEPS`` steps queued back to back (wrapped by
    ``instrument_step`` on ``reg`` when given), each step's start
    stamped; one synchronize at the end.  Returns the stamps' p50
    interval (ms), the wall a step, each step's loss tensor and the
    pending groups after each tick."""
    import torch
    from apex_tpu_torch.obs.metrics import instrument_step
    fn = instrument_step(step, registry=reg) if reg is not None else step
    stamps, losses, pending = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAG_STEPS):
        stamps.append(time.perf_counter())
        losses.append(fn(ids)["loss"])
        if reg is not None:
            pending.append(reg.pending_groups)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p50, _ = _p50_intervals(stamps)
    return p50, wall / LAG_STEPS * 1e3, losses, pending


def _scraper(url):
    """A thread GETting ``url`` every 100 ms until stopped: the scrapes'
    count and the last body."""
    import threading
    import urllib.request
    got = {"n": 0, "body": None}
    stop = threading.Event()

    def run():
        while not stop.wait(0.1):
            with urllib.request.urlopen(url, timeout=10) as r:
                got["body"] = r.read().decode()
            got["n"] += 1

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def finish():
        stop.set()
        t.join(timeout=10)
        return got
    return finish


def phase_obs_lag(cfg, tree):
    """``instrument_step`` around the gpt_small O2 step (FusedAdam, B 8 x
    L 2048, seeded weights), ``LAG_STEPS`` steps in turns with the bare
    step: p50 of each, the registry's pending groups after each tick,
    the loss gauge against the steps' own losses (lag 1, resolved 8 at a
    time), a ``MetricsServer``'s ``/metrics`` and ``/fleet`` scraped over
    HTTP while the wrapped steps run; then one O4 step, wrapped: both fp8
    gauges present and finite.  Launches: the wrapped O2 steps' (each
    step's are the train phase's)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.obs import MetricsServer, Registry, instrument_step
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    t0 = time.perf_counter()
    model = params_from_jax(tree, cfg, trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-4),
                       opt_level="O2")
    step = amp.make_train_step(a, model, _gpt_loss)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    for _ in range(2):
        step(ids)
    bare, wrapped, counts, regs = [], [], None, []
    for turn in range(LAG_TURNS):
        p50, wall, _, _ = _lag_run(step, ids)
        bare.append(dict(step_ms_p50=p50, wall_ms_a_step=wall))
        reg = Registry()
        regs.append(reg)
        srv = MetricsServer(registry=reg,
                            fleet_registries={"wrapped": reg,
                                              "bare": Registry()})
        host, port = srv.start()
        stop_metrics = _scraper(f"http://{host}:{port}/metrics")
        stop_fleet = _scraper(f"http://{host}:{port}/fleet")
        reset_launch_counts()
        p50, wall, losses, pending = _lag_run(step, ids, reg)
        if counts is None:
            counts = launch_counts()
        scraped, fleet_scraped = stop_metrics(), stop_fleet()
        srv.stop()
        # lag 1, resolve_every 8: after 10 ticks groups 0..7 are resolved
        gauge_before_flush = reg.gauge("train_loss").value
        reg.flush()
        own = [float(v) for v in losses]
        wrapped.append(dict(
            step_ms_p50=p50, wall_ms_a_step=wall,
            pending_groups_after_each_tick=pending,
            loss_gauge_before_flush=gauge_before_flush,
            own_loss_of_step_8=own[7],
            loss_gauge_after_flush=reg.gauge("train_loss").value,
            own_last_loss=own[-1], scrapes=scraped["n"],
            fleet_scrapes=fleet_scraped["n"]))
        require(pending == [1, 2, 3, 4, 5, 6, 7, 8, 1, 2],
                f"pending groups {pending}")
        require(gauge_before_flush == own[7]
                and reg.gauge("train_loss").value == own[-1],
                f"loss gauge {gauge_before_flush} / "
                f"{reg.gauge('train_loss').value} against {own}")
        require(scraped["n"] > 0 and fleet_scraped["n"] > 0
                and "train_steps_total" in scraped["body"]
                and "# gauge-table" in fleet_scraped["body"],
                "no scrape of /metrics or /fleet during the steps")
    per = {k: v / LAG_STEPS for k, v in counts.items()}
    want = dict(gpt_pass_launches(cfg), packed_scale=1, packed_adam_tree=1)
    require(per == want, f"wrapped launches a step {per}, want {want}")
    last = regs[-1].to_prometheus()
    del a, model, step
    torch.cuda.empty_cache()
    # one O4 step, wrapped: the fp8 gauges
    model = params_from_jax(tree, cfg, trainable=True)
    a4 = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-4),
                        opt_level="O4")
    reg4 = Registry()
    step4 = instrument_step(amp.make_train_step(a4, model, _gpt_loss),
                            registry=reg4)
    reset_launch_counts()
    out4 = step4(ids)
    o4_counts = launch_counts()
    reg4.flush()
    sat = reg4.gauge("train_fp8_amax_saturation").value
    resc = reg4.counter("train_fp8_rescales_total").value
    require(np.isfinite(sat) and np.isfinite(resc)
            and "train_fp8_amax_saturation" in reg4.to_prometheus()
            and sat == float(out4["fp8_amax_saturation"])
            and resc == float(out4["fp8_rescales"]),
            f"fp8 gauges {sat} / {resc}")
    require(o4_counts == want, f"O4 wrapped launches {o4_counts}")
    del a4, model, step4
    torch.cuda.empty_cache()
    b_p50 = float(np.median([r["step_ms_p50"] for r in bare]))
    w_p50 = float(np.median([r["step_ms_p50"] for r in wrapped]))
    emit("obs_lag", model="gpt_small", opt_level="O2", batch=TRAIN_B,
         seq_len=TRAIN_L, steps=LAG_STEPS, turns=LAG_TURNS,
         registry=dict(lag=1, resolve_every=8), bare=bare, wrapped=wrapped,
         bare_step_ms_p50=b_p50, wrapped_step_ms_p50=w_p50,
         wrapped_over_bare=w_p50 / b_p50 - 1.0,
         prometheus_lines=len(last.splitlines()),
         fp8_o4=dict(train_fp8_amax_saturation=sat,
                     train_fp8_rescales_total=resc, launches=o4_counts),
         launches=counts, seconds=time.perf_counter() - t0)
    return counts


def phase_native():
    """The native host runtime (``apex_tpu_torch/csrc/host_runtime.cpp``,
    built with the host compiler) on the DDP phase's ResNet-50 gradients
    (the O2 leaves' element counts, grouped by dtype as
    ``reduce_gradients`` groups them): ``plan_buckets`` equal to its plain
    version (and the buckets the DDP phase reduces), and ``flatten`` /
    ``unflatten`` of the fp32 masters' host copies equal to theirs, each
    timed against its plain version (a plan: the mean of ``NATIVE_REPS``
    calls of each dtype's, summed over the dtypes)."""
    import torch
    from apex_tpu_torch import _native, amp
    from apex_tpu_torch.models import ARCHS
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import distributed
    t_build = time.perf_counter()
    _native.library()
    build_s = time.perf_counter() - t_build
    model = ARCHS["resnet50"]()
    a = amp.initialize(model, FusedAdam(model.parameters()), opt_level="O2")
    by_dtype = {}
    for p in a.params:
        by_dtype.setdefault(str(p.dtype), []).append(p.numel())
    plans, t_native, t_plain = {}, 0.0, 0.0
    for dt, numels in by_dtype.items():
        got = distributed.plan_buckets(numels,
                                       distributed.DEFAULT_MESSAGE_SIZE)
        want = _native.plan_buckets_plain(numels,
                                          distributed.DEFAULT_MESSAGE_SIZE)
        require(np.array_equal(got, want), f"plan_buckets {dt} differs")
        plans[dt] = dict(leaves=len(numels), buckets=int(got[-1]) + 1)
        # the mean of NATIVE_REPS calls each, as a DDP step makes one
        t = time.perf_counter()
        for _ in range(NATIVE_REPS):
            distributed.plan_buckets(numels, distributed.DEFAULT_MESSAGE_SIZE)
        t_native += (time.perf_counter() - t) / NATIVE_REPS
        t = time.perf_counter()
        for _ in range(NATIVE_REPS):
            _native.plan_buckets_plain(numels,
                                       distributed.DEFAULT_MESSAGE_SIZE)
        t_plain += (time.perf_counter() - t) / NATIVE_REPS
    host = [m.detach().cpu().numpy() for m in a.masters.values()]
    t = time.perf_counter()
    flat = _native.flatten(host)
    flat_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    plain = _native.flatten_plain(host)
    plain_ms = (time.perf_counter() - t) * 1e3
    back = _native.unflatten(flat, [h.shape for h in host])
    require(np.array_equal(flat, plain)
            and all(np.array_equal(x, y) for x, y in zip(back, host)),
            "native flatten / unflatten differ from the plain versions")
    emit("native", source="apex_tpu_torch/csrc/host_runtime.cpp",
         library=str(_native.library_path()), build_s=build_s,
         resnet50_buckets=plans, plan_buckets_us=t_native * 1e6,
         plan_buckets_plain_us=t_plain * 1e6,
         flatten_bytes=int(flat.nbytes), flatten_ms=flat_ms,
         flatten_plain_ms=plain_ms)
    del a, model
    torch.cuda.empty_cache()


def phase_xplane(cfg, tree, repo: Path):
    """Two gpt_small O2 steps profiled under a schedule (made last, with
    the other profiled phases), the chrome trace written by
    ``tensorboard_trace_handler``: ``obs.xplane.op_times``'s device total
    against ``prof.key_averages()``'s within 1%, and ``step_markers``
    counting the 2 steps."""
    import shutil
    import tempfile
    import torch
    from torch.profiler import (ProfilerActivity, profile, schedule,
                                tensorboard_trace_handler)
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.obs import xplane
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-4),
                       opt_level="O2")
    step = amp.make_train_step(a, model, _gpt_loss)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    step(ids)
    torch.cuda.synchronize()
    d = tempfile.mkdtemp(prefix="apex_tpu_torch_trace_",
                         dir=str(repo / "build"))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=2,
                                       repeat=1),
                     on_trace_ready=tensorboard_trace_handler(d)) as prof:
            for _ in range(3):
                step(ids)
                torch.cuda.synchronize()
                prof.step()
        t = xplane.op_times(d)
        marks = xplane.step_markers(d)
        trace_bytes = sum(os.path.getsize(os.path.join(r, f))
                          for r, _, fs in os.walk(d) for f in fs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    want_ms = sum(device_kernel_ms(prof).values())
    got_ms = t.total_ps / 1e9
    require(t.source == "trace-device", f"trace source {t.source}")
    require(abs(got_ms - want_ms) <= 0.01 * want_ms,
            f"xplane total {got_ms} ms against the profiler's {want_ms}")
    require(len(marks) == 2, f"step markers {marks}")
    top = sorted(t.by_op.items(), key=lambda kv: -kv[1])[:5]
    emit("xplane", model="gpt_small", opt_level="O2", profiled_steps=2,
         device_ms=got_ms, key_averages_device_ms=want_ms,
         rel_diff=got_ms / want_ms - 1.0,
         by_category_ms={k: v / 1e9 for k, v in t.by_category.items()},
         step_markers_ms=[m["duration_ps"] / 1e9 for m in marks],
         top_ops_ms=[[n[:80], v / 1e9] for n, v in top],
         trace_bytes=trace_bytes)
    del a, model, step
    torch.cuda.empty_cache()


# -- the continuous profiler: the serving fleet and the resilient loop ------

#: the serve lanes: the router's profilers capture 2 steps every 16
#: (replicas staggered by 8) over the serve phase's requests, each capped
#: at 80 new tokens (5 windows a replica); the sentinel's band and
#: confirmation count
CP_EVERY, CP_STEPS, CP_NEW = 16, 2, 80
CP_BAND = 0.1
CP_BAND_SOURCE = ("the clean lane's spread on an H100 (this phase): "
                  "bucket fractions within 0.01 and a step's device time "
                  "within 8% across a run's windows")
CP_K = 2
#: the seeded lane: replica 0's kv_read op times x 2 from window 2
CP_SEED_BUCKET, CP_SEED_FACTOR, CP_SEED_FROM = "kv_read", 2.0, 2
#: the train lane: one window (steps 3-4 of 8) of run_resilient
CP_TRAIN_STEPS = 8
#: the rewind lane: a window opens at step index 11, where resolving
#: step 10 rewinds (RES_STORM, RES_PATIENCE)
CP_REWIND_EVERY = 10
#: the cost: captured and bare 2-step segments in turns (turn 0 warms
#: the capture up and is reported apart); the amortizing cadence
CP_TURNS = 3
CP_DEFAULT_EVERY = 256
#: the train windows' kernels and the one bucket each must land in
CP_TRAIN_GROUPS = {"flash_attn_bwd_dq (K13)": "bwd",
                   "flash_attn_bwd_dkv (K14)": "bwd",
                   "packed_scale (K6)": "optimizer",
                   "adam_tree (K11)": "optimizer",
                   "flash_attn_fwd (K2)": "fwd",
                   "layer_norm_fwd (K1)": "fwd"}


def _window_row(w) -> dict:
    """A window's record as the phase line prints it."""
    keys = ("index", "start_step", "steps", "step_wall_s",
            "host_step_wall_s", "stream_steps", "stream_step_wall_s",
            "source", "fractions", "out_of_band", "matched_frac",
            "capture_s", "parse_s", "total_ps", "attributed_ps",
            "unattributed_ps", "discarded")
    return {k: w[k] for k in keys if k in w}


def _seed_profiler(prof, bucket, factor, start):
    """The seeded lane of ``tools/continuous_profile.py``: from window
    ``start`` on, the measured times of every key the classifier puts in
    ``bucket`` are multiplied by ``factor`` before bucketing."""
    def seeded(step_times, clf):
        if len(prof.windows) + len(prof.discarded) < start:
            return step_times
        return {k: (int(ps * factor) if clf(k) == bucket else ps)
                for k, ps in step_times.items()}
    prof._seed = seeded


def _contprof_fleet(model, cfg, requests, scfg, lane, incident_path=None):
    """The requests through ``DisaggRouter`` (ship, ``FLEET_DEVICES``):
    lane ``plain`` without a profiler, ``clean`` and ``seeded`` with
    ``RouterConfig(contprof=...)`` (replica 0 seeded in ``seeded``):
    outputs, launches, wall seconds, the router."""
    import torch
    from apex_tpu_torch.obs import FlightRecorder, Registry
    from apex_tpu_torch.obs.contprof import ContProfConfig
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.serve import DisaggRouter, Request, RouterConfig
    # the cadence pinned, as tools/continuous_profile.py pins it: the
    # auto-throttle would widen it to ~10^3 steps after the first window
    rcfg = RouterConfig(transfer="ship") if lane == "plain" else \
        RouterConfig(transfer="ship", incident_path=incident_path,
                     contprof=ContProfConfig(capture_every=CP_EVERY,
                                             capture_steps=CP_STEPS,
                                             max_overhead_pct=None),
                     contprof_band=CP_BAND, contprof_k=CP_K)
    router = DisaggRouter(model, cfg, scfg, rcfg, devices=FLEET_DEVICES,
                          registry=Registry(), flight=FlightRecorder())
    if lane == "seeded":
        _seed_profiler(router.profilers[0], CP_SEED_BUCKET, CP_SEED_FACTOR,
                       CP_SEED_FROM)
    for uid, prompt, n in requests:
        router.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = router.run()
    torch.cuda.synchronize()
    return out, launch_counts(), time.perf_counter() - t0, router


def _range_cost(model, cfg, requests, scfg, plain_router) -> dict:
    """What the decode path's classifier ranges cost outside a capture:
    the ranges one decode step of 8 slots enters (counted in one
    captured step), the host µs of a range outside a capture (a flag
    check), and their product against the unprofiled fleet's mean decode
    step."""
    import json as json_mod
    import tempfile
    import torch
    from apex_tpu_torch.obs import Registry
    from apex_tpu_torch.serve import Request, ServeEngine
    from apex_tpu_torch.utils.profiling import profile_range
    eng = ServeEngine(model, cfg, scfg, registry=Registry())
    for uid, prompt, n in requests[:scfg.num_slots]:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    eng.step()
    prof.stop()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "step.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json_mod.load(f)["traceEvents"]
    ranges = sum(1 for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("decode/"))

    def enter_exit():
        with profile_range("decode/kv_read"):
            pass

    us = host_us(enter_exit, n=20000)
    hists = [r.eng.metrics.histogram("serve_decode_step_seconds")
             for r in plain_router.replicas]
    step_ms = sum(h.sum for h in hists) / max(sum(h.count for h in hists),
                                              1) * 1e3
    del eng
    return dict(ranges_a_decode_step=ranges, range_us=us,
                cost_us_a_step=ranges * us, plain_step_ms=step_ms,
                cost_pct=ranges * us / 1e3 / step_ms * 100.0)


def _lane_record(router, wall) -> dict:
    """Each replica's profiler and sentinel after a lane's run."""
    reps = []
    for i, (prof, sent) in enumerate(zip(router.profilers,
                                         router.sentinels)):
        reps.append(dict(
            windows=[_window_row(w) for w in prof.windows],
            discarded=[_window_row(w) for w in prof.discarded],
            skipped=prof.skipped_windows, aborted=prof.aborted_windows,
            drifts=[{k: d[k] for k in ("window", "bucket", "windows_out")}
                    for d in sent.drifts],
            drifting=sent.drifting,
            gauge=router.replicas[i].eng.metrics.gauge(
                "serve_profile_drift").value,
            router_gauge=router.metrics.gauge(
                f"serve_replica{i}_profile_drift").value,
            profiled_steps=router.replicas[i].eng.metrics.histogram(
                "serve_profiled_step_seconds").count,
            gated_steps=router.replicas[i].eng.metrics.histogram(
                "serve_decode_step_seconds").count))
    return dict(wall_s=wall, replicas=reps)


def _session(prof, sent, seed=None) -> dict:
    """A PROFILE_DRIFT session of one replica's windows."""
    out = {"baseline": sent.baseline,
           "windows": [dict(_window_row(w), out_of_band=w["out_of_band"])
                       for w in prof.windows],
           "drifts": [{k: d[k] for k in ("window", "bucket", "windows_out")}
                      for d in sent.drifts],
           "quiet": not sent.drifts,
           "discarded_windows": len(prof.discarded),
           "skipped_windows": prof.skipped_windows}
    if seed is not None:
        out["seed"] = seed
    return out


def _serve_windows_ok(lane: str, router) -> None:
    """Every window of every replica: from the device, none discarded,
    the decode fractions summing to 1, ``other`` at most half."""
    for i, prof in enumerate(router.profilers):
        require(not prof.discarded,
                f"{lane}: replica {i} discarded {prof.discarded}")
        require(prof.windows, f"{lane}: replica {i} has no window")
        for w in prof.windows:
            require(w["source"] == "trace-device",
                    f"{lane}: replica {i} window {w['index']} source "
                    f"{w['source']}")
            total = sum(w["fractions"].values())
            require(abs(total - 1.0) <= 1e-6,
                    f"{lane}: replica {i} window {w['index']} fractions "
                    f"sum to {total}")
            require(w["fractions"]["other"] <= 0.5,
                    f"{lane}: replica {i} window {w['index']} other "
                    f"{w['fractions']['other']} > 0.5")


def _train_window(cfg, tree):
    """``run_resilient`` over gpt_small O2 with ``train_profiler``: one
    window, its buckets and where the port's kernels landed; then a NaN
    storm whose rewind suppresses the window open at that step."""
    import torch
    from apex_tpu_torch.obs import FlightRecorder, Registry
    from apex_tpu_torch.obs.contprof import (ContProfConfig, _capture_lock,
                                             train_profiler)
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.resilience import (FaultInjector, NaNStorm,
                                           ResilienceConfig, run_resilient)
    a, step = _res_amp(cfg, tree)
    batch = _res_batches(cfg)
    step(*batch(0))
    torch.cuda.synchronize()
    reg = Registry()
    prof = train_profiler(
        config=ContProfConfig(capture_every=4, capture_steps=2,
                              warmup_steps=2, max_windows=1,
                              max_overhead_pct=None), registry=reg)
    reset_launch_counts()
    result = run_resilient(step, a, batch, CP_TRAIN_STEPS,
                           config=ResilienceConfig(watchdog_timeout_s=120.0),
                           registry=reg, profiler=prof)
    torch.cuda.synchronize()
    per = {k: v / CP_TRAIN_STEPS for k, v in launch_counts().items()}
    want = dict(gpt_pass_launches(cfg), packed_scale=1, packed_adam_tree=1)
    require(per == want, f"profiled loop's launches a step {per}, want "
                         f"{want}")
    require(result.steps_completed == CP_TRAIN_STEPS and len(prof.windows)
            == 1 and not prof.discarded, f"train windows {prof.windows} / "
                                         f"{prof.discarded}")
    w = prof.windows[0]
    groups = {g: {b: ps / 1e9 for b, ps in by.items()}
              for g, by in w.get("groups", {}).items()}
    train = dict(window=_window_row(w), groups_ms=groups,
                 top_ops=w["top_ops"], launches_a_step=per)
    # the rewind: a NaN storm pins the scale; resolving step 10 rewinds
    # while the window opened at step 11 is open
    flight = FlightRecorder()
    prof2 = train_profiler(
        config=ContProfConfig(capture_every=CP_REWIND_EVERY,
                              capture_steps=2, warmup_steps=1,
                              max_overhead_pct=None))
    inj = FaultInjector([NaNStorm(**RES_STORM)])
    r2 = run_resilient(step, a, batch, RES_STEPS,
                       config=ResilienceConfig(
                           checkpoint_every=RES_EVERY,
                           overflow_patience=RES_PATIENCE,
                           watchdog_timeout_s=120.0),
                       injector=inj, registry=Registry(), flight=flight,
                       profiler=prof2)
    torch.cuda.synchronize()
    rewind = dict(rewinds=r2.rewinds, windows=len(prof2.windows),
                  window_starts=[x["start_step"] for x in prof2.windows],
                  aborted=prof2.aborted_windows,
                  steps_begun=prof2._step,
                  lock_free=not _capture_lock.locked())
    del a, step
    torch.cuda.empty_cache()
    return train, w, rewind


def _cost_turns(cfg, tree):
    """A captured 2-step segment (a window: open, the steps, close,
    parse, classify) in turns with bare ones before and after it, from a
    synchronized card to a synchronized card."""
    import torch
    from apex_tpu_torch.obs.contprof import (ContProfConfig,
                                             train_classifier_builder,
                                             train_profiler)
    a, step = _res_amp(cfg, tree)
    ids = _res_batches(cfg)(0)
    step(*ids)
    torch.cuda.synchronize()

    def bare():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CP_STEPS):
            step(*ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows = []
    for turn in range(CP_TURNS + 1):
        before = bare()
        prof = train_profiler(config=ContProfConfig(
            capture_every=CP_DEFAULT_EVERY, capture_steps=CP_STEPS,
            warmup_steps=0))
        prof.set_classifier_builder(train_classifier_builder(prof.scope))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CP_STEPS):
            require(prof.step_begin(), "the cost turn's window did not open")
            td = time.perf_counter()
            step(*ids)
            prof.step_end(time.perf_counter() - td)
        captured = (time.perf_counter() - t0) * 1e3
        after = bare()
        require(len(prof.windows) == 1, f"cost turn windows "
                                        f"{prof.windows} {prof.discarded}")
        w = prof.windows[0]
        rows.append(dict(bare_ms=before, captured_ms=captured,
                         after_ms=after, capture_s=w["capture_s"],
                         parse_s=w["parse_s"],
                         sentinel_s=w.get("sentinel_s", 0.0),
                         device_ps=w["total_ps"],
                         throttled_to=w.get("throttled_to")))
    del a, step
    torch.cuda.empty_cache()
    steady = rows[1:]
    bare_ms = float(np.median([r["bare_ms"] for r in steady]))
    cost_ms = float(np.median([r["captured_ms"] - r["bare_ms"]
                               for r in steady]))
    after_ms = float(np.median([r["after_ms"] for r in steady]))
    step_ms = bare_ms / CP_STEPS
    return dict(turns=rows, first_window=rows[0],
                bare_2_steps_ms=bare_ms, window_cost_ms=cost_ms,
                bare_after_window_2_steps_ms=after_ms,
                after_over_before=after_ms / bare_ms - 1.0,
                step_ms=step_ms, default_capture_every=CP_DEFAULT_EVERY,
                amortized_overhead_pct=100.0 * cost_ms
                / (CP_DEFAULT_EVERY * step_ms))


def phase_contprof(cfg, tree, requests, repo: Path):
    """The continuous profiler on the card (made last, with the other
    profiled phases).  Serving: ``DisaggRouter`` over gpt_small (bf16)
    with two decode replicas on ``FLEET_DEVICES`` and
    ``RouterConfig(contprof=ContProfConfig(capture_every=16,
    capture_steps=2))``, the serve phase's 16 requests capped at 80 new
    tokens: a run without a profiler, a clean lane and a seeded lane
    (replica 0's ``kv_read`` times x 2 from window 2), the greedy streams
    of both equal the plain run's bit for bit; every window from the
    device, none discarded, fractions summing to 1, ``other`` at most
    half; the clean lane quiet; the seeded lane's drift confirmed at
    window ``2 + k - 1`` naming ``kv_read``, the replica's gauges set,
    its incident valid, the replica ranked last; the session's document
    valid under the port's ``validate_profile_drift``; the decode ranges'
    cost outside a window.  Training: ``run_resilient`` over
    gpt_small O2 with ``train_profiler`` (fwd, bwd and optimizer above 0;
    K13 / K14 in bwd, K6 / K11 in optimizer, K2 / K1 in fwd), a NaN
    storm's rewind suppressing the open window, and a window's cost
    against bare steps in turns."""
    import shutil
    import tempfile
    import torch
    from apex_tpu_torch.analysis import CONTPROF_BUDGET_PCT
    from apex_tpu_torch.analysis.profile_drift import validate_profile_drift
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.obs.contprof import _capture_lock
    from apex_tpu_torch.resilience.incidents import validate_incident_file
    from apex_tpu_torch.serve import Request
    t_phase = time.perf_counter()
    model = params_from_jax(tree, cfg, dtype=torch.bfloat16)
    scfg = _serve_cfg()
    requests = [(uid, p, min(n, CP_NEW)) for uid, p, n in requests]
    root = tempfile.mkdtemp(prefix="apex_tpu_torch_contprof_",
                            dir=str(repo / "build"))
    try:
        plain_out, plain_counts, plain_wall, plain_router = \
            _contprof_fleet(model, cfg, requests, scfg, "plain")
        ranges = _range_cost(model, cfg, requests, scfg, plain_router)
        del plain_router
        lanes, routers, counts = {}, {}, {}
        for lane in ("clean", "seeded"):
            inc = os.path.join(root, f"INCIDENT_{lane}.json")
            out, got, wall, router = _contprof_fleet(
                model, cfg, requests, scfg, lane, inc)
            require(set(out) == set(plain_out) and all(
                np.array_equal(out[u], plain_out[u]) for u in plain_out),
                f"{lane}: the profiled streams differ from the plain run")
            lanes[lane] = _lane_record(router, wall)
            routers[lane], counts[lane] = router, got
            lanes[lane]["incident_valid"] = (
                validate_incident_file(inc) if os.path.exists(inc)
                else None)
        clean, seeded = routers["clean"], routers["seeded"]
        probe = Request(uid="probe", prompt=np.ones(8, np.int64),
                        max_new_tokens=8)
        picked = seeded._pick_replica(probe)
        seed = {"bucket": CP_SEED_BUCKET, "factor": CP_SEED_FACTOR,
                "from_window": CP_SEED_FROM}
        doc = {"round": 1, "platform": "gpu", "kind": "serve-decode",
               "config": {"model": "gpt_small", "replica": 0,
                          "num_slots": scfg.num_slots,
                          "capture_every": CP_EVERY,
                          "capture_steps": CP_STEPS},
               "band": {"value": CP_BAND, "source": CP_BAND_SOURCE},
               "k": CP_K,
               "sessions": {
                   "clean": _session(clean.profilers[0],
                                     clean.sentinels[0]),
                   "seeded": _session(seeded.profilers[0],
                                      seeded.sentinels[0], seed)}}
        caught = bool(seeded.sentinels[0].drifts)
        quiet = all(not s.drifts for s in clean.sentinels)
        doc["gate"] = {"clean_quiet": doc["sessions"]["clean"]["quiet"],
                       "seeded_caught": caught,
                       "ok": doc["sessions"]["clean"]["quiet"] and caught}
        doc["note"] = ("gpt_small on one H100: replica 0 of a 2-replica "
                       "DisaggRouter, windows of 2 decode steps every 16 "
                       "bucketed from the card's kernels; the seeded "
                       "lane inflates kv_read x 2 before bucketing")
        problems = validate_profile_drift(doc)
        train, train_w, rewind = _train_window(cfg, tree)
        del model
        torch.cuda.empty_cache()
        cost = _cost_turns(cfg, tree)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want_drift = CP_SEED_FROM + CP_K - 1
    s_drifts = seeded.sentinels[0].drifts
    emit("contprof", model="gpt_small", requests=len(requests),
         replicas=2, devices=list(FLEET_DEVICES),
         capture_every=CP_EVERY, capture_steps=CP_STEPS, band=CP_BAND,
         k=CP_K, plain_wall_s=plain_wall, ranges_outside_a_window=ranges,
         lanes=lanes,
         launches_plain=plain_counts, launches_profiled=counts,
         seeded_pick=picked.index if picked is not None else None,
         document_problems=problems, train=train, rewind=rewind,
         cost=dict(cost, budget_pct=CONTPROF_BUDGET_PCT),
         seconds=time.perf_counter() - t_phase)
    for lane, router in routers.items():
        _serve_windows_ok(lane, router)
        require(counts[lane] == plain_counts,
                f"{lane}: profiled launches {counts[lane]} != plain "
                f"{plain_counts}")
    require(len(seeded.profilers[0].windows) >= want_drift + 1,
            f"seeded: replica 0 captured "
            f"{len(seeded.profilers[0].windows)} windows")
    require(quiet, f"clean lane drifted: "
                   f"{[s.drifts for s in clean.sentinels]}")
    require(s_drifts and s_drifts[0]["window"] == want_drift
            and s_drifts[0]["bucket"] == CP_SEED_BUCKET,
            f"seeded drifts {s_drifts}, want window {want_drift} "
            f"{CP_SEED_BUCKET}")
    require(not seeded.sentinels[1].drifts,
            f"the unseeded replica drifted: {seeded.sentinels[1].drifts}")
    require(seeded.metrics.gauge("serve_replica0_profile_drift").value == 1.0
            and seeded.replicas[0].eng.metrics.gauge(
                "serve_profile_drift").value == 1.0
            and seeded.metrics.gauge(
                "serve_replica1_profile_drift").value == 0.0,
            "the seeded replica's drift gauges did not flip")
    require(lanes["seeded"]["incident_valid"] == [],
            f"seeded incident: {lanes['seeded']['incident_valid']}")
    require(picked is seeded.replicas[1],
            "the drifting replica did not rank last")
    require(problems == [], f"PROFILE_DRIFT document: {problems}")
    require(ranges["ranges_a_decode_step"] > 0,
            "no decode range in a captured decode step")
    fr = train_w["fractions"]
    require(all(fr[b] > 0 for b in ("fwd", "bwd", "optimizer"))
            and train_w["source"] == "trace-device",
            f"train window fractions {fr} ({train_w['source']})")
    groups = train_w.get("groups", {})
    for g, b in CP_TRAIN_GROUPS.items():
        by = groups.get(g, {})
        require(by and set(by) == {b},
                f"{g} landed in {by}, want only {b}")
    require(rewind["rewinds"] == 1 and rewind["aborted"] == 1
            and rewind["windows"] == 1 and rewind["lock_free"],
            f"the rewind did not suppress the open window: {rewind}")
    require(not _capture_lock.locked(), "a window leaked the capture")
    require(time.perf_counter() - t_phase <= 90.0,
            f"contprof phase took {time.perf_counter() - t_phase:.1f} s")


PARTIAL_PHASES = ("o0_train", "generic_kernels", "train_kernels", "train",
                  "multi_tensor_kernels", "bert_kernels", "bert_train",
                  "resnet_kernels", "resnet_train", "ddp", "amp_surface",
                  "data_prefetch", "seq_parallel", "rnn", "pipeline_moe",
                  "resilience", "train_fleet", "quant", "serve_fleet",
                  "serve", "contprof")


def partial_run(names, repo: Path) -> int:
    """The device phase, the tree's kernel library (built if it has none,
    with no spill checks), then each named phase of ``PARTIAL_PHASES`` in
    that order; no ``kernels`` or ``ok`` line (not the whole run)."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import bert_large, gpt_small
    from apex_tpu_torch.ops.cuda import build
    phase_device()
    build.library()   # this tree's library, compiled only if it has none
    info = build.build_info()
    emit("build", library=info.path, compiled=info.compiled,
         nvcc_seconds=round(info.seconds, 3))
    cfg, bert_cfg = gpt_small(), bert_large()
    for name in PARTIAL_PHASES:
        if name not in names:
            continue
        if name == "o0_train":
            phase_o0_train(cfg, gpt_small_tree(cfg, seed=0))
        elif name == "generic_kernels":
            phase_generic_kernels(profile=True)
        elif name == "train_kernels":
            phase_train_kernels(cfg)
        elif name == "train":
            phase_train(cfg, gpt_small_tree(cfg, seed=0))
        elif name == "multi_tensor_kernels":
            phase_multi_tensor_kernels(cfg, bert_cfg)
        elif name == "bert_kernels":
            phase_bert_kernels(bert_cfg)
        elif name == "bert_train":
            phase_bert_train(bert_cfg)
        elif name == "resnet_kernels":
            phase_resnet_kernels()
        elif name == "resnet_train":
            phase_resnet_train()
        elif name == "ddp":
            phase_ddp(repo)
        elif name == "amp_surface":
            phase_amp_surface(cfg, gpt_small_tree(cfg, seed=0))
        elif name == "data_prefetch":
            phase_data_prefetch()
        elif name == "seq_parallel":
            phase_seq_parallel(cfg, gpt_small_tree(cfg, seed=0), repo)
        elif name == "rnn":
            phase_rnn()
        elif name == "pipeline_moe":
            phase_pipeline_moe(cfg, gpt_small_tree(cfg, seed=0), repo)
        elif name == "resilience":
            phase_resilience(cfg, gpt_small_tree(cfg, seed=0))
        elif name == "train_fleet":
            # the slice's phases: the drill, the lag and fp8 gauges, the
            # native runtime, then the profiled trace
            phase_train_fleet(repo)
            phase_obs_lag(cfg, gpt_small_tree(cfg, seed=0))
            phase_native()
            phase_xplane(cfg, gpt_small_tree(cfg, seed=0), repo)
        elif name == "serve":
            phase_serve(params_from_jax(gpt_small_tree(cfg, seed=0), cfg,
                                        dtype=torch.bfloat16),
                        cfg, serve_requests(cfg))
        elif name == "quant":
            phase_quant(cfg, gpt_small_tree(cfg, seed=0),
                        serve_requests(cfg))
        elif name == "contprof":
            phase_contprof(cfg, gpt_small_tree(cfg, seed=0),
                           serve_requests(cfg), repo)
        else:
            phase_serve_fleet(cfg, gpt_small_tree(cfg, seed=0),
                              serve_requests(cfg))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(HERE),
                    help="the checkout whose apex_tpu_torch is driven "
                         "(default: the one beside this script)")
    ap.add_argument("--only", default=None,
                    help="a partial run: comma-separated phases of "
                         + ", ".join(PARTIAL_PHASES))
    ap.add_argument("--ddp-rank", choices=("nccl", "gloo", "sp_gloo",
                                           "pm_gloo"),
                    default=None,
                    help=argparse.SUPPRESS)   # a rank of ddp / seq_parallel
    ap.add_argument("--ddp-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None
    if only and not set(only) <= set(PARTIAL_PHASES):
        ap.error(f"--only takes {PARTIAL_PHASES}, got {only}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    if not (repo / "apex_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no apex_tpu_torch in {repo}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    # the launch expectations below assume the default partials budget
    # and the 1x1-conv switch off
    os.environ.pop(BUDGET_ENV, None)
    os.environ.pop(CONV1X1_ENV, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ddp_rank:
        # a rank of the ddp phase, started by the port's spawner: results
        # go to --ddp-out, failures to stderr
        rank = {"nccl": _ddp_rank_nccl, "gloo": _ddp_rank_gloo,
                "sp_gloo": _sp_rank_gloo, "pm_gloo": _pm_rank_gloo}
        rank[args.ddp_rank](Path(args.ddp_out))
        return 0
    if only:
        try:
            return partial_run(only, repo)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
    t_start = time.perf_counter()
    try:
        name, count, smi = phase_device()
        phase_build()
        from apex_tpu_torch.convert import params_from_jax
        from apex_tpu_torch.models import gpt_small
        cfg = gpt_small()
        requests = serve_requests(cfg)
        solo_reqs = requests[:4]
        ln_recs, fl_recs, ln_extra = phase_kernels(
            [len(p) for _, p, _ in solo_reqs])
        tree = gpt_small_tree(cfg, seed=0)
        model = params_from_jax(tree, cfg, dtype=torch.bfloat16)
        engine_out, serve_counts = phase_serve(model, cfg, requests)
        solo_counts = phase_solo(model, cfg, solo_reqs, engine_out)
        require(serve_counts["layer_norm_fwd"] > 0,
                "layer_norm_fwd never launched on the serve path")
        require(solo_counts["flash_attn_fwd"] > 0,
                "flash_attn_fwd never launched on the solo path")
        del model
        torch.cuda.empty_cache()
        # host-bound like serve: before any profiler session
        fleet_counts = phase_serve_fleet(cfg, tree, requests)
        require(fleet_counts["spec_serve"]["layer_norm_fwd"] > 0
                and fleet_counts["fleet_serve"]["layer_norm_fwd"] > 0,
                "layer_norm_fwd never launched on the spec or fleet path")
        require(fleet_counts["toy_solo"]["flash_attn_fwd"] > 0,
                "flash_attn_fwd never launched on the toy LM's solo path")
        phase_reference(tree, cfg)
        train_recs = phase_train_kernels(cfg)
        train_counts = phase_train(cfg, tree)
        phase_train_reference()
        from apex_tpu_torch.models import bert_large
        bert_cfg = bert_large()
        mt_recs = phase_multi_tensor_kernels(cfg, bert_cfg)
        nf_recs = phase_nonfinite_kernels(cfg, bert_cfg)
        accum_counts = phase_accum(cfg, tree)
        phase_accum_reference()
        fp16_counts, fp16_k9 = phase_fp16_optimizer(cfg, tree)
        lc_recs, lc_fwd = phase_long_context_kernels()
        lc_counts, lc32_counts = phase_long_context(cfg, tree)
        phase_long_context_reference()
        o1_counts = phase_o1_train(cfg, tree)
        phase_o1_reference()
        o0_counts = phase_o0_train(cfg, tree)
        del tree
        bert_recs = phase_bert_kernels(bert_cfg)
        bert_counts = phase_bert_train(bert_cfg)
        phase_bert_train_reference()
        rk_recs, rk_extra, rk_others, rk_step = phase_resnet_kernels()
        rn_counts, rn_off_counts, rn_p50 = phase_resnet_train()
        phase_resnet_reference()
        ddp_counts = phase_ddp(repo)
        tree = gpt_small_tree(cfg, seed=0)
        surface = phase_amp_surface(cfg, tree)
        dp_counts = phase_data_prefetch()
        sp_counts, sp_blocks = phase_seq_parallel(cfg, tree, repo)
        pipe_counts, moe_counts = phase_pipeline_moe(cfg, tree, repo)
        res_counts = phase_resilience(cfg, tree)
        fleet_drill_counts = phase_train_fleet(repo)
        lag_counts = phase_obs_lag(cfg, tree)
        phase_native()
        quant_counts = phase_quant(cfg, tree, requests)
        del tree
        lm_counts = phase_rnn()
        mh_fwd, mh_bwd = phase_flash_mh_kernels()
        mh_counts = phase_flash_mh()
        repair_counts = phase_flash_repairs()
        half_o2_counts = phase_fp16_o2(cfg)
        mnist_counts = phase_mnist_o1()
        dcgan_counts = phase_dcgan_o1()
        simt_fwd, simt_bwd = phase_generic_kernels()
        phase_serve_profile(cfg)
        phase_xplane(cfg, gpt_small_tree(cfg, seed=0), repo)
        phase_contprof(cfg, gpt_small_tree(cfg, seed=0), requests, repo)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    by_path = {k: {"serve": serve_counts.get(k, 0),
                   "solo": solo_counts.get(k, 0),
                   "train": train_counts[k],
                   "accum": accum_counts[k],
                   "fp16_optimizer": fp16_counts[k],
                   "long_context": lc_counts[k],
                   "long_context_L32768": lc32_counts[k],
                   "bert_train": bert_counts[k],
                   "resnet_train": rn_counts[k],
                   "resnet_train_switch_off": rn_off_counts[k],
                   "ddp_resnet_nccl": ddp_counts.get(k, 0),
                   "o1_train": o1_counts[k],
                   "o0_train": o0_counts[k],
                   "flash_mh": mh_counts.get(k, 0),
                   "flash_repairs": repair_counts[k],
                   "fp16_o2": half_o2_counts[k],
                   "mnist_o1": mnist_counts[k],
                   "dcgan_o1": dcgan_counts[k],
                   "legacy_fp16_optimizer": surface["legacy_gpt"][k],
                   "legacy_fp16_optimizer_mnist":
                       surface["legacy_mnist"][k],
                   "add_params_step": surface["add_params"][k],
                   "data_prefetch": dp_counts[k],
                   "seq_parallel_nccl": sp_counts[k],
                   "pipeline_nccl": pipe_counts.get(k, 0),
                   "moe_nccl": moe_counts.get(k, 0),
                   "rnn_byte_lm": lm_counts.get(k, 0),
                   "resilient_loop": res_counts.get(k, 0),
                   "train_fleet_children": fleet_drill_counts[k],
                   "instrumented_train": lag_counts[k],
                   "o4_train": quant_counts["o4_train"][k],
                   "o4_accum": quant_counts["o4_accum"][k],
                   "int8_serve": quant_counts["int8_serve"][k],
                   "int8_solo": quant_counts["int8_solo"][k],
                   "spec_serve": fleet_counts["spec_serve"][k],
                   "fleet_serve": fleet_counts["fleet_serve"][k],
                   "toy_solo": fleet_counts["toy_solo"][k]}
               for k in bert_counts}
    rk_main = max(rk_recs, key=lambda r: r["bound_ms"])
    ln_main = next(r for r in ln_recs if r["n1"] == 8
                   and r["dtype"] == "bfloat16")
    rope_main = train_recs["flash_attn_fwd_rope"][0]
    summary = []
    for rec, recs, launches, src, rep in (
            (ln_main, ln_recs, serve_counts["layer_norm_fwd"],
             "apex_tpu_torch/csrc/layer_norm_fwd.cu",
             "apex_tpu/ops/pallas/layer_norm_kernels.py:132"),
            (fl_recs[0], fl_recs + [rope_main] + lc_fwd,
             solo_counts["flash_attn_fwd"],
             "apex_tpu_torch/csrc/flash_fwd_sm90.cu",
             "apex_tpu/ops/pallas/flash_attention.py:587"),
            # K2's helper: the per-tile rotation of k in `_fwd_kernel`,
            # once a call
            (train_recs["flash_fwd_prologue"][0],
             train_recs["flash_fwd_prologue"],
             train_counts["flash_fwd_prologue"],
             "apex_tpu_torch/csrc/flash_bwd_prologue.cu",
             "apex_tpu/ops/pallas/flash_attention.py:142"),
            # the generic kernels of the cases the Hopper kernels do not
            # take (fp32, half types above D 128)
            (simt_fwd[0], simt_fwd, o0_counts["flash_fwd_simt"],
             "apex_tpu_torch/csrc/flash_simt.cu",
             "apex_tpu/ops/pallas/flash_attention.py:587"),
            (simt_bwd[0], simt_bwd, o0_counts["flash_bwd_simt"],
             "apex_tpu_torch/csrc/flash_simt.cu",
             "apex_tpu/ops/pallas/flash_attention.py:477"),
            (train_recs["layer_norm_bwd"][0], train_recs["layer_norm_bwd"],
             train_counts["layer_norm_bwd"],
             "apex_tpu_torch/csrc/layer_norm_bwd.cu",
             "apex_tpu/ops/pallas/layer_norm_kernels.py:165"),
            (bert_recs["flash_attn_bwd"],
             train_recs["flash_attn_bwd"] + [bert_recs["flash_attn_bwd"]],
             bert_counts["flash_attn_bwd"],
             "apex_tpu_torch/csrc/flash_bwd_fused_sm90.cu",
             "apex_tpu/ops/pallas/flash_attention.py:477"),
            # K4's and K18's helper: the plane sum, inverse rotation and
            # deferred scale XLA applies after `_flash_bwd_fused`
            (bert_recs["flash_bwd_finish"],
             train_recs["flash_bwd_finish"] + [bert_recs["flash_bwd_finish"]],
             bert_counts["flash_bwd_finish"],
             "apex_tpu_torch/csrc/flash_bwd_fused_sm90.cu",
             "apex_tpu/ops/pallas/flash_attention.py:519"),
            (train_recs["packed_adam"][0], train_recs["packed_adam"],
             fp16_counts["packed_adam"], "apex_tpu_torch/csrc/adam.cu",
             "apex_tpu/ops/pallas/adam_kernel.py:216"),
            (train_recs["packed_scale"][0], train_recs["packed_scale"],
             train_counts["packed_scale"],
             "apex_tpu_torch/csrc/multi_tensor_scale.cu",
             "apex_tpu/ops/pallas/multi_tensor_kernels.py:62"),
            (bert_recs["lamb_stage1"], [bert_recs["lamb_stage1"]],
             bert_counts["lamb_stage1"], "apex_tpu_torch/csrc/lamb.cu",
             "apex_tpu/ops/pallas/lamb_kernels.py:147"),
            (bert_recs["lamb_stage2"], [bert_recs["lamb_stage2"]],
             bert_counts["lamb_stage2"], "apex_tpu_torch/csrc/lamb.cu",
             "apex_tpu/ops/pallas/lamb_kernels.py:240"),
            (bert_recs["packed_sumsq"],
             [bert_recs["packed_sumsq"], fp16_k9], bert_counts["packed_sumsq"],
             "apex_tpu_torch/csrc/multi_tensor_sumsq.cu",
             "apex_tpu/ops/pallas/multi_tensor_kernels.py:200"),
            (mt_recs["packed_axpby"], [mt_recs["packed_axpby"]],
             accum_counts["packed_axpby"],
             "apex_tpu_torch/csrc/multi_tensor_axpby.cu",
             "apex_tpu/ops/pallas/multi_tensor_kernels.py:124"),
            (mt_recs["packed_adam_tree"][0], mt_recs["packed_adam_tree"],
             train_counts["packed_adam_tree"], "apex_tpu_torch/csrc/adam.cu",
             "apex_tpu/ops/pallas/adam_kernel.py:159"),
            (mt_recs["sumsq_per_tensor"][0], mt_recs["sumsq_per_tensor"],
             accum_counts["sumsq_per_tensor"],
             "apex_tpu_torch/csrc/multi_tensor_sumsq.cu",
             "apex_tpu/ops/pallas/multi_tensor_kernels.py:179"),
            (lc_recs[1][0], [r[0] for r in lc_recs],
             lc_counts["flash_attn_bwd_dq"],
             "apex_tpu_torch/csrc/flash_attn_bwd_dq.cu",
             "apex_tpu/ops/pallas/flash_attention.py:647"),
            (lc_recs[1][1], [r[1] for r in lc_recs],
             lc_counts["flash_attn_bwd_dkv"],
             "apex_tpu_torch/csrc/flash_attn_bwd_dkv.cu",
             "apex_tpu/ops/pallas/flash_attention.py:671"),
            # K13 / K14's helper: the per-tile rotation and pre-scale of
            # `_dq_kernel` / `_dkv_kernel`, once a call
            (lc_recs[1][3], [r[3] for r in lc_recs],
             lc_counts["flash_bwd_prologue"],
             "apex_tpu_torch/csrc/flash_bwd_prologue.cu",
             "apex_tpu/ops/pallas/flash_attention.py:254"),
            (rk_main, rk_recs + rk_extra, rn_counts["conv1x1_bwd"],
             "apex_tpu_torch/csrc/conv1x1_bwd.cu",
             "apex_tpu/ops/pallas/experimental/conv1x1.py:101"),
            (nf_recs[0], nf_recs, accum_counts["packed_nonfinite"],
             "apex_tpu_torch/csrc/multi_tensor_nonfinite.cu",
             "apex_tpu/ops/pallas/experimental/finite_pack.py:66"),
            (mh_fwd[0], mh_fwd, mh_counts["flash_mh_fwd"],
             "apex_tpu_torch/csrc/flash_fwd_sm90.cu",
             "apex_tpu/ops/pallas/experimental/flash_mh.py:202"),
            (mh_bwd[1], mh_bwd, mh_counts["flash_mh_bwd"],
             "apex_tpu_torch/csrc/flash_bwd_fused_sm90.cu",
             "apex_tpu/ops/pallas/experimental/flash_mh.py:240")):
        entry = dict(
            name=rec["kernel"], route="cuda", source=src, replaces=rep,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            shape=rec.get("shape", [rec.get("n1"), rec.get("n2")]),
            launches_by_path=by_path[rec["kernel"]])
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")
        # the scale-aware checks' errors and limits, where a case has them
        scaled = keys + ("row_rel_err", "row_rel_tol", "norm_rel_err",
                         "norm_rel_tol")
        if rec["kernel"] == "flash_attn_fwd":
            # ms: the launch on prepared operands; call_ms: the wrapper
            # with its k^ prologue; full_prologue_call_ms: the other split
            rope_keys = scaled + ("call_ms", "prologue_ms",
                                  "full_prologue_call_ms", "bound_share")
            entry["call_ms"] = rec["call_ms"]
            entry["serving_shapes"] = [
                {k: r[k] for k in keys + ("call_ms", "kv_mask",
                                          "bound_share")}
                for r in fl_recs]
            entry["train_shape_with_rope"] = {k: rope_main[k]
                                              for k in rope_keys}
            entry["long_context_with_rope"] = [{k: r[k] for k in rope_keys}
                                               for r in lc_fwd]
        if rec["kernel"] == "flash_attn_bwd":
            k4 = scaled + ("launch_ms", "finish_ms", "bound_share",
                           "planes_bytes", "dtype")
            for k in k4:
                entry[k] = rec[k]
            entry["train_shape_fused_route"] = {
                k: train_recs["flash_attn_bwd"][0][k] for k in k4}
            entry["other_shapes"] = [{k: r[k] for k in k4}
                                     for r in train_recs["flash_attn_bwd"][1:]]
        if rec["kernel"] == "flash_bwd_finish":
            entry["helper_of"] = ["flash_attn_bwd", "flash_mh_bwd"]
            entry["other_shapes"] = [{k: r[k] for k in keys + ("rope",)}
                                     for r in recs[:-1]]
        if rec["kernel"] in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            at = 0 if rec["kernel"] == "flash_attn_bwd_dq" else 1
            per_shape = scaled + ("call_ms", "bound_share")
            entry["call_ms"] = rec["call_ms"]
            entry["train_shape"] = {k: lc_recs[0][at][k] for k in per_shape}
            entry["other_shapes"] = [{k: r[at][k] for k in per_shape}
                                     for r in lc_recs[2:]]
            for k in scaled[len(keys):]:
                entry[k] = max(r[k] for r in recs)      # over every shape
            entry["pairs"] = [r[2] for r in lc_recs]
        if rec["kernel"] == "flash_fwd_prologue":
            entry["helper_of"] = ["flash_attn_fwd"]
        if rec["kernel"] in ("flash_fwd_simt", "flash_bwd_simt"):
            entry["library_call"] = rec["library_call"]
            entry["takes"] = ("fp32 at every D up to 9664, bf16 / fp16 "
                              "above D 128: the tiled layout up to D 256, "
                              "a warp a row above")
            entry["layout"] = rec["layout"]
            entry["device_ms"] = rec["device_ms"]
            entry["library_device_ms"] = rec["library_device_ms"]
            entry["other_shapes"] = [
                {k: r[k] for k in keys + ("dtype", "rope", "layout",
                                          "library_call", "device_ms",
                                          "library_device_ms")}
                for r in recs[1:]]
        if rec["kernel"] == "flash_bwd_prologue":
            entry["helper_of"] = ["flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                                  "flash_attn_bwd", "flash_mh_bwd"]
            entry["other_shapes"] = [{k: r[k] for k in keys + ("rope",)}
                                     for r in recs]
        if rec["kernel"] in bert_recs and rec is not bert_recs[
                rec["kernel"]]:
            bert = bert_recs[rec["kernel"]]
            entry["bert_shape"] = {k: bert.get(k, [bert.get("n1"),
                                                   bert.get("n2")])
                                   for k in keys}
            entry["bert_shape"]["launches"] = bert_counts[rec["kernel"]]
        if rec["kernel"] == "layer_norm_fwd":
            # ms: the call as a decode step makes it (no statistics)
            entry["kernel_route"] = rec["route"]
            entry["stats_ms"] = rec["stats_ms"]
            entry["device_ms"] = rec["device_ms"]
            entry["library_device_ms"] = rec["library_device_ms"]
            entry["train_shapes"] = [
                {k: r[k] for k in ("n1", "n2", "dtype", "route", "ms",
                                   "stats_ms", "device_ms", "plain_ms",
                                   "library_ms", "library_device_ms",
                                   "bound_ms", "device_bound_share")}
                for r in recs if r["n1"] == 16384]
            entry["crossover"] = ln_extra["crossover"]
            entry["routes_checked"] = ln_extra["routes"]["checked"]
            entry["max_abs_err_by_dtype"] = ln_extra["routes"][
                "max_abs_err_by_dtype"]
        if rec["kernel"] == "packed_scale":
            entry["launches_a_call"] = rec["launches_a_call"]
            entry["bound_share"] = rec["bound_share"]
            entry["fp32_in_place"] = {k: recs[1][k] for k in keys + (
                "library_call", "bound_share")}
        if rec["kernel"] == "packed_sumsq":
            entry["fp16_optimizer_flat"] = dict(
                {k: fp16_k9[k] for k in keys}, rel_err=fp16_k9["rel_err"],
                launches=fp16_counts["packed_sumsq"])
        if rec["kernel"] in ("packed_adam_tree", "sumsq_per_tensor"):
            other = recs[1]
            entry["o3_bf16" if rec["kernel"] == "packed_adam_tree"
                  else "bert_shape"] = {k: other.get(k) for k in keys}
        if rec["kernel"] in rk_others:
            rn = rk_others[rec["kernel"]]
            entry["resnet50_shape"] = {k: rn[k] for k in keys + ("dtype",)}
            entry["resnet50_shape"]["launches"] = rn_counts[rec["kernel"]]
        if rec["kernel"] == "conv1x1_bwd":
            k16 = keys + ("calls_a_step", "dtype", "route", "plan",
                          "weight_to_oihw_copy_ms", "row_rel_err",
                          "norm_rel_err")
            entry["kernel_route"] = rec["route"]
            entry["resnet50_shapes"] = [{k: r[k] for k in k16}
                                        for r in rk_recs]
            entry["other_shapes"] = [{k: r[k] for k in k16}
                                     for r in rk_extra]
            entry["library"] = "aten.convolution_backward (cuDNN)"
            entry.update(rk_step)
            entry["resnet50_o2_step_ms_p50"] = rn_p50
        if rec["kernel"] == "layer_norm_bwd":
            k3 = ("n1", "n2", "dtype", "route", "partial_rows",
                  "launches_a_call", "ms", "device_ms", "plain_ms",
                  "bound_ms", "bound_by", "library_ms", "library_device_ms",
                  "max_abs_err", "bound_share", "device_bound_share")
            entry["kernel_route"] = rec["route"]
            entry["launches_a_call"] = rec["launches_a_call"]
            entry["shapes"] = [{k: r[k] for k in k3}
                               for r in recs + [bert_recs[rec["kernel"]]]]
        if rec["kernel"] == "packed_nonfinite":
            entry["other_cases"] = [
                {k: r[k] for k in ("case", "leaves", "dtypes", "bytes", "ms",
                                   "plain_ms", "bound_ms",
                                   "eager_all_finite_ms")}
                for r in recs[1:]]
            entry["eager_all_finite_ms"] = rec["eager_all_finite_ms"]
        if rec["kernel"] in ("flash_mh_fwd", "flash_mh_bwd"):
            same = ("k2_same_shape_ms" if rec["kernel"] == "flash_mh_fwd"
                    else "k4_same_shape_ms")
            extra = (("call_ms", "bound_share")
                     if rec["kernel"] == "flash_mh_fwd" else ())
            entry["shapes"] = [
                {k: r[k] for k in scaled + ("causal", "kv_mask", same)
                 + extra} for r in recs]
            if rec["kernel"] == "flash_mh_fwd":
                entry["call_ms"] = rec["call_ms"]
            entry[same] = rec[same]
            entry["library_call"] = rec["library_call"]
            entry["launches_by_shape_of_the_entry_point"] = mh_counts
        if rec["kernel"] == "flash_attn_fwd":
            # the ring's block calls: K2 with its lse (seq_parallel)
            entry["seq_parallel_ring_blocks"] = [
                {k: b[k] for k in ("shape", "causal", "kv_mask", "fwd_ms",
                                   "fwd_plain_ms", "fwd_bound_ms",
                                   "fwd_bound_by", "fwd_library_ms")}
                for b in sp_blocks]
        if rec["kernel"] in ("flash_attn_bwd", "flash_attn_bwd_dq",
                             "flash_attn_bwd_dkv"):
            # the ring's backward calls with a cotangent on the lse
            fused = rec["kernel"] == "flash_attn_bwd"
            entry["seq_parallel_ring_blocks_with_dlse"] = [
                {k: b[k] for k in ("shape", "causal", "kv_mask",
                                   "backward_route", "bwd_ms",
                                   "bwd_plain_ms", "bwd_bound_ms",
                                   "bwd_bound_by", "errs")}
                for b in sp_blocks
                if b["backward_route"].startswith("fused") == fused]
        if rec["kernel"] in ("packed_scale", "packed_nonfinite"):
            cases = surface["k6" if rec["kernel"] == "packed_scale"
                            else "k15"]
            entry["amp_surface_cases"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by")} for r in cases]
        if rec.get("library_null_reason"):
            entry["library_null_reason"] = rec["library_null_reason"]
        summary.append(entry)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
