#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure ends the run with a non-zero exit and no
result line. Phases 7-11, 13 (b) and 17 (a)-(b) run the flagship's
earlier paths (and bench's 0.95B point and the MoE decoder) at their full
width and ``EARLIER_DEPTH`` = 4 layers: their launch counts are per layer
of that depth, their rates and peak memory are not those of the whole
model, and their labels say "4 of 16 layers" (24 for the 0.95B point).
Phases 4, 12, 14-16, 17 (c) and 19 run all 16; phase 18 runs ResNet-50
and the MNIST MLP whole:

1. the device: a CUDA card must be present; prints ``nvidia-smi``'s name
   and power limit; TF32 off, so the f32 checks are full f32;
2. the build: compiles the three flash kernels and the convfuse apply
   kernel from ``tony_tpu_torch/csrc`` (one ``nvcc`` each, all at once) and
   prints the seconds it took and each kernel's registers and spills; the
   bf16 (wgmma) instantiations of the three flash kernels (four of the
   forward, two each of dq and dk/dv) must report 0 spill bytes;
3. each kernel against its plain PyTorch version on the same inputs (made
   with a seeded numpy generator): the flagship attention shape (B=4,
   S=2048, H=8, Hkv=4, D=128, bf16, causal; o, lse, dq, dk and dv must
   also be bitwise equal across two runs), the Llama-3-8B attention shape
   of ``TransformerConfig.llama3_8b`` at batch 1 (S=2048, H=32, Hkv=8,
   D=128, bf16, causal), ragged cases (S=1000: non-causal and causal GQA
   bf16 at D=64, causal bf16 at D=128), a microbatch of the pipelined
   flagship (phase 13: B=1, S=2048, H=8, Hkv=4, D=128, bf16, causal) and
   small f32 cases, then
   ``flash_attention_with_lse(out_dtype=f32)`` with its lse cotangent,
   kernels against plain versions on the card, at D=64 (S=256), D=128
   (S=1000) and the ring's hops of phase 11 (causal B4 S2048, full B4 S512
   and full B1 S8192, all H8/4 D128) (every bf16
   forward case holds lse in the mean as well as at its maximum, which
   catches a row sum over the wrong P below head_dim 128); times each kernel,
   its plain version and ``scaled_dot_product_attention`` (the library
   yardstick, used nowhere in the port) at the flagship and Llama-3-8B
   shapes with CUDA events; then the convfuse apply kernel against its
   plain version on
   ResNet-50's stem shape ([256, 12544, 64] bf16, relu), its stage-3 shape
   ([256, 49, 2048] bf16, no relu: ragged rows, widest C), channel counts
   that take the scalar path and small f32 cases, timed at the stem shape
   beside ``F.group_norm`` + ``relu`` and the port's whole
   ``fused_groupnorm_relu``; then a small f32 decoder's and a small f32
   ResNet's loss and gradients on the card against the same weights on the
   CPU;
4. the main path: ``tony_tpu_torch.trainer.measure`` trains the flagship
   decoder (16 layers, dim 1024, seq 2048, batch 4) for 10 steps through
   the kernels; every loss must be finite, the first within 0.5 of
   ln(32000) + 0.5 (the logits of the lecun-initialised head have unit
   variance at init, which adds about 1/2 to ln(vocab)), and each kernel's
   launch count must be 16 per step;
5. where a flagship step's device time goes (torch.profiler, kernel time
   by kind and the device's idle share), for the record only;
6. the second path: ``trainer.measure_vision`` trains ResNet-50 (224²
   images, widths 64-2048, 16 bottlenecks, batch 256, SGD 0.1/0.9) for 10
   steps through the convfuse kernel; every loss must be finite and the
   kernel's launch count 53 per step (the stem, 3 norms in each of 16
   bottlenecks and the 4 projections); then the MNIST MLP (batch 4096, 20
   steps, no kernel) must give finite losses; then where a ResNet step's
   device time goes;
7. the training job's own loop at the flagship's width: (a)
   ``trainer.measure_token_file`` trains 10 steps from a 4,000,000-token
   uint16 corpus through the prefetching iterator (prefetch 2, then 0), one
   launch of each flash kernel per layer and step, its tokens/s beside
   phase 4's (16 layers), and the iterator's first 3 batches equal
   ``TokenFileDataset.load_local`` byte for byte; (b) a one-rank NCCL
   group: accumulation 2 with 32 MiB buckets, the first batch's accumulated
   gradients within 1e-2 (relative Frobenius) of one full-batch step's,
   then 4 steps of ``train_step_accum`` with two launches of each flash
   kernel per layer and optimizer step and a ``comms`` phase booked on
   each; (c) ``trainer.train`` for 6 steps with async checkpoints every 2
   steps (``max_to_keep`` 2, the last step forced), no async error, the
   newest verified step 5 restored into a fresh state bit for bit
   (parameters and Adam moments), and the resume's steps 6-7 within 1e-3 of
   an uninterrupted 8-step run's losses; it prints the checkpoint's bytes,
   the stall per save, the writer's seconds per save and the restore's
   seconds;
8. long context at the flagship's width: ``trainer.measure`` on bench's
   three long-context points (4 x 8192, chunked cross-entropy, loss chunk
   2048, 12 steps; 1 x 32768, loss chunk 8192, 8 steps; 8 x 8192 with every
   other layer checkpointed, 8 steps) and its 0.95B point (dim 1536, 24
   layers, 4 x 2048, loss chunk 1024, the same remat, AdamW with a bf16
   first moment, 12 steps), each after 2 warm steps: finite losses, the
   first near ln(32000) + 1/2, one launch of each flash kernel per layer
   and step without remat and one more forward per checkpointed layer with
   it; tokens/s, MFU and peak memory printed; where the device time of a 1
   x 32768 step and of a 0.95B step goes. Then the three flash kernels
   against their plain versions at B1 S8192, and timed beside SDPA at B4
   S8192 and B1 S32768;
9. the quantized projections: int8 and fp8 resolve on the card with no
   degrade; quantization on the card equals the CPU's bit for bit, the int8
   library product equals the exact sum and its output the CPU's bit for
   bit, the fp8 product is within 1e-3 of the largest accumulator of the
   f32 sum of the same values, at the flagship's projection shapes (8192
   rows; 1024 -> 1024, 512, 4096; 4096 -> 1024), each timed beside bf16
   ``F.linear``; then the flagship trained at bf16, int8 and fp8, 10 steps
   each, with 7 quantized products per layer of an int8 or fp8 step and one
   launch of each flash kernel per layer;
10. the mesh at world 1, over a one-rank NCCL group and
   ``build_mesh(MeshSpec())`` (every axis 1): (a) ``trainer.measure(...,
   mesh="fsdp=1")`` trains the flagship at full width from
   ``init_sharded_state`` (the tensor-parallel plan at tp=1, then FSDP2:
   every projection, the table and the head are DTensors) with
   ``sharded_train_step``, in alternating turns with the unsharded
   ``trainer.measure`` (unsharded, sharded, unsharded, sharded; tokens/s
   and peak memory of each); every sharded turn's ten losses must equal the
   first unsharded turn's within ``TOL_MESH_REL`` (the largest difference
   printed, with whether they are bit for bit), with one launch of each
   flash kernel per layer and step; (b) two sharded steps, a DCP save of
   the sharded state whose manifest notes the mesh's shape, and a restore
   into a fresh sharded state: parameters and Adam moments bitwise equal,
   no reshard reported; (c) ResNet-50 (batch 256) sharded on the same mesh
   (the tp plan at tp = 1: each conv a DTensor over tp; the head's kernel
   over fsdp; the norms replicated) against the unsharded model, 3 SGD
   steps each: losses within ``TOL_MESH_REL``, 53 convfuse launches per
   sharded step;
11. sequence and expert parallelism at world 1, over a one-rank NCCL group:
   (a) ``trainer.measure`` trains the flagship with ``attn_impl="ring"``
   off any mesh (a ring of one rank), 3 steps against phase 10's first 3
   losses within ``TOL_SP_REL``, one launch of each flash kernel per layer
   and step; then ``trainer.measure(..., mesh="fsdp=1")`` trains it at full
   width with ``attn_impl="ring"`` and then ``"ulysses"`` (the sp group of
   one rank: ring runs its one diagonal hop through the f32-out forward and
   the merge; Ulysses' swaps are the identity), 10 steps each: every loss
   within ``TOL_SP_REL`` of phase 10's sharded flash losses, one launch of
   each flash kernel per layer and step, tokens/s beside phase 10's; (b)
   the ring's own ``schedule``, ``_hop`` and ``_merge`` (``ops/ring.py``)
   driven for four virtual ranks on the card, causal, at B1 S32768 H8/4
   D128 and at the flagship's B4 S2048, forward and backward through
   autograd: the gathered output and dq/dk/dv within phase 3's bf16
   tolerances of whole-sequence ``flash_attention``, each virtual rank's
   forward + backward timed (CUDA events, median) beside whole-sequence
   flash / 4, the flash launches by kind, and at 32k each kernel's time on
   one hop (full and diagonal, f32 out, the lse cotangent folded into
   delta); (c) a small f32 MoE decoder (``MoEConfig.tiny_moe`` at head_dim
   64) on the card against the same weights on the CPU, 3 AdamW steps:
   losses and every parameter within ``TOL_MODEL_REL``; then the MoE
   decoder at the flagship's widths with ``MoEConfig``'s own defaults (8
   experts, top-2, capacity factor 1.25, aux weight 0.01, remat on), batch
   4 x 2048: 10 unsharded steps (first loss within 0.5 of ln(32000) + 0.5;
   tokens/s, step ms, MFU over the active parameters, peak memory, the
   share of token-slots dropped by capacity, the flash launches per step),
   then 3 steps from ``init_sharded_state`` on the world-1 mesh (the
   experts DTensors on ep) against the unsharded run's first 3 within
   ``TOL_MESH_REL``; where a MoE step's device time goes;
12. the orchestrator's job path: ``python -m tony_tpu_torch.cli submit``
   as a subprocess, a one-worker ``pytorch`` job on the local backend whose
   command is ``python -m tony_tpu_torch.trainer --model flagship --steps
   10`` on the card: (a) a cold job: the CLI exits 0 and the history says
   SUCCEEDED, the worker's JSON line parses with finite losses and 16
   launches of each flash kernel per step, its tokens/s printed beside
   phase 4's, ``client.submit`` and ``executor.first_step`` present and
   every span closed, ``submit_to_first_step_s`` printed with
   ``tracing.cold_start_breakdown``'s phases (which must sum to it), the
   monitor's peak device memory (``MAX_TPU_HBM_BYTES`` of the
   TASK_FINISHED event) above 0 and below the card's memory, and the
   command lines of the coordinator and the executor (read from /proc
   while the job runs) naming ``tony_tpu_torch`` and no module of the
   reference; (b) the same job again (warm), its ``submit_to_first_step_s``
   and phases beside (a)'s, each job's ``user_boot`` split into the
   interpreter's boot, the imports, the set-up and the first step (from
   the trainer's start-up wall times), and the seconds a fresh interpreter
   takes to import torch and the trainer module; (d) the same job against
   a warm executor pool (``python -m tony_tpu_torch.cli pool start --size
   1``, the default ``torch`` preload, then ``--conf tony.pool.dir``): a
   ``pool.lease`` span without error and the executor's register span
   ``adopted``, the adopted worker the one that was warm, no pool worker
   among ``nvidia-smi``'s compute processes while warm or during the job,
   its ``submit_to_first_step_s`` and phases beside (a)'s and (b)'s, and
   after ``pool stop`` no process of the pool alive; (c) a worker that
   exits 1: the CLI exits non-zero, the job ends FAILED with a diagnosis
   report;
13. GPipe (``parallel/pipeline.py``): (a) a small f32 pipelined decoder (4
   layers, head_dim 64, M=2) on the card against the same weights on the
   CPU, 3 AdamW steps: the losses and the first step's gradients within
   ``TOL_MODEL_REL``, the elements whose gradient differs in sign between
   card and CPU at some step counted (at most ``TOL_SIGN_SHARE`` of them:
   AdamW parts such an element by about 2·lr) and every parameter within
   ``TOL_MODEL_REL`` outside them, 8 launches of each flash kernel per
   step; (b) the pipelined flagship at full width and ``EARLIER_DEPTH``
   (dim 1024, 4 x 2048, its f32 final norm and f32 head) on a world-1 NCCL
   mesh (pp=1), ``trainer.measure(..., mesh="pp=1",
   model=partial(PipelineTransformer, num_microbatches=M))`` at M=1 and
   M=4, 10 AdamW steps each: finite losses, the first within 0.5 of
   ln(32000) + 0.5, 4·M launches of each flash kernel per step, M=1 and
   M=4 within ``TOL_PIPE_M_REL``, tokens/s, step ms, MFU and peak memory,
   the head's f32 FLOPs printed; then one state for both M: the first
   step's gradients at M=4 against M=1 within ``TOL_ACCUM_REL``, and where
   a step's device time goes at each M; (c)
   four virtual stages of four layers: one stage's tick (forward +
   backward on a B1 S2048 microbatch), the schedule's (M + S - 1) ticks at
   M=4 against the whole 16-layer stack's forward + backward on B4 / 4, and
   the measured bubble against (S - 1) / (M + S - 1) = 3/7, each timed by
   CUDA events (the host's launches included) and by the device's kernel
   time (torch.profiler);
14. surviving failures, the flagship at full width and depth trained by
   ``python -m tony_tpu_torch.trainer --data <corpus> --steps 300`` (the
   corpus ``trainer.write_corpus`` makes) as a one-worker ``pytorch`` job,
   against an uninterrupted in-process ``trainer.train`` of 300 steps on
   the same corpus and seed: (a) the job's coordinator (``python -m
   tony_tpu_torch.coordinator``) is SIGKILLed after the first step and
   ``python -m tony_tpu_torch.cli recover`` brings it home (a job of 150
   steps): recover exits 0, the job SUCCEEDED in one journal epoch, the
   worker's process the same across the outage, 150 finite losses with
   16 launches of each
   flash kernel per step (no step ran twice), the first 20 within
   ``TOL_RESUME_REL`` of the uninterrupted run's; the outage (SIGKILL to
   the worker's re-registration) and recover's wall time printed; (b) a
   job of 350 steps submitted with ``tony.elastic.enabled=true``, a save
   interval above its steps and its checkpoints on ``gs://`` (phase 19's
   store, see there), moved by ``python -m
   tony_tpu_torch.cli migrate <app> slice-1`` after step 5 (and its first
   step's save): the CLI exits 0, the journal holds REC_MIGRATE ``start``
   and ``applied`` in its one epoch, the drained trainer's SIGTERM save
   holds step k and the relaunched one restores it and starts at k + 1 (0
   steps re-run) with 16 launches of each flash kernel per step it runs
   and losses within ``TOL_RESUME_REL`` of the uninterrupted run's same
   steps, the store holding the first, the drain's and the last step and
   nothing of it on local disk; the drain save's bytes and seconds
   (beside the drain grace),
   the restore's seconds and the migration's wall time (the request to
   the relaunched worker's re-registration) printed. On one machine the
   destination is the same card: this measures drain, save, relaunch and
   restore, no transfer between hosts; (c) ``python -m
   tony_tpu_torch.cli check`` exits 0 on both job dirs;
15. the GPU host backend and the fleet, the flagship at full width and
   depth: (a) ``python -m tony_tpu_torch.cli submit`` with
   ``tony.application.backend=gpu-host``, the fake provisioner and one
   host, the trainer for 10 steps as the worker command: the job
   SUCCEEDED, its task ran under ``<workdir>/fakehost-0/`` with
   ``TONY_HOST_ID`` and ``TONY_HOST_LOCAL_ORDINAL`` set, no
   ``TPU_WORKER_*`` and the caller's ``CUDA_VISIBLE_DEVICES``, 16 launches
   of each flash kernel per step, ``cli check`` clean on its job dir; its
   ``submit_to_first_step_s`` and phases printed beside phase 12's cold
   local-backend job's, its tokens/s beside phase 4's; (b) ``cli pool
   start --size 1``, then ``cli fleet start --slices 2 --hosts-per-slice
   1`` on that pool, and ``cli fleet submit`` of phase 14 (b)'s elastic
   job (the same corpus and seed, ``--ckpt-dir``, 150 steps); past step 20
   ``cli fleet migrate <job> 1``: the job FINISHED in one epoch with
   REC_MIGRATE ``start`` and ``applied``, 0 steps re-run, 16 launches of
   each flash kernel per step, losses within ``TOL_RESUME_REL`` of phase
   14's uninterrupted run's same steps, ``cli check`` clean on the fleet
   dir (the fleet rules, ``fleet-sim-parity`` included), and after ``fleet
   stop`` and ``pool stop`` neither daemon alive; the queue wait, the
   grant to the first step, the migration's wall time, the drain save's
   bytes and seconds, the ledger's goodput and chip-seconds for the job
   and one ``fleet top`` frame printed. The two "slices" share the one
   card: the move measures drain, save, relaunch and restore;
16. a live flagship job observed: ``python -m tony_tpu_torch.cli submit``
   of the trainer (16 layers, 4 x 2048, ``OBS_STEPS`` steps) as a
   one-worker job on the local backend, and ``cli portal`` serving its
   history root from a subprocess on a free port. While it runs: ``cli top
   <app> --once`` exits 0 and its task row's MFU is within ``TOL_OBS_MFU``
   (relative) of the MFU (against 989 TFLOP/s) that ``python -m
   tony_tpu_torch.trainer --model flagship`` reports when run alone just
   before the job is submitted, its
   device memory in use above 0 and at most the card's; ``cli profile
   <app> --steps 3`` exits 0 and prints ``captured:``, the capture lies
   under ``<history>/intermediate/<app>/profile/ondemand-*``, and its
   Chrome trace holds 16 CUDA kernel events of each flash kernel per
   captured step (by the kernels' function names, ``flagship_kind``); the
   worker's user process is the same, alive, after it; ``cli alerts
   <app>`` exits 0 and prints the live rows (a rule firing on this healthy
   job is printed, not hidden); the portal answers 200 on ``/``,
   ``/jobs/<app>``, ``/profile/<app>`` (which lists the capture) and
   ``/metrics`` (Prometheus text with the job's series). After it: the
   job SUCCEEDED in one epoch with ``TASK_PROFILED`` (captured) in its
   history, the trainer's counters say 16 launches of each flash kernel
   per step, ``/trace/<app>?format=json`` answers 200, ``cli check`` is
   clean on the job dir, and the portal's process is gone once stopped.
   Printed: the capture's wall time (request to ``captured:``), the
   steps' host seconds inside the capture against outside it, the trace's
   size and the ``top`` frame;
17. the decoders' mesh layouts at world 1, over a one-rank NCCL group and
   ``build_mesh(MeshSpec())`` (the tensor-parallel plan at tp = 1, FSDP2
   at 1): (a) the int8 and the fp8 flagship (``EARLIER_DEPTH`` layers,
   dim 1024, 4 x 2048) trained by ``trainer.measure(..., mesh="fsdp=1")``
   in alternating
   turns with the same mode unsharded (unsharded, sharded, unsharded,
   sharded; ``QMESH_STEPS`` steps after 2 warm ones each): every sharded
   turn's losses within ``TOL_QMESH_REL`` of the first unsharded turn's
   (the largest difference printed, with whether they are bit for bit),
   7 x 4 quantized products and 4 launches of each flash kernel per step
   in every turn, no entry in ``quant.fallback_events()``; tokens/s, step
   ms and peak memory of each turn and the sharded / unsharded ratio of
   tokens/s; then ``python -m tony_tpu_torch.trainer --matmul-dtype int8
   --mesh fsdp=1 --steps 3`` as a subprocess: exit 0, finite losses, 7 x
   16 quantized products and 16 launches of each flash kernel per step,
   no fallback; (b) the flagship with ``tie_embeddings=True`` on the same
   mesh against the tied flagship unsharded, with the same checks (no
   quantized product); (c) the MoE decoder at the flagship's widths
   (``moe_flagship_config``: 8 experts, top-2, remat on) at all 16 layers
   from ``init_sharded_state`` with its stacked experts DTensors on the
   mesh's ``(ep, tp)``, 3 AdamW steps against 3 unsharded steps of the
   same weights and batches within ``TOL_MESH_REL``, the flash launches of
   a remat step (32 forward, 16 dq, 16 dk/dv) per step, its ms per step
   beside phase 11 (c)'s world-1 run of 4 layers. Each line carries the
   card's name and power limit;
18. the vision models' mesh layouts at world 1, over a one-rank NCCL group
   and ``build_mesh(MeshSpec())``: (a) ResNet-50 (batch 256, 224²) from
   ``trainer.build_vision_state(..., mesh=)`` under the tp plan at tp = 1
   (each conv's weight a DTensor ``Shard(0)`` on tp, its input gathered
   over a group of one, each norm on its channel shard) in alternating
   turns with the unsharded model (unsharded, sharded, unsharded, sharded;
   3 SGD steps each on the same batches): every sharded turn's losses
   within ``TOL_MESH_REL`` of the first unsharded turn's (the largest
   difference printed, with whether they are bit for bit), 53 convfuse
   launches per step in every turn; samples/s and ms per step (steps 2-3)
   and peak memory of each turn and the sharded / unsharded ratio; (b) the MNIST MLP (hidden 128, batch 4096) the same
   way, colwise, rowwise, colwise at tp = 1 with no kernel launched; then
   ``python -m tony_tpu_torch.trainer --model resnet50 --mesh fsdp=1
   --steps 3`` as a subprocess: exit 0, finite losses, 53 convfuse
   launches per step; (c) the convfuse kernel against its plain version
   at one tp rank's channel shard of ResNet-50's stem, stage-1 and
   stage-3 norms at tp = 2, 4 and 8 (``[256, 12544, 32]`` down to ``[256,
   49, 256]``, bf16, relu) and of the stem at tp = 16 (C = 4: the scalar
   path), each within phase 6's tolerance;
19. checkpoints through the port's object store, ``gs://`` on
   ``FakeGcsStore`` (``TONY_FAKE_GCS_ROOT`` a temporary root, set only in
   this process's environment): (a) ``trainer.train`` of the flagship at
   full width and depth (16 layers, 4 x 2048), one step (saved,
   ``max_to_keep`` 1) with ``ckpt_dir="gs://tony-ckpt/flagship"``, then
   the same with a local directory: no async error, 16 launches of each
   flash kernel per step, nothing written under the
   working directory; each newest step restored into a fresh state bit for
   bit with the trained one (parameters and Adam moments), and the store's
   step bit for bit with the local one; the writer's seconds per step, the
   restore's seconds and the step's bytes printed for both; (b) phase 14
   (b)'s migration is the store's: its job runs 50 steps longer than the
   uninterrupted run (the store's first save is slower), with
   ``tony.application.checkpoint-dir=gs://tony-ckpt/migrate`` and no
   ``--ckpt-dir`` in the command (the trainer reads
   ``$TONY_CHECKPOINT_DIR``; the store's root reaches it from the
   submitting CLI's environment through the client, the coordinator and
   the executor), and its drain save's seconds are printed here beside
   phase 15 (b)'s drain save of the same state to local disk;
20. tensor-parallel layouts under other logical rules tables at world 1,
   over a one-rank NCCL group and ``build_mesh(MeshSpec())``: the flagship
   at full width and 4 layers (4 x 2048, bf16) under T1 (kv heads whole),
   T2 (``embed`` over tp first: every projection the other way round),
   T3 (the table's embed dim over tp) and T4 (the head's embed dim over
   ``(fsdp, tp)``), the int8 flagship under T2, the tied flagship under
   T3 and the MNIST MLP (batch 4096) under T2, each from
   ``init_sharded_state(..., rules=)`` beside its unsharded twin, 3 steps
   each on the same batches: the table's layout in the placements, losses
   within ``TOL_MESH_REL`` of the twin's (and whether bit for bit), 4
   launches of each flash kernel per step, 28 quantized products per
   step for int8, no fallback, and the sharded / unsharded tokens/s
   (samples/s for the MLP) with the card's name and power limit. At
   tp = 1 no collective runs; ``tests/test_torch_rules.py`` meets the
   tables at tp > 1 on the CPU;
21. the Llama-3-8B example (``examples/llama3-8b/train_llama3.py``) at
   its full width (dim 4096, 32/8 heads, mlp 14336, vocab 128,256) and
   ``LLAMA_DEPTH`` = 2 of its 32 layers: (a) ``trainer.measure`` at B8
   S8192 with the chunked loss (chunk 2048) and AdamW(3e-4, weight decay
   0.1), f32 parameters and bf16 activations, under remat off, full remat
   and the ``dots_with_no_batch_dims_saveable`` and ``dots_saveable``
   policies, 2 warm and 3 timed steps each (a setting that does not fit
   in the card's memory at B8 runs at the largest of B4, B2 that does,
   the cut printed), and full remat again at B4, so that each setting has
   a full-remat twin at its own batch: finite losses, the first near
   ln(vocab) + 1/2, launches per step of the forward 2·L under full
   remat and both policies and L with remat off, of dq and dk/dv L;
   tokens/s, ms per step, MFU and ``peak_memory_bytes`` of each, and each
   against full remat; (b) ``python -m tony_tpu_torch.trainer --model
   llama3_8b --data <corpus> --steps 3`` (``trainer.main`` in this
   process, the depth cut
   through ``LM_POINTS``) on a uint32 token file of Llama-3's vocabulary,
   no checkpoint: exit 0, the example's chunk, weight decay and policy and
   uint32 ids in its JSON, finite losses, the same launches; (c) phase 11
   (c)'s MoE decoder at 4 layers under the no-batch policy against full
   remat, 2 warm and 3 timed steps each: ms per step and peak memory; (d)
   a small f32 decoder (head_dim 64) under None and each of the six
   policy names: on the card, its loss and gradients against full
   remat's and against the CPU's within ``TOL_MODEL_REL`` (and whether bit
   for bit); (e) the three flash kernels against their plain versions at
   the path's head layout, B1 S8192 H32/8 D128 bf16 causal, then timed
   beside SDPA as in phase 3;
22. prints the whole run's seconds, the kernels' JSON line (each flash
   kernel with its launches per step on the pipelined flagship), then the
   result line.

It imports nothing of JAX and nothing of ``tony_tpu``.
"""

import collections
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np
import torch

# Tolerances of phase 3 (kernel against plain version on the same inputs).
# bf16: o is rounded to bf16 by both (one ulp near 1 is 2**-8); lse is f32
# in both; a gradient's relative Frobenius error allows the bf16 rounding of
# ds/p falling on the other side of a tie for a few elements.
TOL_BF16_O = 2e-2
TOL_BF16_LSE = 1e-3
# The mean absolute lse error of a bf16 forward against its plain version
# (both over 128-key tiles): the row sum below head_dim 128 adds the bf16 P,
# and a kernel adding the f32 P there is off by ~1e-4 in the mean, while
# exp2's last-bit noise leaves the maximum near 5e-4 but the mean far lower.
TOL_BF16_LSE_MEAN = 2e-5
TOL_BF16_GRAD_REL = 2e-2
TOL_F32 = 1e-4            # f32 case: o, lse, dq, dk, dv (absolute)
TOL_MODEL_REL = 1e-4      # f32 decoder and ResNet on the card vs the CPU
# Convfuse apply against its plain version: bf16 within one bf16 ulp of the
# plain result (8 significant bits: |err| <= 2**-7 * |y|; the kernel rounds
# x*a and +b separately, as torch does, so it should agree bit for bit);
# f32 within 1e-6 * max|y|.
TOL_CF_BF16_ULP = 2.0 ** -7
TOL_CF_F32 = 1e-6
# The training job: accumulation 2 against one full-batch step, relative
# Frobenius error of all gradients together (bf16 activations: the two
# microbatches' matmuls and the loss's mean round differently); the resumed
# run's losses against the uninterrupted run's, relative.
TOL_ACCUM_REL = 1e-2
TOL_RESUME_REL = 1e-3
# The sharded flagship at world 1 against the unsharded one, relative
# per loss. Every collective of a one-rank mesh is a copy, and the DTensor
# projections run the same matmuls on the same local tensors, so the losses
# should agree bit for bit; the limit allows a different but equally exact
# reduction order in a library kernel, not a different computation.
TOL_MESH_REL = 1e-5
# Phase 11 (a): the flagship with ring attention on a one-rank sp group
# against phase 10's sharded flash run, relative per loss. The forward is
# the same once rounded to bf16 (one diagonal hop; the merge with the empty
# state multiplies by exp(0) = 1), but the backward's delta reads the
# unrounded f32 o where flash reads the bf16 o, so the gradients differ in
# their last bits and ten AdamW steps carry that into the losses, as far
# as a bf16 run's reruns do (phase 7's resume is held to the same limit).
TOL_SP_REL = 1e-3
# Phase 13 (a): the share of the small pipelined decoder's elements whose
# gradient differs in sign between card and CPU at one of 3 AdamW steps,
# left out of its parameter comparison. The H100 read 261 of 2,623,744
# (1.0e-4); the limit is ten times that, so the comparison still holds
# 99.9 % of the elements.
TOL_SIGN_SHARE = 1e-3
# Phase 13 (b): the pipelined flagship at M=1 against M=4, relative per
# loss over ten AdamW steps. M=4 computes each weight's gradient as four
# bf16 products (one per microbatch) summed in f32 where M=1 rounds one
# product over the whole batch; every run on the H100 read 6.555e-05, and
# the limit is about 15 times that. On random tokens the loss barely
# depends on the data, so the first step's gradients at M=1 and M=4 on the
# same weights and batch are held by relative Frobenius error to
# ``TOL_ACCUM_REL``, phase 7's limit for the same split of one batch (a
# microbatch dropped or repeated moves them by tens of percent).
TOL_PIPE_M_REL = 1e-3
# Phase 17 (a), (b): the quantized and the tied flagship on the world-1
# mesh against the same mode unsharded, relative per loss. The plan at
# tp = 1 runs the same products on the same local tensors (the quantized
# ones through the same library calls, the amax reductions over one rank
# copies), so the losses should agree bit for bit, as phase 10's do; the
# limit is phase 7's for reruns of a bf16 run, so that a library kernel
# choosing another reduction order for a view of the same tensor (or a
# quantization level that such a change moves) fails nothing that is right.
TOL_QMESH_REL = 1e-3
QMESH_STEPS = 8
# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core
# FLOP/s, HBM3 bytes/s and f32 FLOP/s outside the tensor cores.
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz boost clock
STEPS = 10
PROFILE_STEPS = 3
# Phases 7-11 drive their paths at the flagship's full width and this
# depth (its layers; the 0.95B point's too), so that the script stays near
# 400 s with phases 12 (d) and 13 in it; phase 13 (b)'s pipelined flagship
# and phase 17 (a)-(b)'s turns too since phase 19, which keeps the script
# inside its time limit. Phase 4 (the main path) and the submitted jobs
# keep all 16 layers.
EARLIER_DEPTH = 4
RESNET_BATCH = 256
# The stem, three norms in each of 16 bottlenecks, four projections.
RESNET_LAUNCHES_PER_STEP = 53
MNIST_BATCH, MNIST_STEPS = 4096, 20
AB_STEPS = 20           # timed steps per run of the training job's part (a)


def earlier(cfg):
    """``cfg`` at ``EARLIER_DEPTH`` layers."""
    return dataclasses.replace(cfg, n_layers=EARLIER_DEPTH)


def cut_label(label, cfg):
    """``label`` of a point that runs ``earlier(cfg)``, saying so."""
    return f"{label} ({EARLIER_DEPTH} of {cfg.n_layers} layers)"


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warm=3):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events. The
    card first spins for about 20 ms while the host queues the runs, so a
    host slower than a short kernel does not add its launch time to it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi[0]


def phase_build():
    from tony_tpu_torch.ops import _build, _convfuse_cuda, _flash_cuda

    t0 = time.perf_counter()
    specs = {**_flash_cuda.SPECS, **_convfuse_cuda.SPECS}
    info = _build.build(specs)
    log(f"build: {time.perf_counter() - t0:.1f} s into {info['dir']}")
    # Registers and spills of every kernel (each source's ``ptxas -v`` log in
    # the build directory). The bf16 flash kernels hold their accumulators
    # in registers: a spill there fails the run. The forward has four bf16
    # instantiations (head_dim 64/128 x o in bf16/f32), dq and dk/dv two.
    wgmma_kernels = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    for name in specs:
        with open(os.path.join(info["dir"], f"{name}.log")) as f:
            text = f.read()
        report = ptxas_report(text)
        for fn, regs, stores, loads in report:
            log(f"  {name}: {fn}: {regs} registers, {stores} bytes spill "
                f"stores, {loads} bytes spill loads")
        for line in text.splitlines():
            if "serialized" in line:
                log(f"  {name}: {line.strip()}")
        if name in wgmma_kernels:
            bf16 = [r for r in report if "wgmma" in r[0]]
            check(len(bf16) == wgmma_kernels[name],
                  f"{name}: {len(bf16)} ptxas reports of its bf16 kernels, "
                  f"expected {wgmma_kernels[name]}")
            for fn, _, stores, loads in bf16:
                check(stores == 0 and loads == 0, f"{fn} spills registers")


def ptxas_report(text):
    """(entry function, registers, spill store bytes, spill load bytes) for
    each entry function of a ``ptxas -v`` log."""
    out, fn, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), *spills))
            fn = None
    return out


def make_case(b, s, h, hk, d, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to("cuda", dtype)
    return t(b, s, h, d), t(b, s, hk, d), t(b, s, hk, d), t(b, s, h, d)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_case(name, b, s, h, hk, d, dtype, causal, seed, timed=False,
               deterministic=False):
    """Kernel against plain version for fwd, dq and dk/dv on one case;
    with ``deterministic``, dq, dk and dv must come out bitwise equal from a
    second run."""
    from tony_tpu_torch.ops import _flash_cuda as K
    from tony_tpu_torch.ops import attention as A

    q, k, v, do = make_case(b, s, h, hk, d, dtype, seed)
    scale = d ** -0.5
    o, lse = K.flash_fwd(q, k, v, scale, causal)
    o_p, lse_p = A.flash_fwd_plain(q, k, v, scale, causal, block_q=128,
                                   block_k=128)
    # The backward kernels and their plain versions get identical inputs.
    delta = (o_p.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = K.flash_bwd_dq(q, k, v, do, lse_p, delta, scale, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, scale, causal)
    dq_p = A.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, scale, causal,
                                128, 128)
    dk_p, dv_p = A.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scale,
                                       causal, 128, 128)
    torch.cuda.synchronize()
    errs = {"o": max_err(o, o_p), "lse": max_err(lse, lse_p),
            "dq": max_err(dq, dq_p), "dk": max_err(dk, dk_p),
            "dv": max_err(dv, dv_p)}
    lse_mean = (lse - lse_p).abs().mean().item()
    rels ={n: rel_err(x, y) for n, x, y in
            (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
    for n, x in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                 ("dv", dv)):
        check(bool(torch.isfinite(x).all()), f"{name}: {n} not finite")
    log(f"{name}: max abs err {json.dumps(errs)} lse mean abs err "
        f"{lse_mean:.3e} grad rel err {json.dumps(rels)}")
    if dtype == torch.float32:
        for n, e in errs.items():
            check(e <= TOL_F32, f"{name}: {n} err {e} > {TOL_F32}")
    else:
        check(errs["o"] <= TOL_BF16_O, f"{name}: o err {errs['o']}")
        check(errs["lse"] <= TOL_BF16_LSE, f"{name}: lse err {errs['lse']}")
        check(lse_mean <= TOL_BF16_LSE_MEAN,
              f"{name}: lse mean abs err {lse_mean}")
        for n, e in rels.items():
            check(e <= TOL_BF16_GRAD_REL, f"{name}: {n} rel err {e}")
    if deterministic:
        o2, lse2 = K.flash_fwd(q, k, v, scale, causal)
        dq2 = K.flash_bwd_dq(q, k, v, do, lse_p, delta, scale, causal)
        dk2, dv2 = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, scale, causal)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in
                   ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)))
        log(f"{name}: o, lse, dq, dk, dv bitwise equal across two runs: "
            f"{same}")
        check(same, f"{name}: the flash kernels are not deterministic")
    if not timed:
        return None

    res = time_flash(name, q, k, v, do, lse_p, delta, causal, o)
    res["flash_fwd"].update(
        plain_ms=cuda_ms(lambda: A.flash_fwd_plain(
            q, k, v, scale, causal, block_q=128, block_k=128)),
        max_abs_err=max(errs["o"], errs["lse"]))
    res["flash_bwd_dq"].update(
        plain_ms=cuda_ms(lambda: A.flash_bwd_dq_plain(
            q, k, v, do, lse_p, delta, scale, causal, 128, 128)),
        max_abs_err=errs["dq"])
    res["flash_bwd_dkv"].update(
        plain_ms=cuda_ms(lambda: A.flash_bwd_dkv_plain(
            q, k, v, do, lse_p, delta, scale, causal, 128, 128)),
        max_abs_err=max(errs["dk"], errs["dv"]))
    log(f"timing ({name}): " + json.dumps(res))
    return res


def time_flash(name, q, k, v, do, lse, delta, causal, o):
    """Each flash kernel's ms by CUDA events, its TFLOP/s and bound, and
    ``scaled_dot_product_attention``'s forward and backward (the library
    yardstick, used nowhere in the port; its output is held against ``o``,
    the forward kernel's or the plain version's)."""
    from tony_tpu_torch.ops import _flash_cuda as K

    b, s, h, d = q.shape
    scale = d ** -0.5
    res = {
        "flash_fwd": dict(ms=cuda_ms(lambda: K.flash_fwd(q, k, v, scale,
                                                         causal))),
        "flash_bwd_dq": dict(ms=cuda_ms(lambda: K.flash_bwd_dq(
            q, k, v, do, lse, delta, scale, causal))),
        "flash_bwd_dkv": dict(ms=cuda_ms(lambda: K.flash_bwd_dkv(
            q, k, v, do, lse, delta, scale, causal))),
    }

    # Library yardstick: SDPA on [B,H,S,D] views, GQA by index.
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    res["flash_fwd"]["library_ms"] = cuda_ms(sdpa)
    out = sdpa()
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    check(max_err(out.transpose(1, 2), o) <= TOL_BF16_O,
          f"{name}: SDPA disagrees with the forward kernel")
    # SDPA's backward computes dq, dk and dv in one call: the yardstick of
    # the pair, given to both backward kernels.
    res["flash_bwd_dq"]["library_ms"] = sdpa_bwd_ms
    res["flash_bwd_dkv"]["library_ms"] = sdpa_bwd_ms

    # Bounds: the larger of FLOPs over the bf16 peak and bytes over HBM.
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    el = q.element_size()
    qb, kb, sb = q.numel() * el, k.numel() * el, b * h * s * 4
    work = {"flash_fwd": (4 * d * pairs, qb + 2 * kb + qb + sb),
            "flash_bwd_dq": (6 * d * pairs, 2 * qb + 2 * kb + 2 * sb + qb),
            "flash_bwd_dkv": (8 * d * pairs,
                              2 * qb + 2 * kb + 2 * sb + 2 * kb)}
    for n, (flops, nbytes) in work.items():
        tf, tb = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
        res[n].update(bound_ms=max(tf, tb),
                      bound_by="operations" if tf >= tb else "bytes",
                      tflops=flops / res[n]["ms"] / 1e9)
    log(f"sdpa backward ({name}; dq, dk and dv in one call): "
        f"{sdpa_bwd_ms:.4f} ms vs dq + dk/dv kernels "
        f"{res['flash_bwd_dq']['ms'] + res['flash_bwd_dkv']['ms']:.4f} ms")
    return res


def check_with_lse(name, b, s, h, hk, d, seed, causal=True):
    """``flash_attention_with_lse`` with ``out_dtype=f32`` through autograd,
    with o's cotangent and a non-zero lse cotangent (a ring hop's call),
    the kernels against their plain versions on the card on the same bf16
    inputs: the plain forward, then the plain backward with the delta
    ``_Flash.backward`` folds the lse cotangent into (rowsum(o·do) − dlse,
    from the plain forward's o and lse). The plain versions run over
    128-key tiles, as the kernels do, so that the bf16 P of the row sum
    below head_dim 128 is rounded alike on both."""
    from tony_tpu_torch.ops import attention as A

    q, k, v, do = make_case(b, s, h, hk, d, torch.bfloat16, seed)
    scale = d ** -0.5
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o, lse = A.flash_attention_with_lse(*leaves, causal=causal, block_q=128,
                                        block_k=128, out_dtype=torch.float32)
    # d sin(lse) / d lse = cos(lse): the lse cotangent.
    loss = (o * do.float()).sum() + torch.sin(lse).sum()
    grads = torch.autograd.grad(loss, leaves)
    o_p, lse_p = A.flash_fwd_plain(q, k, v, scale, causal, torch.float32,
                                   128, 128)
    delta = ((o_p * do.float()).sum(-1).transpose(1, 2)
             - torch.cos(lse_p)).contiguous()
    dq_p = A.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, scale, causal,
                                128, 128)
    dk_p, dv_p = A.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scale,
                                       causal, 128, 128)
    torch.cuda.synchronize()
    check(o.dtype == torch.float32, "out_dtype f32 not honoured")
    lse = lse.transpose(1, 2)                    # [B,S,H] → the plain's
    got, want = (o, lse, *grads), (o_p, lse_p, dq_p, dk_p, dv_p)
    for n, x in zip(("o", "lse", "dq", "dk", "dv"), got):
        check(bool(torch.isfinite(x).all()), f"with_lse {name}: {n} not "
              f"finite")
    errs = {n: rel_err(x, y) for n, x, y in
            zip(("o", "lse", "dq", "dk", "dv"), got, want)}
    lse_mean = (lse - lse_p).abs().mean().item()
    log(f"with_lse {name} bf16 -> f32 out, lse cotangent, kernels vs plain "
        f"on the card: rel err {json.dumps(errs)}, lse mean abs err "
        f"{lse_mean:.3e}")
    for n, e in errs.items():
        check(e <= TOL_BF16_GRAD_REL, f"with_lse {name} {n} rel err {e}")
    check(lse_mean <= TOL_BF16_LSE_MEAN,
          f"with_lse {name} lse mean abs err {lse_mean}")


def phase_kernels():
    from tony_tpu_torch.models.transformer import TransformerConfig

    res = check_case("flagship bf16 B4 S2048 H8/4 D128 causal",
                     4, 2048, 8, 4, 128, torch.bfloat16, True, 0,
                     timed=True, deterministic=True)
    llama = TransformerConfig.llama3_8b()
    h, hk = llama.n_heads, llama.n_kv_heads
    d = llama.dim // h
    res_llama = check_case(f"llama3-8b bf16 B1 S2048 H{h}/{hk} D{d} causal",
                           1, 2048, h, hk, d, torch.bfloat16, True, 5,
                           timed=True)
    for name, r in res_llama.items():
        res[name]["llama3_8b"] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops",
            "max_abs_err")}
    check_case("ragged bf16 B2 S1000 H8/2 D64 non-causal",
               2, 1000, 8, 2, 64, torch.bfloat16, False, 1)
    check_case("ragged bf16 B2 S1000 H8/2 D64 causal",
               2, 1000, 8, 2, 64, torch.bfloat16, True, 7)
    check_case("ragged bf16 B1 S1000 H4/4 D128 causal",
               1, 1000, 4, 4, 128, torch.bfloat16, True, 2)
    # A microbatch of the pipelined flagship (phase 13 b at M=4, each
    # virtual stage of 13 c): one row, where dk/dv has 64 CTAs.
    check_case("pipelined microbatch bf16 B1 S2048 H8/4 D128 causal",
               1, 2048, 8, 4, 128, torch.bfloat16, True, 12)
    check_case("f32 B1 S256 H4/2 D64 causal",
               1, 256, 4, 2, 64, torch.float32, True, 3)
    check_case("f32 B1 S200 H2/1 D128 non-causal",
               1, 200, 2, 1, 128, torch.float32, False, 4)
    # The f32-out forward with an lse cotangent (the ring's hops) at both
    # head dims; S = 1000 leaves a ragged tail. Then the ring's own shapes
    # (phase 11): the flagship's one-rank ring (a causal B4 S2048 hop), a
    # full hop of its four virtual ranks (B4, 512 against 512) and a full
    # hop of the 32k ring's (B1, 8192 against 8192).
    check_with_lse("B1 S256 H4/2 D64", 1, 256, 4, 2, 64, 6)
    check_with_lse("ragged B1 S1000 H4/2 D128", 1, 1000, 4, 2, 128, 8)
    check_with_lse("ring hop B4 S2048 H8/4 D128 causal",
                   4, 2048, 8, 4, 128, 9, causal=True)
    check_with_lse("ring hop B4 S512 H8/4 D128 full",
                   4, 512, 8, 4, 128, 10, causal=False)
    check_with_lse("ring hop B1 S8192 H8/4 D128 full",
                   1, 8192, 8, 4, 128, 11, causal=False)
    return res


def phase_small_model():
    """A small f32 decoder (head_dim 64) on the card, through the kernels,
    against the same weights on the CPU, through the plain versions."""
    from tony_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig,
                                                   causal_lm_loss)

    cfg = TransformerConfig.tiny(vocab_size=512, dim=256, n_heads=4,
                                 n_kv_heads=2, mlp_dim=512, max_seq_len=256)
    cpu = Transformer(cfg, device="cpu")
    gpu = Transformer(cfg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 256)))
    losses = []
    for model, tok in ((cpu, tokens), (gpu, tokens.cuda())):
        loss = causal_lm_loss(model(tok), tok)
        loss.backward()
        losses.append(loss.item())
    worst = max(rel_err(g.grad.cpu(), c.grad) for c, g in
                zip(cpu.parameters(), gpu.parameters()))
    log(f"small f32 decoder: loss card {losses[1]:.6f} cpu {losses[0]:.6f}; "
        f"worst grad rel err {worst:.3e}")
    check(abs(losses[0] - losses[1]) <= TOL_MODEL_REL * abs(losses[0]),
          "small decoder loss differs between card and CPU")
    check(worst <= TOL_MODEL_REL, f"small decoder grad rel err {worst}")


def check_convfuse_case(name, shape, dtype, relu, seed, timed=False):
    """The convfuse apply kernel against its plain version on one case."""
    from tony_tpu_torch.ops import _convfuse_cuda as K
    from tony_tpu_torch.ops import convfuse as C

    bsz, rows, c = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        "cuda", dtype)
    # a, b as folded_affine makes them: a ~ scale/std, b ~ bias − mean·a.
    a = torch.from_numpy(1.0 + 0.3 * rng.standard_normal(
        (bsz, c), dtype=np.float32)).cuda()
    b = torch.from_numpy(0.3 * rng.standard_normal(
        (bsz, c), dtype=np.float32)).cuda()
    y = K.apply(x, a, b, relu)
    y_p = C.apply_plain(x, a, b, relu)
    torch.cuda.synchronize()
    check(y.dtype == dtype and y.shape == x.shape, f"{name}: dtype/shape")
    check(bool(torch.isfinite(y).all()), f"{name}: y not finite")
    diff = (y.float() - y_p.float()).abs()
    err = diff.max().item()
    if dtype == torch.bfloat16:
        worst = (diff - TOL_CF_BF16_ULP * y_p.float().abs()).max().item()
        check(worst <= 0, f"{name}: more than one bf16 ulp off (max abs "
              f"err {err})")
    else:
        tol = TOL_CF_F32 * y_p.abs().max().item()
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
    log(f"convfuse {name}: max abs err {err}, exact "
        f"{bool(torch.equal(y, y_p))}")
    if not timed:
        return None

    res = dict(ms=cuda_ms(lambda: K.apply(x, a, b, relu)),
               plain_ms=cuda_ms(lambda: C.apply_plain(x, a, b, relu)),
               max_abs_err=err, library_ms=None)
    # Bound: x read once, y written once, a and b read once; 3 flops an
    # element (mul, add, max) at the f32 non-tensor-core rate.
    nbytes = 2 * x.numel() * x.element_size() + 2 * a.numel() * 4
    tb = nbytes / PEAK_BYTES * 1e3
    tf = 3 * x.numel() / PEAK_F32 * 1e3
    res.update(bound_ms=max(tb, tf),
               bound_by="bytes" if tb >= tf else "operations",
               gbytes_per_s=nbytes / res["ms"] / 1e6)
    # Yardsticks at the same shape: F.group_norm + relu on the NCHW view
    # (channels_last memory) against the port's whole fused_groupnorm_relu
    # (stats sweep + folded affine + the kernel). No single PyTorch call
    # computes the apply alone, so library_ms stays null.
    F = torch.nn.functional
    side = math.isqrt(rows)
    x4 = x.view(bsz, side, side, c)                 # NHWC, square images
    scale = torch.ones(c, device="cuda")
    bias = torch.zeros(c, device="cuda")
    with torch.no_grad():
        res["group_norm_relu_ms"] = cuda_ms(lambda: torch.relu(F.group_norm(
            x4.permute(0, 3, 1, 2), 32, scale.to(dtype), bias.to(dtype),
            eps=1e-6)))
        res["fused_groupnorm_relu_ms"] = cuda_ms(
            lambda: C.fused_groupnorm_relu(x4, scale, bias, groups=32))
    log(f"timing (convfuse {name}): " + json.dumps(res))
    return res


def phase_convfuse():
    res = check_convfuse_case("stem bf16 [256, 12544, 64] relu",
                              (256, 112 * 112, 64), torch.bfloat16, True, 10,
                              timed=True)
    check_convfuse_case("stage-3 bf16 [256, 49, 2048] no relu",
                        (256, 49, 2048), torch.bfloat16, False, 11)
    check_convfuse_case("f32 [2, 81, 12] relu", (2, 81, 12), torch.float32,
                        True, 12)
    check_convfuse_case("f32 [3, 100, 64] no relu", (3, 100, 64),
                        torch.float32, False, 13)
    # Channel counts the 16-byte vector does not divide: the scalar path.
    check_convfuse_case("scalar bf16 [2, 81, 12] relu", (2, 81, 12),
                        torch.bfloat16, True, 14)
    check_convfuse_case("scalar f32 [3, 49, 6] no relu", (3, 49, 6),
                        torch.float32, False, 15)
    return res


def phase_small_resnet():
    """A small f32 ResNet (widths 16-128, groups 4: the kernel's vector
    path) on the card, through the convfuse kernel, against the same
    weights on the CPU, through the plain version."""
    from tony_tpu_torch.models import ResNet, ResNetConfig, classification_loss
    from tony_tpu_torch.ops import _convfuse_cuda

    cfg = ResNetConfig.tiny(width=16, norm_groups=4)
    cpu = ResNet(cfg, device="cpu")
    gpu = ResNet(cfg, device="cuda",
                 generator=torch.Generator("cuda").manual_seed(1))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.standard_normal((2, 32, 32, 3),
                                                  dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, (2,)))
    before = _convfuse_cuda.launch_counts["convfuse_apply"]
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        loss = classification_loss(model(images.to(dev)), labels.to(dev))
        loss.backward()
        losses.append(loss.item())
    launched = _convfuse_cuda.launch_counts["convfuse_apply"] - before
    worst = max(rel_err(g.grad.cpu(), c.grad) for c, g in
                zip(cpu.parameters(), gpu.parameters()))
    log(f"small f32 resnet: loss card {losses[1]:.6f} cpu {losses[0]:.6f}; "
        f"worst grad rel err {worst:.3e}; {launched} kernel launches")
    check(launched == 1 + 3 * 2 + 2, "small resnet did not run the kernel")
    check(abs(losses[0] - losses[1]) <= TOL_MODEL_REL * abs(losses[0]),
          "small resnet loss differs between card and CPU")
    check(worst <= TOL_MODEL_REL, f"small resnet grad rel err {worst}")


def phase_main_path():
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda

    cfg = trainer.flagship_config(seq=2048)
    torch.cuda.reset_peak_memory_stats()
    _flash_cuda.reset_launch_counts()
    r = trainer.measure(cfg, batch=4, seq=2048, steps=STEPS, warmup=2,
                        device="cuda", seed=0)
    counts = dict(_flash_cuda.launch_counts)
    log(f"main path: {r['params']} params, losses {r['losses']}")
    log(f"main path: {r['tokens_per_sec']:.1f} tokens/s, "
        f"{r['step_ms']:.3f} ms/step, MFU {r['mfu_vs_peak_bf16']}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {json.dumps(counts)}")
    check(all(math.isfinite(x) for x in r["losses"]), "non-finite loss")
    expected = math.log(cfg.vocab_size) + 0.5
    check(abs(r["losses"][0] - expected) <= 0.5,
          f"first loss {r['losses'][0]} not near ln(vocab) + 1/2")
    for name, n in counts.items():
        check(n == cfg.n_layers * STEPS,
              f"{name} launched {n} times, expected {cfg.n_layers * STEPS}")
    return counts, r


def profile(label, run_step, kind_of, host=False):
    """Where a step's device time goes: torch.profiler over PROFILE_STEPS
    calls of ``run_step`` (after warm ones); kernel time summed by
    ``kind_of(name)``, and the device's idle share of the host-clock
    window. With ``host``, also where the host's time goes: the events with
    the most CPU time of their own."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {}
    top = []
    ops = []          # host-side aten ops by the device time they launched
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::")
                and e.self_device_time_total > 0):
            ops.append((e.self_device_time_total, e.count, e.key))
        # Kernels and copies only: a user annotation on the device timeline
        # (the optimizer's step range) spans kernels counted already.
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        us = e.self_device_time_total
        kind = kind_of(e.key.lower())
        kinds[kind] = kinds.get(kind, 0.0) + us
        top.append((us, e.count, e.key[:100]))
    busy = sum(kinds.values())
    n = PROFILE_STEPS
    log(f"profile ({label}): {n} steps, wall {wall_us / n / 1e3:.3f} "
        f"ms/step, device busy {busy / n / 1e3:.3f} ms/step, idle share "
        f"{1 - busy / wall_us:.4f}")
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {kind}: {us / n / 1e3:.3f} ms/step "
            f"({us / busy:.4f} of device time)")
    for us, count, name in sorted(top, reverse=True)[:15]:
        log(f"  {us / n / 1e3:9.3f} ms/step  x{count // n:<4d} {name}")
    log("  by the aten op that launched it:")
    for us, count, name in sorted(ops, reverse=True)[:12]:
        log(f"  {us / n / 1e3:9.3f} ms/step  x{count // n:<4d} {name}")
    if host:
        cpu = sorted(((e.self_cpu_time_total, e.count, e.key[:80])
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     reverse=True)
        log(f"  host: {sum(c[0] for c in cpu) / n / 1e3:.3f} ms/step of "
            "self CPU time in profiled events; the largest:")
        for us, count, name in cpu[:15]:
            log(f"  {us / n / 1e3:9.3f} ms/step  x{count // n:<5d} {name}")


def phase_profile():
    """Where a flagship step's device time goes, after two warm steps."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.parallel import train_step

    cfg = trainer.flagship_config(seq=2048)
    state = trainer.build_state(cfg, "cuda", seed=0)
    batch = synthetic_lm_batch(0, 4, 2048, cfg.vocab_size, device="cuda")
    for _ in range(2):
        train_step(state, batch)

    profile("flagship", lambda: train_step(state, batch), flagship_kind)


def flagship_kind(low):
    """The kind of a flagship kernel, from its lower-cased name."""
    return ("flash_fwd" if "flash_fwd" in low else
            "flash_bwd_dq" if "flash_bwd_dq" in low else
            "flash_bwd_dkv" if "flash_bwd_dkv" in low else
            "matmul" if any(w in low for w in ("gemm", "xmma", "nvjet",
                                               "cutlass")) else
            "nccl" if "nccl" in low else
            "other")


def phase_resnet_path():
    """ResNet-50 through the convfuse kernel, then the MNIST MLP."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _convfuse_cuda, _flash_cuda

    torch.cuda.reset_peak_memory_stats()
    _convfuse_cuda.reset_launch_counts()
    r = trainer.measure_vision("resnet50", batch=RESNET_BATCH, steps=STEPS,
                               warmup=2, device="cuda", seed=0)
    counts = dict(_convfuse_cuda.launch_counts)
    log(f"resnet50: {r['params']} params, batch {r['batch']}, losses "
        f"{r['losses']}")
    log(f"resnet50: {r['samples_per_sec']:.1f} samples/s, "
        f"{r['step_ms']:.3f} ms/step, MFU {r['mfu_vs_peak_bf16']}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {json.dumps(counts)}")
    check(all(math.isfinite(x) for x in r["losses"]), "non-finite loss")
    want = RESNET_LAUNCHES_PER_STEP * STEPS
    check(counts["convfuse_apply"] == want,
          f"convfuse_apply launched {counts['convfuse_apply']} times, "
          f"expected {want}")

    _flash_cuda.reset_launch_counts()
    _convfuse_cuda.reset_launch_counts()
    m = trainer.measure_vision("mnist", batch=MNIST_BATCH, steps=MNIST_STEPS,
                               warmup=2, device="cuda", seed=0)
    log(f"mnist mlp: {m['params']} params, batch {m['batch']}, "
        f"{m['samples_per_sec']:.1f} samples/s, {m['step_ms']:.3f} ms/step, "
        f"losses {m['losses'][0]:.4f} -> {m['losses'][-1]:.4f}")
    check(all(math.isfinite(x) for x in m["losses"]), "non-finite MNIST loss")
    check(not any({**_flash_cuda.launch_counts,
                   **_convfuse_cuda.launch_counts}.values()),
          "the MNIST MLP launched a kernel")
    return counts


def phase_resnet_profile():
    """Where a ResNet-50 step's device time goes, after two warm steps."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.parallel import train_step

    state = trainer.build_vision_state("resnet50", "cuda", seed=0)
    batch = trainer.vision_batch("resnet50", 0, RESNET_BATCH, device="cuda")
    for _ in range(2):
        train_step(state, batch)

    def kind_of(low):
        return ("convfuse_apply" if "convfuse_apply" in low else
                "convolutions (cuDNN)" if any(w in low for w in (
                    "xmma", "implicit", "conv", "cudnn", "dgrad", "wgrad",
                    "fprop", "cutlass", "gemm", "nvjet")) else
                "optimizer (SGD)" if "multi_tensor" in low else
                "reductions (stats, da/db, pool)" if "reduce" in low else
                "other elementwise")
    profile("resnet50", lambda: train_step(state, batch), kind_of)


def check_flash_counts(what, counts, want):
    for name, n in counts.items():
        check(n == want, f"{what}: {name} launched {n} times, expected "
              f"{want}")


def job_token_file(cfg, synthetic_tokens_per_sec):
    """Part (a): the flagship trained from a token file through the
    prefetching iterator (prefetch 2 and 0) and from synthetic batches made
    before the loop, in two turns of opposite order, ``AB_STEPS`` timed
    steps each; the host's read of a batch alone; and the iterator's first
    batches against ``TokenFileDataset.load_local``, byte for byte."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.data import TokenFileDataset, token_file_batches
    from tony_tpu_torch.ops import _flash_cuda

    steps = AB_STEPS + 2
    runs = {"synthetic": [], 2: [], 0: []}
    for order in (("synthetic", 2, 0), (0, 2, "synthetic")):
        for kind in order:
            _flash_cuda.reset_launch_counts()
            if kind == "synthetic":
                r = trainer.measure(cfg, batch=4, seq=2048, steps=steps,
                                    warmup=2, device="cuda", seed=0)
            else:
                r = trainer.measure_token_file(
                    cfg, batch=4, seq=2048, steps=steps, warmup=2,
                    device="cuda", seed=0, prefetch=kind)
            counts = dict(_flash_cuda.launch_counts)
            runs[kind].append(r)
            waits = ("" if kind == "synthetic" else
                     f", data_wait {r['data_wait_s_per_step'] * 1e3:.4f} "
                     f"ms/step, h2d {r['h2d_s_per_step'] * 1e3:.4f} ms/step")
            label = ("synthetic" if kind == "synthetic" else
                     f"token file, prefetch {kind}")
            log(f"job (a) {label}: "
                f"{r['tokens_per_sec']:.1f} tokens/s, {r['step_ms']:.3f} "
                f"ms/step{waits}, losses {r['losses'][0]:.4f} -> "
                f"{r['losses'][-1]:.4f}, launches {json.dumps(counts)}")
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"{kind} run: non-finite loss")
            expected = math.log(cfg.vocab_size) + 0.5
            check(abs(r["losses"][0] - expected) <= 0.5,
                  f"{kind} run: first loss {r['losses'][0]} not near "
                  "ln(vocab) + 1/2")
            check_flash_counts(f"{kind} run", counts, cfg.n_layers * steps)
    mean = {k: statistics.mean(r["tokens_per_sec"] for r in v)
            for k, v in runs.items()}
    log(f"job (a): mean of two turns: token file {mean[2]:.1f} tokens/s "
        f"(prefetch 2), {mean[0]:.1f} (prefetch 0), synthetic "
        f"{mean['synthetic']:.1f} (phase 4: {synthetic_tokens_per_sec:.1f});"
        f" prefetch 2 / synthetic {mean[2] / mean['synthetic']:.4f}, "
        f"prefetch 0 / synthetic {mean[0] / mean['synthetic']:.4f}")

    tmp = tempfile.mkdtemp(prefix="chip-smoke-tok-")
    it = None
    try:
        path = trainer.write_corpus(os.path.join(tmp, "corpus.bin"),
                                    cfg.vocab_size)
        ds = TokenFileDataset(path, 2048, seed=0)
        reads, pins = [], []
        for step in range(20):
            t0 = time.perf_counter()
            ids = ds.load_local(step, slice(0, 4))["tokens"]
            t1 = time.perf_counter()
            torch.from_numpy(ids).to(torch.int64).pin_memory()
            reads.append(t1 - t0)
            pins.append(time.perf_counter() - t1)
        log(f"job (a): host read of a batch, card idle (median of 20): "
            f"load_local {statistics.median(reads) * 1e3:.4f} ms, int64 + "
            f"pin {statistics.median(pins) * 1e3:.4f} ms")
        it = token_file_batches(path, 4, 2048, seed=0, device="cuda")
        for step in range(3):
            got = next(it)["tokens"]
            want = ds.load_local(step, slice(0, 4))["tokens"]
            check(got.dtype == torch.int64 and got.is_cuda,
                  "token-file batch not int64 on the card")
            check(got.cpu().numpy().astype(np.int32).tobytes()
                  == want.tobytes(),
                  f"token-file batch {step} differs from load_local")
        log("job (a): 3 iterator batches equal TokenFileDataset.load_local "
            "byte for byte")
        job_telemetry(tmp)
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(tmp, ignore_errors=True)


def job_telemetry(tmp):
    """The telemetry reporter's device stats and a profiler trace window,
    read on the card."""
    from tony_tpu_torch import profiler, telemetry

    stats = telemetry.collect_device_stats()
    log(f"job (a): telemetry: {stats.get('device_count')} device(s), "
        f"{stats.get('hbm_bytes_in_use', 0) / 2**30:.2f} GiB in use, peak "
        f"{stats.get('hbm_peak_bytes', 0) / 2**30:.2f} GiB, "
        f"{stats.get('steps_completed')} steps, MFU since the first step "
        f"{stats.get('mfu_vs_peak_bf16')}")
    check(stats.get("device_count") == torch.cuda.device_count()
          and stats["devices"][0]["kind"] == torch.cuda.get_device_name(0)
          and stats["hbm_peak_bytes"] > 0 and "mfu_vs_peak_bf16" in stats,
          f"telemetry device stats: {stats}")
    # 50 products, ~1 ms of the card: after earlier profiler sessions in
    # the process, torch.profiler drops a kernel or two at the edges of a
    # window, so a window of two kernels can come back empty.
    a = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    os.environ["TONY_PROFILE_DIR"] = tmp
    try:
        with profiler.trace_window("job") as out:
            for _ in range(50):
                a = a @ a.T / 64
    finally:
        del os.environ["TONY_PROFILE_DIR"]
    with open(os.path.join(out, "trace.json")) as f:
        cats = collections.Counter(e.get("cat")
                                   for e in json.load(f)["traceEvents"])
    log(f"job (a): trace_window wrote {cats['kernel']} kernel events for "
        f"100 launches ({json.dumps(cats)})")
    check(cats["kernel"], "trace_window recorded no kernel on the card")


def job_accum_nccl(cfg, step_ms):
    """Part (b): accumulation 2 with the bucketed all-reduce over a
    one-rank NCCL group."""
    from tony_tpu_torch import telemetry, trainer
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel import (accumulate_grads, bucketed_sync,
                                         monolithic_grads, plan_buckets,
                                         train_step_accum)

    dist = torch.distributed
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))
    try:
        group = dist.group.WORLD
        state = trainer.build_state(cfg, "cuda", seed=0)
        params = list(state.model.parameters())
        n_buckets = len(plan_buckets([(tuple(p.shape), p.dtype)
                                      for p in params], 32))
        batches = [synthetic_lm_batch(s, 4, 2048, cfg.vocab_size,
                                      device="cuda") for s in range(4)]
        full = monolithic_grads(state.loss_fn, state.model, batches[0])
        grads, _, _ = accumulate_grads(state, batches[0], 2)
        synced = bucketed_sync(grads, 32, group)
        num = sum(((synced[k].double() - full[k].double()) ** 2).sum()
                  for k in full)
        den = sum((full[k].double() ** 2).sum() for k in full)
        rel = math.sqrt(num.item() / den.item())
        worst = max(rel_err(synced[k], full[k]) for k in full)
        state.optimizer.zero_grad(set_to_none=True)
        del full, grads, synced
        log(f"job (b): accum 2 vs one full-batch step on batch 0: grads rel "
            f"Frobenius err {rel:.3e} (worst parameter {worst:.3e}); "
            f"{n_buckets} buckets of <= 32 MiB over {len(params)} "
            f"parameters")
        check(rel <= TOL_ACCUM_REL,
              f"accumulated grads rel err {rel} > {TOL_ACCUM_REL}")

        _flash_cuda.reset_launch_counts()
        telemetry._reset_phase_state()
        comms = [0.0]
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            with telemetry.step():
                m = train_step_accum(state, batch, 2, 32, group=group)
            losses.append(m["loss"])
            comms.append(telemetry.phase_stats()["cum"].get("comms", 0.0))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / len(batches)
        counts = dict(_flash_cuda.launch_counts)
        telemetry._reset_phase_state()
        losses = [float(x) for x in losses]
        log(f"job (b): accum 2 over NCCL: {dt * 1e3:.3f} ms per optimizer "
            f"step (phase 4's one-pass step: {step_ms:.3f} ms), comms "
            f"{(comms[-1] / len(batches)) * 1e3:.3f} ms/step, losses "
            f"{losses}, launches {json.dumps(counts)}")
        check(all(math.isfinite(x) for x in losses), "accum: non-finite loss")
        check(all(b > a for a, b in zip(comms, comms[1:])),
              f"a step booked no comms phase: {comms}")
        check_flash_counts("accum 2", counts, 2 * cfg.n_layers * len(batches))
        # Where an optimizer step of accumulation 2 spends the card's time.
        profile("accum 2 over NCCL", lambda: train_step_accum(
            state, batches[0], 2, 32, group=group), flagship_kind)
        del state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not dist.is_initialized(), "the NCCL group was not torn down")


def max_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def ms_by_step(seconds):
    return json.dumps({k: round(v * 1e3, 3) for k, v in seconds.items()})


def job_checkpoint_resume(cfg):
    """Part (c): six steps with async checkpoints every 2 (the last
    forced), a restore into a fresh state, and a resume against an
    uninterrupted run."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.parallel import checkpoint_tree, load_checkpoint_tree

    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        # Disk for a checkpoint being written beside the two kept, and the
        # one of the resumed run: cut depth, never width, when short.
        per_layer = 12 * (4 * cfg.dim * cfg.dim * (1 + cfg.n_kv_heads
                                                   / cfg.n_heads) / 2
                          + 3 * cfg.dim * cfg.mlp_dim)
        fixed = 12 * 2 * cfg.vocab_size * cfg.dim
        free = shutil.disk_usage(tmp).free
        layers = cfg.n_layers
        while layers > 1 and 4 * (fixed + layers * per_layer) > 0.8 * free:
            layers -= 1
        log(f"job (c): {free / 2**30:.1f} GiB free under {tmp}; "
            f"{layers} of {cfg.n_layers} layers")
        if layers != cfg.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        path = trainer.write_corpus(os.path.join(tmp, "corpus.bin"),
                                    cfg.vocab_size)
        ckpt = os.path.join(tmp, "ckpt")
        kw = dict(batch=4, seq=2048, device="cuda", seed=0)
        full = trainer.train(cfg, path, steps=8, **kw)
        first = trainer.train(cfg, path, steps=6, ckpt_dir=ckpt,
                              save_interval=2, max_to_keep=2, **kw)
        log(f"job (c): uninterrupted losses {full['losses']}")
        log(f"job (c): 6 steps with saves: losses {first['losses']}, "
            f"ckpt_stall {ms_by_step(first['save_stall_s'])} ms per save, "
            f"writer {json.dumps(first['write_s'])} s per "
            f"committed step, coalesced {first['coalesced_saves']}, "
            f"{first['checkpoint_bytes']} bytes per checkpoint, async "
            f"errors {first['async_errors']}")
        check(first["async_errors"] == [],
              f"async checkpoint errors: {first['async_errors']}")
        check(max_rel(first["losses"], full["losses"][:6]) <= TOL_RESUME_REL,
              "the run with saves trained differently")

        saved = first.pop("state")
        fresh = trainer.build_state(cfg, "cuda", seed=1)
        mgr = CheckpointManager(ckpt, max_to_keep=2, save_interval_steps=2)
        try:
            check(mgr.latest_verified_step() == 5,
                  f"newest verified step {mgr.latest_verified_step()}, "
                  "expected 5")
            t0 = time.perf_counter()
            load_checkpoint_tree(fresh, mgr.restore(None,
                                                    checkpoint_tree(fresh)))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        finally:
            mgr.close()
        check(fresh.step == 6, f"restored step count {fresh.step}")
        same = all(torch.equal(a, b) for a, b in
                   zip(saved.model.parameters(), fresh.model.parameters()))
        sa = saved.optimizer.state_dict()["state"]
        sb = fresh.optimizer.state_dict()["state"]
        same_m = all(torch.equal(v, sb[k][n]) for k in sa
                     for n, v in sa[k].items())
        log(f"job (c): restore of step 5 into a fresh state: {restore_s:.3f}"
            f" s; parameters bitwise equal {same}, Adam moments bitwise "
            f"equal {same_m}")
        check(same and same_m, "the restored state differs from the saved")
        del saved, fresh

        resumed = trainer.train(cfg, path, steps=8, ckpt_dir=ckpt,
                                save_interval=2, max_to_keep=2, **kw)
        got, want = resumed["losses"], full["losses"][6:]
        rel = max_rel(got, want)
        log(f"job (c): resumed at step {resumed['start_step']} (restored "
            f"{resumed['restored_step']} in {resumed['restore_s']:.3f} s): "
            f"losses {got} vs uninterrupted {want}, max rel diff {rel:.3e}, "
            f"bit-identical {got == want}; its saves: ckpt_stall "
            f"{ms_by_step(resumed['save_stall_s'])} ms, writer "
            f"{json.dumps(resumed['write_s'])} s")
        check(resumed["start_step"] == 6 and resumed["restored_step"] == 5,
              "the resume did not start after step 5")
        check(resumed["async_errors"] == [],
              f"async checkpoint errors: {resumed['async_errors']}")
        check(rel <= TOL_RESUME_REL, f"resumed losses differ by {rel}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_training_job(synthetic_tokens_per_sec, step_ms):
    """The training job's own loop at the flagship's width,
    ``EARLIER_DEPTH`` layers."""
    from tony_tpu_torch import trainer

    full = trainer.flagship_config(seq=2048)
    cfg = earlier(full)
    log(cut_label("job: the flagship", full))
    t0 = time.perf_counter()
    job_token_file(cfg, synthetic_tokens_per_sec)
    job_accum_nccl(cfg, step_ms)
    job_checkpoint_resume(cfg)
    log(f"job: {time.perf_counter() - t0:.1f} s for parts (a)-(c)")


def flash_launches_per_step(cfg):
    """Launches of (fwd, dq, dk/dv) per step: every layer once each, and
    the forward again for each checkpointed layer, re-run in backward."""
    remat = sum(1 for i in range(cfg.n_layers) if cfg.remat and not (
        cfg.remat_skip_every >= 2 and i % cfg.remat_skip_every == 0))
    return {"flash_fwd": cfg.n_layers + remat,
            "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}


def train_point(label, cfg, batch, seq, steps, **kw):
    """``trainer.measure`` on one of bench's decoder points, 2 warm steps
    then ``steps`` timed: finite losses, the first near ln(vocab) + 1/2,
    each flash kernel's launches as the configuration implies. Returns the
    result and the quantized products' launches."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda, quant

    torch.cuda.empty_cache()
    _flash_cuda.reset_launch_counts()
    quant.reset_launch_counts()
    r = trainer.measure(cfg, batch=batch, seq=seq, steps=steps + 2,
                        warmup=2, device="cuda", seed=0, **kw)
    counts = dict(_flash_cuda.launch_counts)
    qcounts = dict(quant.launch_counts)
    log(f"{label}: {r['params']} params, batch {batch} x seq {seq}, "
        f"{r['tokens_per_sec']:.1f} tokens/s, {r['step_ms']:.3f} ms/step, "
        f"MFU {r['mfu_vs_peak_bf16']}, peak memory "
        f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
        f"{json.dumps(counts)}, quantized products {json.dumps(qcounts)}, "
        f"losses {r['losses']}")
    check(all(math.isfinite(x) for x in r["losses"]),
          f"{label}: non-finite loss")
    expected = math.log(cfg.vocab_size) + 0.5
    check(abs(r["losses"][0] - expected) <= 0.5,
          f"{label}: first loss {r['losses'][0]} not near ln(vocab) + 1/2")
    for name, n in flash_launches_per_step(cfg).items():
        check(counts[name] == n * (steps + 2),
              f"{label}: {name} launched {counts[name]} times, expected "
              f"{n} per step")
    return r, qcounts


def profile_point(label, cfg, batch, seq, **kw):
    """Where a step of a chunked-loss point spends the card's time, after
    two warm steps."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.parallel import train_step

    torch.cuda.empty_cache()
    state = trainer.build_state(cfg, "cuda", 0, chunked=True, **kw)
    tokens = synthetic_lm_batch(0, batch, seq, cfg.vocab_size, device="cuda")
    for _ in range(2):
        train_step(state, tokens)
    profile(label, lambda: train_step(state, tokens), flagship_kind)


def phase_long_context():
    """Bench's long-context points and its 0.95B point at full width, then
    the flash kernels at S = 8192 against their plain versions and timed
    beside SDPA at B4 S8192 and B1 S32768."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda as K

    t0 = time.perf_counter()
    points = (
        # bench.py:1163-1190: label, config, batch, seq, loss chunk, steps
        ("longctx_8k_chunked_ce", trainer.flagship_config(8192), 4, 8192,
         2048, 12),
        ("longctx_32k_chunked_ce", trainer.flagship_config(32768), 1, 32768,
         8192, 8),
        ("longctx_8k_b8_selective_remat", trainer.flagship_remat_config(8192),
         8, 8192, 2048, 8),
    )
    for label, cfg, batch, seq, chunk, steps in points:
        train_point(cut_label(label, cfg), earlier(cfg), batch, seq, steps,
                    chunked=True, loss_chunk=chunk)
    # bench.py:1227-1247 (TONY_BENCH_BIG=1): AdamW with a bf16 first moment.
    big = trainer.big_config(2048)
    train_point(cut_label("big_0p95b_remat_bf16mu", big), earlier(big), 4,
                2048, 12, chunked=True, loss_chunk=1024,
                mu_dtype=torch.bfloat16)
    log(f"long context: {time.perf_counter() - t0:.1f} s for the points")

    # Where the device time of a 1 x 32768 step and of a 0.95B step goes.
    long = trainer.flagship_config(32768)
    profile_point(cut_label("longctx 32k", long), earlier(long), 1, 32768,
                  loss_chunk=8192)
    profile_point(cut_label("0.95B", big), earlier(big), 4, 2048,
                  loss_chunk=1024, mu_dtype=torch.bfloat16)

    torch.cuda.empty_cache()
    check_case("longctx bf16 B1 S8192 H8/4 D128 causal", 1, 8192, 8, 4, 128,
               torch.bfloat16, True, 20)
    timing = {}
    for b, s in ((4, 8192), (1, 32768)):
        q, k, v, do = make_case(b, s, 8, 4, 128, torch.bfloat16, 21)
        o, lse = K.flash_fwd(q, k, v, 128 ** -0.5, True)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        res = time_flash(f"B{b} S{s}", q, k, v, do, lse, delta, True, o)
        log(f"timing (flash, B{b} S{s} H8/4 D128 causal): " + json.dumps(res))
        timing[f"B{b}_S{s}"] = res
        del q, k, v, do, o, lse, delta
    log(f"long context: {time.perf_counter() - t0:.1f} s in all")
    return timing


# The flagship's projections at its 4 x 2048 tokens: (rows, in, out) of
# wq (and wo), wk / wv, gate / up, down.
QUANT_SHAPES = ((8192, 1024, 1024), (8192, 1024, 512), (8192, 1024, 4096),
                (8192, 4096, 1024))
# fp8 product on the card against the f32 product of the same fp8 values,
# relative to the largest |accumulator|: cuBLASLt's fp8 path may keep fewer
# accumulator bits between its f32 promotions than an f32 sum.
TOL_FP8_ACC_REL = 1e-3


def phase_quant():
    """Both quantized modes resolve on the card; quantization and the
    library products against the CPU's plain versions at the flagship's
    projection shapes; their times beside bf16 ``F.linear``; then the
    flagship trained at bf16, int8 and fp8 in one run."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import quant as Q

    F = torch.nn.functional
    for mode in Q.MODES:
        check(Q.resolve_mode(mode, "cuda") == mode,
              f"{mode} does not resolve on the card: {Q.fallback_events()}")
    check(Q.fallback_events() == {}, f"degraded: {Q.fallback_events()}")
    rng = np.random.default_rng(30)
    rows = []
    for m, kdim, n in QUANT_SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, kdim), dtype=np.float32)
                             ).to("cuda", torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal((n, kdim), dtype=np.float32)
                             / math.sqrt(kdim)).to("cuda", torch.bfloat16)
        row = {"shape": [m, kdim, n],
               "bf16_linear_ms": cuda_ms(lambda: F.linear(x, w))}
        for mode in Q.MODES:
            qx, sx = Q.quantize_symmetric(x, mode, axis=-1)
            qw, sw = Q.quantize_symmetric(w, mode, axis=-1)
            for name, got, ref in (
                    ("x", (qx, sx), Q.quantize_symmetric(x.cpu(), mode, -1)),
                    ("w", (qw, sw), Q.quantize_symmetric(w.cpu(), mode, -1))):
                check(torch.equal(got[1].cpu(), ref[1]),
                      f"{mode} {name} scales differ from the CPU's")
                check(torch.equal(got[0].cpu().view(torch.uint8),
                                  ref[0].view(torch.uint8)),
                      f"{mode} {name} quantized values differ from the CPU's")
            acc = Q.product_library(qx, qw, mode)
            acc_p = Q.product_plain(qx, qw, mode)
            out = Q._qmm_forward(x, w, mode)
            out_cpu = Q._qmm_forward(x.cpu(), w.cpu(), mode)
            acc_err = max_err(acc, acc_p)
            acc_max = acc_p.abs().max().item()
            out_err = max_err(out.cpu(), out_cpu)
            if mode == Q.INT8:
                check(acc.dtype == torch.int32 and torch.equal(acc, acc_p),
                      f"int8 accumulator differs from the exact sum at "
                      f"{row['shape']}")
                check(torch.equal(out.cpu(), out_cpu),
                      f"int8 output differs from the CPU's at {row['shape']}")
            else:
                check(acc_err <= TOL_FP8_ACC_REL * acc_max,
                      f"fp8 accumulator err {acc_err} > {TOL_FP8_ACC_REL} "
                      f"x {acc_max} at {row['shape']}")
                rel = rel_err(out.cpu(), out_cpu)
                check(rel <= TOL_FP8_ACC_REL, f"fp8 output rel err {rel}")
            row[mode] = dict(
                ms=cuda_ms(lambda: Q._qmm_forward(x, w, mode)),
                product_ms=cuda_ms(lambda: Q.product_library(qx, qw, mode)),
                acc_max_abs_err=acc_err, acc_max_abs=acc_max,
                out_max_abs_err=out_err)
        log(f"quant {json.dumps(row)}")
        rows.append(row)
        del x, w

    runs = {}
    for mode in (None, Q.INT8, Q.FP8_E4M3):
        full = trainer.flagship_config(2048, mode)
        label = cut_label(f"flagship {mode or 'bf16'}", full)
        cfg = earlier(full)
        r, qcounts = train_point(label, cfg, 4, 2048, STEPS - 2)
        want = 7 * cfg.n_layers * STEPS if mode else 0
        check(qcounts.get(mode, 0) == want and sum(qcounts.values()) == want,
              f"{label}: quantized products {qcounts}, expected {want}")
        runs[mode or "bf16"] = r["tokens_per_sec"]
    check(Q.fallback_events() == {}, f"degraded: {Q.fallback_events()}")
    log(f"quant: flagship tokens/s bf16 {runs['bf16']:.1f}, int8 "
        f"{runs['int8']:.1f} ({runs['int8'] / runs['bf16']:.4f}), fp8 "
        f"{runs['fp8_e4m3']:.1f} ({runs['fp8_e4m3'] / runs['bf16']:.4f})")
    return rows


def phase_mesh(card):
    """Phase 10: the flagship (``EARLIER_DEPTH`` layers) on a world-1 mesh
    over NCCL, in turns with the unsharded model, then a sharded DCP save
    and restore."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel import (MeshSpec, build_mesh,
                                         checkpoint_tree,
                                         load_checkpoint_tree, mesh_shape,
                                         sharded_train_step)

    dist = torch.distributed
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))
    try:
        cfg = earlier(trainer.flagship_config(seq=2048))
        mesh = build_mesh(MeshSpec(), "cuda")
        log(f"mesh: {json.dumps(mesh_shape(mesh))} over "
            f"{dist.get_backend()}; {card}; {cfg.n_layers} layers")
        want = None
        rates = {"sharded": [], "unsharded": []}
        for kind in ("unsharded", "sharded", "unsharded", "sharded"):
            _flash_cuda.reset_launch_counts()
            # A sharded model lives in reference cycles (FSDP2's hooks):
            # free the last turn's before this turn's peak is taken.
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            r = trainer.measure(cfg, batch=4, seq=2048, steps=STEPS,
                                warmup=2, device="cuda", seed=0,
                                mesh="fsdp=1" if kind == "sharded" else "")
            counts = dict(_flash_cuda.launch_counts)
            rates[kind].append(r["tokens_per_sec"])
            log(f"mesh (a) {kind}: {r['tokens_per_sec']:.1f} tokens/s, "
                f"{r['step_ms']:.3f} ms/step, peak memory "
                f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
                f"{json.dumps(counts)}")
            if kind == "unsharded":
                want = want or r["losses"]
                continue
            got = r["losses"]
            rel = max_rel(got, want)
            diff = max(abs(a - b) for a, b in zip(got, want))
            log(f"mesh (a) sharded losses {got}; against the first unsharded "
                f"turn: largest difference {diff:.3e} (relative {rel:.3e}), "
                f"bit for bit {got == want}")
            check(rel <= TOL_MESH_REL,
                  f"sharded losses differ from the unsharded by {rel}")
            check_flash_counts("mesh", counts, cfg.n_layers * STEPS)
        ratio = statistics.median(rates["sharded"]) / statistics.median(
            rates["unsharded"])
        log(f"mesh (a): sharded / unsharded tokens/s {ratio:.4f} (medians "
            f"of {len(rates['sharded'])} alternating turns each)")
        sharded = {"losses": got,
                   "tokens_per_sec": statistics.median(rates["sharded"])}

        gc.collect()
        state = trainer.build_state(cfg, "cuda", seed=0, mesh=mesh)
        batch = synthetic_lm_batch(0, 4, 2048, cfg.vocab_size,
                                   device="cuda", mesh=mesh)
        for _ in range(2):
            sharded_train_step(state.loss_fn, mesh, state, batch)
        # Where a sharded step's time goes, on the card and on the host.
        profile("flagship on the world-1 mesh", lambda: sharded_train_step(
            state.loss_fn, mesh, state, batch), flagship_kind, host=True)
        ckpt = os.path.join(tmp, "ckpt")
        mgr = CheckpointManager(ckpt)
        try:
            t1 = time.perf_counter()
            mgr.save(state.step - 1, checkpoint_tree(state), force=True,
                     mesh=mesh)
            save_s = time.perf_counter() - t1
            fresh = trainer.build_state(cfg, "cuda", seed=1, mesh=mesh)
            t1 = time.perf_counter()
            load_checkpoint_tree(fresh, mgr.restore(
                None, checkpoint_tree(fresh), mesh=mesh))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
            noted = mgr.saved_mesh_shape(mgr.latest_step())
            nbytes = mgr.step_bytes(mgr.latest_step())
            resharded = mgr.last_restore_resharded
        finally:
            mgr.close()
        same = all(torch.equal(_local(a), _local(b)) for a, b in
                   zip(state.model.parameters(), fresh.model.parameters()))
        sa = state.optimizer.state_dict()["state"]
        sb = fresh.optimizer.state_dict()["state"]
        same_m = all(torch.equal(_local(v), _local(sb[k][n])) for k in sa
                     for n, v in sa[k].items())
        log(f"mesh (b): sharded save of step {state.step - 1} ({nbytes} "
            f"bytes) {save_s:.3f} s, restore {restore_s:.3f} s; manifest "
            f"mesh {json.dumps(noted)}; parameters bitwise equal {same}, "
            f"Adam moments bitwise equal {same_m}, resharded {resharded}")
        check(noted == mesh_shape(mesh), f"manifest notes mesh {noted}")
        check(same and same_m, "the restored sharded state differs")
        check(resharded is None, f"restore reported a reshard: {resharded}")
        check(fresh.step == state.step, f"restored step {fresh.step}")
        del state, fresh
        mesh_resnet(mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not dist.is_initialized(), "the NCCL group was not torn down")
    log(f"mesh: {time.perf_counter() - t0:.1f} s for parts (a)-(b)")
    return sharded


def mesh_resnet(mesh):
    """Phase 10 (c): ResNet-50 on the world-1 mesh against unsharded."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _convfuse_cuda
    from tony_tpu_torch.parallel import sharded_train_step, train_step

    gc.collect()
    losses = {}
    for kind in ("unsharded", "sharded"):
        state = trainer.build_vision_state(
            "resnet50", "cuda", seed=0,
            mesh=mesh if kind == "sharded" else None)
        _convfuse_cuda.reset_launch_counts()
        got = []
        for s in range(3):
            batch = trainer.vision_batch("resnet50", s, RESNET_BATCH,
                                         device="cuda")
            if kind == "sharded":
                m = sharded_train_step(state.loss_fn, mesh, state, batch)[1]
            else:
                m = train_step(state, batch)
            got.append(float(m["loss"]))
        losses[kind] = got
        launched = _convfuse_cuda.launch_counts["convfuse_apply"]
        del state
        gc.collect()
    rel = max_rel(losses["sharded"], losses["unsharded"])
    log(f"mesh (c) resnet50 batch {RESNET_BATCH}: sharded losses "
        f"{losses['sharded']} vs unsharded {losses['unsharded']}, max rel "
        f"{rel:.3e}, bit for bit {losses['sharded'] == losses['unsharded']};"
        f" convfuse launches {launched} in 3 sharded steps")
    check(rel <= TOL_MESH_REL, f"sharded ResNet-50 differs by {rel}")
    check(launched == 3 * RESNET_LAUNCHES_PER_STEP,
          f"convfuse_apply launched {launched} times in 3 sharded steps")


def phase_seq_expert(mesh_run, long_timing, card):
    """Phase 11: sequence and expert parallelism at world 1."""
    dist = torch.distributed
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-sp-")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))
    try:
        log(cut_label("seq/expert (a), (c): the flagship and its MoE",
                      moe_flagship_config()))
        sp_flagship(mesh_run, card)
        t1 = time.perf_counter()
        virtual_ring(long_timing, card)
        log(f"seq/expert (b): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        small_moe()
        moe = moe_flagship(card)
        log(f"seq/expert (c): {time.perf_counter() - t1:.1f} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not dist.is_initialized(), "the NCCL group was not torn down")
    log(f"seq/expert: {time.perf_counter() - t0:.1f} s for parts (a)-(c)")
    return moe


OFF_MESH_STEPS = 3


def sp_flagship(mesh_run, card):
    """(a) The flagship with ring and with Ulysses attention over the mesh's
    one-rank sp group, against phase 10's sharded flash run."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda

    want = mesh_run["losses"]
    # Off any mesh the ring is a ring of one rank: its hop runs the kernels.
    cfg = dataclasses.replace(earlier(trainer.flagship_config(seq=2048)),
                              attn_impl="ring")
    gc.collect()
    _flash_cuda.reset_launch_counts()
    got = trainer.measure(cfg, batch=4, seq=2048, steps=OFF_MESH_STEPS,
                          warmup=1, device="cuda", seed=0)["losses"]
    counts = dict(_flash_cuda.launch_counts)
    rel = max_rel(got, want[:OFF_MESH_STEPS])
    log(f"seq/expert (a) ring off any mesh: losses {got}, against phase "
        f"10's first {OFF_MESH_STEPS}: largest relative difference "
        f"{rel:.3e}; launches {json.dumps(counts)}")
    check(rel <= TOL_SP_REL, f"ring off a mesh differs from phase 10's "
          f"losses by {rel} > {TOL_SP_REL}")
    check_flash_counts("ring off a mesh", counts,
                       cfg.n_layers * OFF_MESH_STEPS)
    for impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(earlier(trainer.flagship_config(seq=2048)),
                                  attn_impl=impl)
        gc.collect()
        _flash_cuda.reset_launch_counts()
        r = trainer.measure(cfg, batch=4, seq=2048, steps=STEPS, warmup=2,
                            device="cuda", seed=0, mesh="fsdp=1")
        counts = dict(_flash_cuda.launch_counts)
        got = r["losses"]
        rel = max_rel(got, want)
        log(f"seq/expert (a) {impl}: {r['tokens_per_sec']:.1f} tokens/s "
            f"({r['step_ms']:.3f} ms/step; phase 10's sharded flash "
            f"{mesh_run['tokens_per_sec']:.1f}), peak memory "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
            f"{json.dumps(counts)}; {card}")
        log(f"seq/expert (a) {impl} losses {got}; against phase 10's sharded "
            f"flash: largest relative difference {rel:.3e}, bit for bit "
            f"{got == want}")
        check(all(math.isfinite(x) for x in got), f"{impl}: non-finite loss")
        check(rel <= TOL_SP_REL, f"{impl} losses differ from phase 10's by "
              f"{rel} > {TOL_SP_REL}")
        check_flash_counts(f"sp {impl}", counts, cfg.n_layers * STEPS)


def ring_rank(qr, k, v, r, n, scale):
    """Virtual rank r of an n-rank causal ring on one card: the output for
    its Q chunk ``qr`` (``[B, S/n, H, D]``), through the ring's own
    ``schedule``, ``_hop`` and ``_merge``, against the chunks of the whole
    ``k``/``v`` in the order the ring would deliver them."""
    from tony_tpu_torch.ops import ring as R

    s = qr.shape[1]
    o, lse = R.empty_state(qr)
    for _, src, kind in R.schedule(r, n, True):
        if kind == R.SKIP:
            continue
        oc, lc = R._hop(qr, k[:, src * s:(src + 1) * s],
                        v[:, src * s:(src + 1) * s], kind, scale, 128, 128)
        o, lse = R._merge(o, lse, oc, lc)
    return o.to(qr.dtype)


VIRTUAL_RANKS = 4


def virtual_ring(long_timing, card):
    """(b) Four virtual ranks of the causal ring at B1 S32768 and B4
    S2048, against whole-sequence flash."""
    from tony_tpu_torch.ops import _flash_cuda as K
    from tony_tpu_torch.ops.attention import flash_attention

    n = VIRTUAL_RANKS
    for b, s, seed in ((1, 32768, 40), (4, 2048, 41)):
        torch.cuda.empty_cache()
        name = f"B{b} S{s} H8/4 D128 bf16, {n} virtual ranks"
        q, k, v, do = make_case(b, s, 8, 4, 128, torch.bfloat16, seed)
        scale = 128 ** -0.5
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        chunk = s // n
        K.reset_launch_counts()
        o = torch.cat([ring_rank(leaves[0][:, r * chunk:(r + 1) * chunk],
                                 *leaves[1:], r, n, scale)
                       for r in range(n)], dim=1)
        grads = torch.autograd.grad((o.float() * do.float()).sum(), leaves)
        torch.cuda.synchronize()
        counts = dict(K.launch_counts)
        ref_leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o_ref = flash_attention(*ref_leaves, causal=True)
        ref = torch.autograd.grad((o_ref.float() * do.float()).sum(),
                                  ref_leaves)
        err_o = max_err(o, o_ref)
        rels = {f"d{x}": rel_err(g, r) for x, g, r in zip("qkv", grads, ref)}
        log(f"seq/expert (b) {name}: o max abs err {err_o:.3e} against "
            f"whole-sequence flash, grad rel err {json.dumps(rels)}, "
            f"launches {json.dumps(counts)} (forward + backward of the "
            f"{n * (n + 1) // 2} hops the causal skip leaves)")
        check(err_o <= TOL_BF16_O, f"{name}: o err {err_o}")
        for x, e in rels.items():
            check(e <= TOL_BF16_GRAD_REL, f"{name}: {x} rel err {e}")
        hops = n * (n + 1) // 2
        check(all(c == hops for c in counts.values()),
              f"{name}: launches {counts}, expected {hops} of each")
        del o, grads, o_ref, ref

        # Each virtual rank's forward + backward alone, beside the whole
        # sequence's.
        ms = []
        for r in range(n):
            qr = q[:, r * chunk:(r + 1) * chunk].clone().requires_grad_()
            dor = do[:, r * chunk:(r + 1) * chunk].float()
            kv = [x.detach().requires_grad_(True) for x in (k, v)]

            def rank_step():
                o_r = ring_rank(qr, *kv, r, n, scale)
                torch.autograd.grad((o_r.float() * dor).sum(), [qr, *kv])
            ms.append(cuda_ms(rank_step, reps=10))
        whole = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def whole_step():
            o_w = flash_attention(*whole, causal=True)
            torch.autograd.grad((o_w.float() * do.float()).sum(), whole)
        whole_ms = cuda_ms(whole_step, reps=10)
        log(f"seq/expert (b) {name}: forward + backward ms per virtual rank "
            f"{json.dumps([round(x, 4) for x in ms])}; whole-sequence flash "
            f"{whole_ms:.4f} ms, / {n} = {whole_ms / n:.4f}; slowest rank / "
            f"(whole / {n}) {max(ms) / (whole_ms / n):.4f}; {card}")
        if s == 32768:
            hop_kernels(q, k, v, do, chunk, scale, long_timing, card)
        del q, k, v, do, leaves, whole


def hop_kernels(q, k, v, do, chunk, scale, long_timing, card):
    """Each flash kernel's time on one 32k hop (an 8192-query chunk against
    an 8192-key chunk, f32 out, a non-zero lse cotangent in delta), full and
    diagonal, beside the whole 32k sequence's (phase 8)."""
    from tony_tpu_torch.ops import _flash_cuda as K

    qr = q[:, -chunk:].contiguous()
    kc, vc = k[:, :chunk].contiguous(), v[:, :chunk].contiguous()
    dor = do[:, -chunk:].contiguous()
    whole = long_timing["B1_S32768"]
    out = {}
    for kind, causal in (("full", False), ("diagonal", True)):
        o, lse = K.flash_fwd(qr, kc, vc, scale, causal, torch.float32)
        dlse = torch.randn_like(lse) * 1e-2
        delta = ((o * dor.float()).sum(-1).transpose(1, 2)
                 - dlse).contiguous()
        out[kind] = {
            "flash_fwd": cuda_ms(lambda: K.flash_fwd(qr, kc, vc, scale,
                                                     causal, torch.float32)),
            "flash_bwd_dq": cuda_ms(lambda: K.flash_bwd_dq(
                qr, kc, vc, dor, lse, delta, scale, causal)),
            "flash_bwd_dkv": cuda_ms(lambda: K.flash_bwd_dkv(
                qr, kc, vc, dor, lse, delta, scale, causal))}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        log(f"seq/expert (b) 32k hop {name}: full {out['full'][name]:.4f} "
            f"ms, diagonal {out['diagonal'][name]:.4f} ms; whole 1 x 32768 "
            f"sequence (phase 8) {whole[name]['ms']:.4f} ms; {card}")


def small_moe():
    """(c) A small f32 MoE decoder (head_dim 64, the kernels' f32 path) on
    the card against the same weights on the CPU, 3 AdamW steps."""
    from tony_tpu_torch.models.moe import (MoEConfig, MoETransformer,
                                           moe_lm_loss)
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel import adamw

    cfg = MoEConfig.tiny_moe(vocab_size=512, dim=256, n_heads=4,
                             n_kv_heads=2, mlp_dim=512, max_seq_len=256)
    cpu = MoETransformer(cfg, device="cpu")
    gpu = MoETransformer(cfg, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (3, 2, 256)))
    losses = {}
    _flash_cuda.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        opt = adamw(model.parameters(), 1e-3)
        got = []
        for s in range(3):
            tok = tokens[s].to(dev)
            loss = moe_lm_loss(model(tok), tok, cfg.aux_loss_weight)
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            got.append(loss.item())
        losses[dev] = got
    worst = max(rel_err(g.detach().cpu(), c.detach()) for c, g in
                zip(cpu.parameters(), gpu.parameters()))
    rel = max_rel(losses["cuda"], losses["cpu"])
    counts = dict(_flash_cuda.launch_counts)
    log(f"seq/expert (c) small f32 MoE: losses card {losses['cuda']} cpu "
        f"{losses['cpu']} (max rel {rel:.3e}); worst parameter rel err after "
        f"3 steps {worst:.3e}; launches {json.dumps(counts)}")
    check(rel <= TOL_MODEL_REL, f"small MoE losses differ by {rel}")
    check(worst <= TOL_MODEL_REL, f"small MoE parameters differ by {worst}")
    check_flash_counts("small MoE", counts, 3 * cfg.n_layers)


def moe_flagship_config():
    """The MoE decoder at the flagship's widths (``bench.py:190-212``) with
    ``MoEConfig``'s own defaults: 8 experts, top-2, capacity factor 1.25,
    aux weight 0.01, remat on."""
    from tony_tpu_torch.models.moe import MoEConfig

    return MoEConfig(vocab_size=32000, dim=1024, n_layers=16, n_heads=8,
                     n_kv_heads=4, mlp_dim=4096, max_seq_len=2048)


def moe_dropped_share(model, cfg, tokens):
    """The share of (token, slot) pairs that capacity drops, over the
    layers, in one forward of ``tokens`` (one routing group)."""
    from tony_tpu_torch.models import moe as M

    seen = []
    hooks = [blk.moe.router.register_forward_hook(
        lambda m, i, o: seen.append(o)) for blk in model.layers]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for h in hooks:
            h.remove()
    dropped = 0
    for logits in seen:
        idx = M.top_k_experts(torch.softmax(logits, -1), cfg.top_k)
        _, kept = M.route(cfg, idx, M.capacity(cfg, idx.shape[0]))
        dropped += int((~kept).sum())
    return dropped / (len(seen) * idx.numel())


def moe_flagship(card):
    """(c) The MoE decoder at the flagship's widths: 10 unsharded steps,
    then 3 on the world-1 mesh against them."""
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.models.moe import MoETransformer, moe_lm_loss
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel import (MeshSpec, TrainState, adamw,
                                         build_mesh, init_sharded_state,
                                         sharded_train_step, train_step)

    cfg = earlier(moe_flagship_config())
    batch, seq = 4, 2048

    def loss_fn(model, b):
        tok = b["tokens"]
        return moe_lm_loss(model(tok), tok, cfg.aux_loss_weight), {}

    batches = [synthetic_lm_batch(s, batch, seq, cfg.vocab_size,
                                  device="cuda") for s in range(STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = MoETransformer(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    state = TrainState(model, adamw(model.parameters(), 3e-4), loss_fn)
    n_params = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if n.rsplit(".", 1)[-1] in ("gate", "up", "down"))
    active = n_params - experts + experts * cfg.top_k // cfg.n_experts
    _flash_cuda.reset_launch_counts()
    losses = []
    for s in range(STEPS):
        if s == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(train_step(state, batches[s])["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (STEPS - 2)
    losses = [float(x) for x in losses]
    counts = dict(_flash_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tokens_per_sec = batch * seq / dt
    fpt = 6 * active + 12 * cfg.n_layers * cfg.dim * seq // 2
    mfu = tokens_per_sec * fpt / PEAK_BF16
    dropped = moe_dropped_share(model, cfg, batches[0]["tokens"])
    per_step = {k: v / STEPS for k, v in counts.items()}
    log(f"seq/expert (c) MoE at the flagship's widths: {n_params} params "
        f"({active} active per token), batch {batch} x {seq}, "
        f"{tokens_per_sec:.1f} tokens/s, {dt * 1e3:.3f} ms/step, MFU over "
        f"the active parameters {mfu:.4f}, peak memory {peak / 2**30:.2f} "
        f"GiB, token-slots dropped by capacity {dropped:.4f} (batch 0, after "
        f"training), flash launches per step {json.dumps(per_step)}; {card}")
    log(f"seq/expert (c) MoE losses {losses}")
    check(all(math.isfinite(x) for x in losses), "MoE: non-finite loss")
    expected = math.log(cfg.vocab_size) + 0.5
    check(abs(losses[0] - expected) <= 0.5,
          f"MoE: first loss {losses[0]} not near ln(vocab) + 1/2")
    want = flash_launches_per_step(cfg)
    for name, n in want.items():
        check(counts[name] == n * STEPS, f"MoE: {name} launched "
              f"{counts[name]} times, expected {n} per step")
    # Where a MoE step's device time goes.
    profile(cut_label("MoE at the flagship's widths", moe_flagship_config()),
            lambda: train_step(state, batches[0]), flagship_kind)
    del state, model
    gc.collect()
    torch.cuda.empty_cache()

    mesh = build_mesh(MeshSpec(), "cuda")
    sharded, _ = init_sharded_state(
        lambda d: MoETransformer(cfg, device=d),
        lambda g: adamw(g, 3e-4), mesh, seed=0)
    gate = sharded.model.layers[0].moe.gate
    check(type(gate).__name__ == "DTensor", "MoE experts not DTensors")
    got = []
    t1 = time.perf_counter()
    for s in range(3):
        got.append(float(sharded_train_step(loss_fn, mesh, sharded,
                                            batches[s])[1]["loss"]))
    torch.cuda.synchronize()
    rel = max_rel(got, losses[:3])
    mesh_ms = (time.perf_counter() - t1) / 3 * 1e3
    log(f"seq/expert (c) MoE on the world-1 mesh (experts on (ep, tp)): "
        f"losses {got} against unsharded {losses[:3]}: max rel {rel:.3e}, "
        f"bit for bit {got == losses[:3]}; {mesh_ms:.1f} ms/step (first "
        f"step included)")
    check(rel <= TOL_MESH_REL, f"MoE on the mesh differs by {rel}")
    del sharded
    gc.collect()
    return {"layers": cfg.n_layers, "mesh_ms": mesh_ms,
            "unsharded_ms": dt * 1e3}


# Phase 12: the orchestrator's job path on the card.
REPO = os.path.dirname(os.path.abspath(__file__))
JOB_TIMEOUT_S = 300
# A command line that names a module of the reference package.
REFERENCE_MODULE = re.compile(r"\btony_tpu(?!_torch)\.")


def repo_env():
    """This environment with the repository first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (REPO + os.pathsep
                         + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    return env


def descendant_cmdlines(root):
    """Command lines of the processes below ``root`` (read from /proc)."""
    parent, cmd = {}, {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                parent[int(pid)] = int(f.read().rsplit(") ", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd[int(pid)] = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except (OSError, IndexError, ValueError):
            continue
    out = set()
    for pid, c in cmd.items():
        p = parent.get(pid)
        while p is not None and p > 1 and p != root:
            p = parent.get(p)
        if p == root:
            out.add(c)
    return out


def gpu_apps():
    """The rows of ``nvidia-smi --query-compute-apps=pid,used_memory``,
    one per CUDA context on the card, as (pid, MiB). In a container whose
    pid namespace nvidia-smi cannot translate the pid may be wrong, but
    there is still one row per context."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    rows = []
    for line in r.stdout.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            rows.append((int(parts[0]), parts[1]))
    return rows


def gpu_used_mib():
    """The card's used memory (MiB), every process's together."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    return float(r.stdout.strip().splitlines()[0])


def submit_job(tmp, label, command, conf=(), roots=(), backend="local"):
    """``python -m tony_tpu_torch.cli submit`` of a one-worker pytorch job
    on ``backend``, its history under ``tmp`` (``conf``: more
    ``key=value`` settings): the CLI's exit code, its output, the
    application id, the history root, the client workdir, the command
    lines of the CLI's descendants and of ``roots``' (a pool daemon's)
    while the job ran (read from /proc every 0.1 s), and with ``roots``
    the most compute processes ``nvidia-smi`` listed at once meanwhile
    and their pids (read every second)."""
    hist = os.path.join(tmp, label, "history")
    work = os.path.join(tmp, label, "work")
    out_path = os.path.join(tmp, f"{label}.out")
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "submit",
            "--conf", "tony.application.framework=pytorch",
            "--conf", f"tony.application.backend={backend}",
            "--conf", "tony.worker.instances=1",
            "--conf", f"tony.worker.command={command}",
            "--conf", f"tony.history.location={hist}",
            "--conf", f"tony.application.timeout-s={JOB_TIMEOUT_S}",
            "--workdir", work]
    for kv in conf:
        argv += ["--conf", kv]
    env = repo_env()
    seen, next_smi = set(), 0.0
    on_card = {"max_rows": 0, "pids": set()}
    with open(out_path, "w") as out:
        proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        deadline = time.monotonic() + JOB_TIMEOUT_S + 60
        try:
            while proc.poll() is None:
                for root in (proc.pid, *roots):
                    seen |= descendant_cmdlines(root)
                if roots and time.monotonic() > next_smi:
                    rows = gpu_apps()
                    on_card["max_rows"] = max(on_card["max_rows"], len(rows))
                    on_card["pids"] |= {p for p, _ in rows}
                    next_smi = time.monotonic() + 1.0
                if time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            if proc.poll() is None:
                proc.terminate()      # the CLI kills its application
                proc.wait(timeout=120)
                check(False, f"{label}: the job outlasted {JOB_TIMEOUT_S} s")
    with open(out_path) as f:
        text = f.read()
    m = re.search(r"submitted application (\S+)", text)
    check(m is not None, f"{label}: no application id in {text[-2000:]}")
    return proc.returncode, text, m.group(1), hist, work, seen, on_card


def job_task_log(work, app_id, name="stdout.log"):
    path = os.path.join(work, "jobs", app_id, "tasks", "worker_0", name)
    with open(path, errors="replace") as f:
        return f.read()


def job_history(hist, app_id):
    """The job's final status, its history directory and its events."""
    from tony_tpu_torch.events import history

    status = [r.status for r in history.list_jobs(hist) if r.app_id == app_id]
    job_dir = history.list_job_dirs(hist).get(app_id)
    check(job_dir is not None, f"no history directory for {app_id}")
    return (status[0] if status else None, job_dir,
            history.read_job_events(hist, app_id) or [])


def first_step_latency(job_dir):
    """``submit_to_first_step_s`` from the job's own spans (``client.submit``
    start to ``executor.first_step`` end) and ``cold_start_breakdown``'s
    phases, which must sum to it; every span closed."""
    from tony_tpu_torch import constants, tracing

    records = tracing.load_records(os.path.join(job_dir,
                                                constants.TRACE_FILE))
    check(records, f"no span records in {job_dir}")
    payload = tracing.to_trace_events(records)
    check(not payload["unclosedSpans"],
          f"unclosed spans: {payload['unclosedSpans']}")
    spans = [e for e in payload["traceEvents"] if e.get("ph") == "X"]
    submit = [e for e in spans if e["name"] == "client.submit"]
    first = [e for e in spans if e["name"] == "executor.first_step"]
    check(submit and first, "client.submit or executor.first_step missing: "
          f"{sorted({e['name'] for e in spans})}")
    first_end = min(e["ts"] + e.get("dur", 0) for e in first)
    latency = (first_end - min(e["ts"] for e in submit)) / 1e6
    bd = tracing.cold_start_breakdown(records)
    check(abs(bd["total_s"] - latency) < 1e-3,
          f"breakdown total {bd['total_s']} != span latency {latency}")
    check(abs(sum(bd["phases"].values()) - latency) < 1e-3,
          f"phases {bd['phases']} do not sum to {latency}")
    user = min((e for e in spans if e["name"] == "executor.user_process"),
               key=lambda e: e["ts"])
    return latency, bd, user["ts"] / 1e6, first_end / 1e6, spans


def user_boot_split(run, user_start, first_end):
    """``user_boot`` in four parts, from the trainer's start-up wall times
    (``startup_ts``, ``first_step_start_ts``) between the user process's
    span start and the first step's end: the interpreter's boot, the
    imports (torch and the port), the set-up (CUDA, the model built on the
    card, the batches) and the first step."""
    ts = run["startup_ts"]
    marks = [user_start, ts["package"], ts["main"],
             run["first_step_start_ts"], first_end]
    return dict(zip(("interpreter", "imports", "setup", "first_step"),
                    (round(b - a, 4) for a, b in zip(marks, marks[1:]))))


def orchestrated_flagship(tmp, label, in_process, pool=None):
    """(a), (b) and (d): the flagship, 10 steps, submitted as a one-worker
    job (with ``pool``, ``(pool dir, daemon pid)``, against that warm
    pool); returns its submit-to-first-step seconds and phases, and for a
    pooled job its spans and the pids seen on the card."""
    from tony_tpu_torch.ops import _flash_cuda

    command = (f"{sys.executable} -m tony_tpu_torch.trainer "
               f"--model flagship --steps {STEPS}")
    rc, text, app, hist, work, cmdlines, on_card = submit_job(
        tmp, label, command,
        conf=[f"tony.pool.dir={pool[0]}"] if pool else (),
        roots=[pool[1]] if pool else ())
    check(rc == 0, f"{label}: the CLI exited {rc}: {text[-3000:]}\n"
          f"{job_task_log(work, app, 'stderr.log')[-3000:]}")
    status, job_dir, events = job_history(hist, app)
    check(status == "SUCCEEDED", f"{label}: history says {status}")
    run = json.loads(job_task_log(work, app).strip().splitlines()[-1])
    check(all(math.isfinite(x) for x in run["losses"]),
          f"{label}: non-finite loss {run['losses']}")
    for name in _flash_cuda.KERNELS:
        check(run["launches_per_step"][name] == 16,
              f"{label}: {name} {run['launches_per_step'][name]} launches "
              "per step, expected 16")
    coord = [c for c in cmdlines if "-m tony_tpu_torch.coordinator" in c]
    # A pooled job's executor is the adopted warm worker.
    execs = [c for c in cmdlines if "-m tony_tpu_torch.executor" in c
             or (pool and "-m tony_tpu_torch.pool worker" in c)]
    check(coord and execs, f"{label}: no coordinator or executor of the "
          f"port among {sorted(cmdlines)}")
    bad = [c for c in cmdlines if REFERENCE_MODULE.search(c)]
    check(not bad, f"{label}: a process ran the reference: {bad}")
    finished = [e for e in events if e.type.value == "TASK_FINISHED"]
    check(len(finished) == 1, f"{label}: {len(finished)} TASK_FINISHED")
    peak = float(finished[0].payload.get("metrics", {})
                 .get("MAX_TPU_HBM_BYTES", 0))
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    check(0 < peak < card_bytes, f"{label}: the monitor's peak device "
          f"memory {peak} is not in (0, {card_bytes})")
    latency, bd, user_start, first_end, spans = first_step_latency(job_dir)
    bd["user_boot_split"] = user_boot_split(run, user_start, first_end)
    log(f"orchestrator ({label}): {app} SUCCEEDED, "
        f"submit_to_first_step_s {latency:.4f}, phases "
        f"{json.dumps(bd['phases'])}, user_boot "
        f"{json.dumps(bd['user_boot_split'])}, spans "
        f"{json.dumps(bd['span_durations'])}")
    log(f"orchestrator ({label}): {run['tokens_per_sec']:.1f} tokens/s "
        f"submitted vs {in_process:.1f} in process (phase 4), "
        f"{run['step_ms']:.3f} ms/step, launches per step "
        f"{json.dumps(run['launches_per_step'])}, the monitor's peak device "
        f"memory {peak / 2**30:.2f} GiB, processes "
        f"{len(coord)} coordinator / {len(execs)} executor")
    return latency, bd, spans, on_card, run


def import_seconds(*modules):
    """Host seconds a fresh interpreter takes to import ``modules`` one
    after the other, each counted from the start (so the second includes
    the first)."""
    code = ("import importlib, time; t = time.time()\n"
            f"for m in {list(modules)!r}:\n"
            "    importlib.import_module(m); print(time.time() - t)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return [float(x) for x in r.stdout.split()[-len(modules):]]


def alive(pid):
    """Whether ``pid`` runs (a zombie, exited but not reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def cli(*args):
    """``python -m tony_tpu_torch.cli ...``: its exit code and output."""
    r = subprocess.run([sys.executable, "-m", "tony_tpu_torch.cli", *args],
                       cwd=REPO, env=repo_env(), capture_output=True,
                       text=True, timeout=300)
    return r.returncode, r.stdout + r.stderr


def pooled_flagship(tmp, in_process, cold, warm):
    """(d) The flagship submitted against a warm pool of one executor
    (``pool start --size 1``, the default ``torch`` preload): the job
    adopts the warm worker (a ``pool.lease`` span without error, the
    executor's register span ``adopted``), the worker holds no CUDA
    context while warm nor while it runs the job as its executor, and
    ``pool stop`` leaves no worker alive."""
    from tony_tpu_torch import constants
    from tony_tpu_torch.pool import PoolClient

    pool_dir = os.path.join(tmp, "pool")
    base_rows, base_mib = gpu_apps(), gpu_used_mib()
    t0 = time.perf_counter()
    rc, out = cli("pool", "start", "--dir", pool_dir, "--size", "1")
    check(rc == 0, f"pool start exited {rc}: {out[-2000:]}")
    with open(os.path.join(pool_dir, constants.POOL_ADDR_FILE)) as f:
        daemon = int(json.load(f)["pid"])
    client = PoolClient(pool_dir)
    seen_workers = set()
    try:
        deadline = time.monotonic() + 180
        while True:
            st = client.call("pool.status")
            seen_workers |= {w["pid"] for w in st["workers"]}
            if st["ready"] >= 1 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        ready = [w for w in st["workers"] if w["state"] == "ready"]
        check(ready, f"no warm worker became ready: {st}")
        check("torch" in ready[0]["preloaded"],
              f"the warm worker did not preload torch: {ready[0]}")
        idle, idle_mib = gpu_apps(), gpu_used_mib()
        log(f"orchestrator (d): pool ready in {ready_s:.2f} s (start to a "
            f"warm worker), worker pid {ready[0]['pid']} preloaded "
            f"{ready[0]['preloaded']}; nvidia-smi compute processes before "
            f"the pool {base_rows}, while warm {idle}; the card's used "
            f"memory {base_mib:.0f} -> {idle_mib:.0f} MiB")
        # A context would add a row and hold memory (~0.5 GiB on this card).
        check(len(idle) == len(base_rows)
              and ready[0]["pid"] not in {p for p, _ in idle},
              "the idle warm worker holds a CUDA context")
        check(idle_mib - base_mib < 256,
              f"the card's used memory grew {idle_mib - base_mib} MiB with "
              "the warm worker")
        latency, bd, spans, on_card, run = orchestrated_flagship(
            tmp, "pooled", in_process, pool=(pool_dir, daemon))
        lease = [e for e in spans if e["name"] == "pool.lease"]
        reg = [e for e in spans if e["name"] == "executor.register"]
        check(lease and "error" not in lease[0]["args"],
              f"no successful pool.lease span: {lease}")
        check(reg and reg[0]["args"].get("adopted") is True,
              f"the executor's register span is not adopted: {reg}")
        worker = lease[0]["args"]["pid"]
        log(f"orchestrator (d): pool.lease {json.dumps(lease[0]['args'])}, "
            f"{lease[0].get('dur', 0) / 1e3:.3f} ms; executor.register "
            f"{json.dumps(reg[0]['args'])}; during the job at most "
            f"{on_card['max_rows']} compute processes on the card (before "
            f"the pool {len(base_rows)}; the user process adds one), pids "
            f"{sorted(on_card['pids'])}, the adopted executor {worker}")
        check(worker == ready[0]["pid"],
              f"the job adopted pid {worker}, not the warm {ready[0]}")
        check(on_card["max_rows"] <= len(base_rows) + 1
              and worker not in on_card["pids"],
              "the adopted executor held a CUDA context during the job")
        log(f"orchestrator: submit_to_first_step_s cold {cold[0]:.4f} warm "
            f"{warm[0]:.4f} pooled {latency:.4f}; phases cold "
            f"{json.dumps(cold[1]['phases'])} warm "
            f"{json.dumps(warm[1]['phases'])} pooled "
            f"{json.dumps(bd['phases'])}; user_boot pooled "
            f"{json.dumps(bd['user_boot_split'])}; pooled tokens/s "
            f"{run['tokens_per_sec']:.1f} against {in_process:.1f} in "
            "process (phase 4)")
        st = client.call("pool.status")
        seen_workers |= {w["pid"] for w in st["workers"]}
    finally:
        client.close()
        rc, out = cli("pool", "stop", "--dir", pool_dir)
    check(rc == 0, f"pool stop exited {rc}: {out[-2000:]}")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and any(
            alive(p) for p in seen_workers | {daemon}):
        time.sleep(0.2)
    left = sorted(p for p in seen_workers | {daemon} if alive(p))
    log(f"orchestrator (d): pool stopped; daemon {daemon} and workers "
        f"{sorted(seen_workers)} alive after it: {left}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(not left, f"processes of the pool still alive: {left}")


def phase_orchestrator(in_process_tokens_per_sec):
    """Phase 12: the orchestrator's job path on the card."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()     # the submitted job needs the card's memory
    tmp = tempfile.mkdtemp(prefix="chip-smoke-orch-")
    try:
        cold = orchestrated_flagship(tmp, "cold", in_process_tokens_per_sec)
        warm = orchestrated_flagship(tmp, "warm", in_process_tokens_per_sec)
        log(f"orchestrator: submit_to_first_step_s cold {cold[0]:.4f} "
            f"warm {warm[0]:.4f}; phases cold "
            f"{json.dumps(cold[1]['phases'])} warm "
            f"{json.dumps(warm[1]['phases'])}; user_boot cold "
            f"{json.dumps(cold[1]['user_boot_split'])} warm "
            f"{json.dumps(warm[1]['user_boot_split'])}")
        pooled_flagship(tmp, in_process_tokens_per_sec, cold, warm)
        # What the user process's imports are made of: torch alone, then
        # the trainer module (torch and the port's modules), in one
        # interpreter.
        torch_s, trainer_s = import_seconds("torch", "tony_tpu_torch.trainer")
        log(f"orchestrator: import seconds in a fresh interpreter: torch "
            f"{torch_s:.4f}, tony_tpu_torch.trainer (torch included) "
            f"{trainer_s:.4f}")
        rc, text, app, hist, _, _, _ = submit_job(
            tmp, "failing", f"{sys.executable} -c 'import sys; sys.exit(1)'")
        check(rc != 0, f"failing job: the CLI exited 0: {text[-2000:]}")
        status, job_dir, _ = job_history(hist, app)
        check(status == "FAILED", f"failing job: history says {status}")
        from tony_tpu_torch import constants

        with open(os.path.join(job_dir, constants.INCIDENT_FILE)) as f:
            incident = json.load(f)
        verdict = incident.get("verdict") or {}
        log(f"orchestrator (failing): {app} {status}, CLI exit {rc}, "
            f"diagnosis {verdict.get('category')}: "
            f"{str(verdict.get('summary', ''))[:200]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"orchestrator: {time.perf_counter() - t0:.1f} s")
    return cold


# Phase 13: GPipe on the card.
PIPE_MICROBATCHES = (1, 4)
VIRTUAL_STAGES = 4


def small_pipeline():
    """(a) A small f32 pipelined decoder (head_dim 64, 4 layers, M=2) on
    the card against the same weights on the CPU, 3 AdamW steps: the
    losses, the first step's gradients and every parameter after the steps
    within ``TOL_MODEL_REL``. AdamW moves an element by about lr whatever
    its gradient's size, so an element whose gradient is below the card's
    difference from the CPU, and so differs in sign between them, parts
    the two by about 2·lr: one such element of the embedding is 2.8e-4 of
    its norm. Those elements are counted (at most ``TOL_SIGN_SHARE`` of
    the model's) and the parameters are held outside them."""
    from tony_tpu_torch.models.transformer import TransformerConfig
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel import adamw
    from tony_tpu_torch.parallel.pipeline import (PipelineTransformer,
                                                  pipeline_loss)

    cfg = TransformerConfig.tiny(vocab_size=512, dim=256, n_layers=4,
                                 n_heads=4, n_kv_heads=2, mlp_dim=512,
                                 max_seq_len=256)
    m = 2
    cpu = PipelineTransformer(cfg, device="cpu")
    gpu = PipelineTransformer(cfg, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(1))
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (3, 4, 256)))
    losses, grads = {}, {}
    _flash_cuda.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        opt = adamw(model.parameters(), 1e-3)
        got, steps = [], []
        for s in range(3):
            loss = pipeline_loss(model, tokens[s].to(dev), m)
            loss.backward()
            steps.append({k: p.grad.detach().cpu().clone()
                          for k, p in model.named_parameters()})
            opt.step()
            opt.zero_grad(set_to_none=True)
            got.append(loss.item())
        losses[dev], grads[dev] = got, steps
    counts = dict(_flash_cuda.launch_counts)
    grad_err = {k: rel_err(grads["cuda"][0][k], g)
                for k, g in grads["cpu"][0].items()}
    worst = max(grad_err, key=grad_err.get)
    # Elements whose gradient differs in sign at the first step, and at any.
    first = sum(int((c.sign() != grads["cuda"][0][k].sign()).sum())
                for k, c in grads["cpu"][0].items())
    flipped = {k: sum((c[k].sign() != g[k].sign()).int() for c, g in
                      zip(grads["cpu"], grads["cuda"])) > 0
               for k in grads["cpu"][0]}
    n_flipped = sum(int(f.sum()) for f in flipped.values())
    n_all = sum(f.numel() for f in flipped.values())
    on_card = dict(gpu.named_parameters())
    params, kept = {}, {}
    for k, c in cpu.named_parameters():
        g, c = on_card[k].detach().cpu(), c.detach()
        params[k] = rel_err(g, c)
        kept[k] = rel_err(g[~flipped[k]], c[~flipped[k]])
    moved = max(params, key=params.get)
    held = max(kept, key=kept.get)
    rel = max_rel(losses["cuda"], losses["cpu"])
    log(f"pipeline (a) small f32 pipelined decoder (4 layers, M={m}): "
        f"losses card {losses['cuda']} cpu {losses['cpu']} (max rel "
        f"{rel:.3e}); worst first-step grad rel err {grad_err[worst]:.3e} "
        f"({worst}); elements whose gradient differs in sign between card "
        f"and CPU at the first step: {first}, at some step: {n_flipped} of "
        f"{n_all} "
        f"{json.dumps({k: int(f.sum()) for k, f in flipped.items() if f.any()})}"
        f"; after 3 AdamW steps the parameters differ by {params[moved]:.3e}"
        f" at most ({moved}), outside those elements by {kept[held]:.3e} "
        f"({held}); launches {json.dumps(counts)}")
    check(rel <= TOL_MODEL_REL, f"small pipeline losses differ by {rel}")
    check(grad_err[worst] <= TOL_MODEL_REL,
          f"small pipeline {worst} grad rel err {grad_err[worst]}")
    check(n_flipped <= TOL_SIGN_SHARE * n_all,
          f"small pipeline: {n_flipped} gradient signs of {n_all} differ")
    check(kept[held] <= TOL_MODEL_REL,
          f"small pipeline {held} parameter rel err {kept[held]}")
    check_flash_counts("small pipeline", counts, 3 * cfg.n_layers * m)


def pipeline_kind(low):
    """``flagship_kind``, with the f32 head's products apart."""
    if any(w in low for w in ("sgemm", "f32f32", "tf32", "s1688", "simt")):
        return "matmul f32 (the head)"
    return flagship_kind(low)


def pipelined_flagship(card, in_process):
    """(b) The pipelined flagship at full width and depth on the world-1
    mesh (pp=1), M=1 and M=4, 10 AdamW steps each; then one state for
    both M: the first step's gradients at M=1 and M=4, and a profile of a
    step at each."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel.pipeline import (PipelineTransformer,
                                                  pipeline_loss,
                                                  pipeline_train_step)

    full = trainer.flagship_config(seq=2048)
    cfg = earlier(full)
    log(cut_label("pipeline (b): the pipelined flagship", full))
    b, seq = 4, 2048
    head_flop = 3 * 2 * b * seq * cfg.dim * cfg.vocab_size
    log(f"pipeline (b): the f32 head's products (forward, and the two of "
        f"the backward) {head_flop / 1e12:.4f} TFLOP per step, "
        f"{head_flop / PEAK_F32 * 1e3:.2f} ms at the f32 peak of "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s; {card}")
    runs, launches = {}, {}
    for m in PIPE_MICROBATCHES:
        gc.collect()
        torch.cuda.empty_cache()
        _flash_cuda.reset_launch_counts()
        r = trainer.measure(
            cfg, batch=b, seq=seq, steps=STEPS, warmup=2, device="cuda",
            seed=0, mesh="pp=1", model=functools.partial(
                PipelineTransformer, num_microbatches=m))
        counts = dict(_flash_cuda.launch_counts)
        runs[m], launches[m] = r, counts
        log(f"pipeline (b) M={m}: {r['params']} params, "
            f"{r['tokens_per_sec']:.1f} tokens/s (phase 4 in process: "
            f"{in_process:.1f}), {r['step_ms']:.3f} ms/step, MFU "
            f"{r['mfu_vs_peak_bf16']}, peak memory "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, mesh "
            f"{json.dumps(r['mesh'])}, launches {json.dumps(counts)}, "
            f"losses {r['losses']}; {card}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"pipelined M={m}: non-finite loss")
        expected = math.log(cfg.vocab_size) + 0.5
        check(abs(r["losses"][0] - expected) <= 0.5,
              f"pipelined M={m}: first loss {r['losses'][0]} not near "
              "ln(vocab) + 1/2")
        check_flash_counts(f"pipelined M={m}", counts,
                           cfg.n_layers * m * STEPS)
    a, c = (runs[m]["losses"] for m in PIPE_MICROBATCHES)
    rel = max_rel(c, a)
    log(f"pipeline (b): M={PIPE_MICROBATCHES[1]} against "
        f"M={PIPE_MICROBATCHES[0]}: largest relative loss difference "
        f"{rel:.3e} (limit {TOL_PIPE_M_REL}), first losses "
        f"{a[0]} / {c[0]}")
    check(rel <= TOL_PIPE_M_REL, f"pipelined M=1 and M=4 losses differ by "
          f"{rel}")

    gc.collect()
    torch.cuda.empty_cache()
    with trainer.mesh_scope("pp=1", torch.device("cuda")) as mesh:
        state = trainer.build_state(cfg, "cuda", seed=0, mesh=mesh,
                                    model=PipelineTransformer)
        batch = synthetic_lm_batch(0, b, seq, cfg.vocab_size,
                                   device="cuda", mesh=mesh)
        grads = {}
        for m in PIPE_MICROBATCHES:
            pipeline_loss(state.model, batch["tokens"], m).backward()
            grads[m] = torch.cat([_local(p.grad).float().flatten()
                                  for p in state.model.parameters()])
            state.model.zero_grad(set_to_none=True)
        grad_rel = rel_err(*(grads[m] for m in PIPE_MICROBATCHES[::-1]))
        del grads
        log(f"pipeline (b): the first step's gradients at "
            f"M={PIPE_MICROBATCHES[1]} against M={PIPE_MICROBATCHES[0]} on "
            f"the same weights and batch: rel Frobenius err {grad_rel:.3e} "
            f"(limit {TOL_ACCUM_REL})")
        check(grad_rel <= TOL_ACCUM_REL, f"pipelined M=1 and M=4 gradients "
              f"differ by {grad_rel}")
        for m in PIPE_MICROBATCHES:
            for _ in range(2):
                pipeline_train_step(mesh, state, batch, m)
            profile(f"pipelined flagship M={m} on the world-1 mesh",
                    lambda: pipeline_train_step(mesh, state, batch, m),
                    pipeline_kind)
        del state
    return {"runs": runs, "launches": launches}


def device_ms(fn, reps=5):
    """Milliseconds of kernel time per call of ``fn``: the device's own
    time, summed by torch.profiler over ``reps`` calls after a warm one
    (CUDA events around an eager call that launches many small kernels
    time the host's launches instead)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / reps / 1e3


def virtual_stages(card):
    """(c) The flagship's 16 layers as four virtual stages of four on one
    card: one stage's tick (forward + backward of its layers on one B1
    S2048 microbatch) against the whole stack's step on B4 / 4, and the
    schedule's (M + S - 1) ticks at M=4, each by CUDA events (what an
    eager step waits for, the host's launches included) and by the
    device's kernel time (what the schedule costs the card)."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.parallel.pipeline import PipelineTransformer

    cfg = trainer.flagship_config(seq=2048)
    n, m, seq = VIRTUAL_STAGES, 4, 2048
    gc.collect()
    torch.cuda.empty_cache()
    model = PipelineTransformer(cfg, device="cuda")
    blocks = list(model.layers.values())
    per = len(blocks) // n
    gen = torch.Generator("cuda").manual_seed(17)

    def fwd_bwd(layers, rows):
        x = torch.randn((rows, seq, cfg.dim), device="cuda", generator=gen,
                        dtype=cfg.dtype).requires_grad_()
        dy = torch.randn_like(x)
        pos = torch.arange(seq, device="cuda").expand(rows, seq)
        params = [p for blk in layers for p in blk.parameters()]

        def run():
            h = x
            for blk in layers:
                h = blk(h, pos)
            torch.autograd.grad((h.float() * dy.float()).sum(),
                                [x] + params)
        return run

    stages = [fwd_bwd(blocks[s * per:(s + 1) * per], 1) for s in range(n)]
    whole_fn = fwd_bwd(blocks, m)
    out = {}
    for clock, timer in (("events", lambda f, r: cuda_ms(f, reps=r)),
                         ("device", lambda f, r: device_ms(f, reps=r))):
        tick = [timer(f, 10) for f in stages]
        whole = timer(whole_fn, 5)
        tick_ms = statistics.median(tick)
        schedule = (m + n - 1) * tick_ms
        ideal = whole / n
        bubble = 1 - ideal / schedule
        out[clock] = (tick, whole, bubble)
        log(f"pipeline (c) {n} virtual stages of {per} layers, microbatch "
            f"B1 S{seq}, M={m}, by {clock}: tick (forward + backward of one "
            f"stage) ms per stage {json.dumps([round(t, 4) for t in tick])}"
            f"; the whole 16-layer stack on B{m} {whole:.4f} ms, / {n} = "
            f"{ideal:.4f}; {m} ticks {m * tick_ms:.4f} ms against it "
            f"({m * tick_ms / ideal:.4f}); the schedule's (M + S - 1) x "
            f"tick {schedule:.4f} ms; measured bubble {bubble:.4f} against "
            f"(S - 1) / (M + S - 1) = {(n - 1) / (m + n - 1):.4f}; {card}")
    check(all(math.isfinite(t) and t > 0 for clock in out.values()
              for t in clock[0] + [clock[1]]),
          "virtual stages: a timing is not positive")
    del model, blocks, stages, whole_fn


def phase_pipeline(in_process, card):
    """Phase 13: GPipe on the card."""
    t0 = time.perf_counter()
    small_pipeline()
    t1 = time.perf_counter()
    runs = pipelined_flagship(card, in_process)
    log(f"pipeline (b): {time.perf_counter() - t1:.1f} s")
    virtual_stages(card)
    log(f"pipeline: {time.perf_counter() - t0:.1f} s for parts (a)-(c)")
    return runs


# Phase 14: surviving failures on the card.
# ~26 s of flagship steps at phase 4's ~85 ms: (a) outlives the outage,
# and (b) still runs when the migration lands, after the first step's
# save (~12 s of the writer) is durable.
FAIL_STEPS = 300
# (a)'s job: it outlives the outage (~1 s) by ~12 s of steps.
RECOVER_STEPS = 150
FAIL_MIGRATE_AT = 5       # migrate once the job reports this many steps
# Above FAIL_STEPS: the interval policy saves the first step only, so the
# drain's save is the one that carries the state across the move.
FAIL_SAVE_EVERY = 10_000
# The migrated job's drain grace. The key's default is 15 s; the drain
# save of the flagship's ~3.8 GB is printed against it.
FAIL_DRAIN_GRACE_S = 60
FAIL_TIMEOUT_S = 600
# (b)'s checkpoints go to the object store (phase 19). Its first save
# takes ~12-20 s (a local one ~10-13) while the job trains on, and the move
# waits for it: 50 steps more than the uninterrupted run, so that the
# drain lands well before the end (it landed at steps 182-258 on an H100
# 80GB HBM3 at 700 W). The uninterrupted losses hold its first 300.
STORE_MIGRATE_URL = "gs://tony-ckpt/migrate"
MIGRATE_STEPS = FAIL_STEPS + 50
TRAINER = f"{sys.executable} -m tony_tpu_torch.trainer"


def failure_conf(hist, command, extra=()):
    """The settings of a one-worker pytorch job of phase 14: the recovery
    drills' cadences (tests/test_torch_e2e_recovery.py), so that the
    executor sees its coordinator gone within a second. A job submitted
    through the client keeps ``num-clients-to-wait``: its coordinator
    waits for the client to read the final report."""
    from tony_tpu_torch.conf import keys as K

    return [(K.APPLICATION_FRAMEWORK, "pytorch"),
            (K.APPLICATION_BACKEND, "local"),
            ("tony.worker.instances", 1),
            ("tony.worker.command", command),
            (K.HISTORY_LOCATION, hist),
            (K.APPLICATION_TIMEOUT_S, FAIL_TIMEOUT_S),
            (K.TASK_REGISTRATION_TIMEOUT_S, 300),
            (K.COORDINATOR_MONITOR_INTERVAL_MS, 100),
            (K.APPLICATION_RETRY_COUNT, 1),
            (K.TASK_HEARTBEAT_INTERVAL_MS, 200),
            (K.TASK_COORDINATOR_LOSS_HEARTBEATS, 2),
            (K.TASK_ORPHAN_DEADLINE_S, 120),
            (K.COORDINATOR_REREGISTRATION_GRACE_S, 90),
            (K.RPC_MAX_RETRIES, 2),
            (K.RPC_RETRY_SLEEP_S, 0.2),
            (K.RPC_CALL_TIMEOUT_S, 5.0), *extra]


def coordinator_rpc(job_dir, timeout=120):
    """An RpcClient to the job's coordinator, from its address file."""
    from tony_tpu_torch.rpc.wire import RpcClient

    addr_file = os.path.join(job_dir, "coordinator.addr")
    deadline = time.monotonic() + timeout
    while not os.path.exists(addr_file):
        check(time.monotonic() < deadline,
              f"no coordinator address at {addr_file}")
        time.sleep(0.1)
    with open(addr_file) as f:
        addr = json.load(f)
    return RpcClient(addr["host"], addr["port"],
                     token=addr.get("token") or None, max_retries=2,
                     retry_sleep_s=0.1)


def poll(fn, what, timeout=300, interval=0.2):
    """``fn()`` once it is true; an RPC error while the coordinator
    (re)starts counts as false."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = fn()
        except Exception:  # noqa: BLE001 — the coordinator is (re)starting
            got = None
        if got:
            return got
        time.sleep(interval)
    check(False, f"timed out waiting for {what}")


def job_steps(rpc):
    """The job's step count, from its worker's progress beacon."""
    live = rpc.call("metrics.live")
    return max([t.get("steps", 0) or 0 for t in live.get("tasks", [])]
               or [0])


def journal(hist, app):
    """The job's write-ahead journal records."""
    from tony_tpu_torch import constants

    path = os.path.join(hist, constants.HISTORY_INTERMEDIATE, app,
                        constants.JOURNAL_FILE)
    records = []
    with open(path) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except ValueError:
                break         # the record being written now
    return records


def first_after(records, index, kind):
    """The first record of ``kind`` after ``records[index]``."""
    return next((r for r in records[index + 1:] if r.get("t") == kind),
                None)


def kill_app(app):
    """SIGKILL every process whose environment carries the job's id (its
    executors and user processes) — the clean-up of a failed drill."""
    import signal

    needle = f"TONY_APP_ID={app}\0".encode()
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if needle in f.read() + b"\0":
                    os.kill(int(pid), signal.SIGKILL)
        except OSError:
            continue


def check_job_launches(label, run, steps, total=FAIL_STEPS):
    """The job's trainer launched 16 of each flash kernel per step it ran
    (its counters count this process's launches, its JSON divides them by
    ``--steps``, ``total``), so no step ran twice in it."""
    from tony_tpu_torch.ops import _flash_cuda

    for name in _flash_cuda.KERNELS:
        got = round(run["launches_per_step"][name] * total)
        check(got == 16 * steps, f"{label}: {name} launched {got} times "
              f"in {steps} steps, expected {16 * steps}")


def worker_run(work, app):
    """The last JSON line of the job's trainer, and its stderr."""
    run = json.loads(job_task_log(work, app).strip().splitlines()[-1])
    return run, job_task_log(work, app, "stderr.log")


def held_to(label, losses, want, start):
    """``losses`` (steps start, start + 1, ...) are finite and within
    ``TOL_RESUME_REL`` of the uninterrupted run's same steps."""
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    err = max_rel(losses, want[start:start + len(losses)])
    check(err <= TOL_RESUME_REL, f"{label}: losses {err:.3e} from the "
          f"uninterrupted run's, limit {TOL_RESUME_REL}")
    return err


def recover_drill(tmp, corpus, want, card):
    """(a) The operator flow of a coordinator crash: the coordinator of a
    one-worker flagship job is SIGKILLed after the first step, and
    ``cli recover`` brings the job home with the same worker process."""
    from tony_tpu_torch import constants
    from tony_tpu_torch.conf import keys as K
    from tony_tpu_torch.conf.config import TonyTpuConfig

    # Unique per run: kill_app's clean-up finds the job's processes by it.
    app = f"chip_smoke_recover_{uuid.uuid4().hex[:8]}"
    base = os.path.join(tmp, "recover")
    hist, work = os.path.join(base, "history"), os.path.join(base, "work")
    job_dir = os.path.join(work, "jobs", app)
    os.makedirs(job_dir)
    conf = TonyTpuConfig()
    # No client: the coordinator must not wait for one.
    for k, v in failure_conf(
            hist, f"exec {TRAINER} --data {corpus} --steps {RECOVER_STEPS}",
            extra=[(K.APPLICATION_NUM_CLIENTS_TO_WAIT, False)]):
        conf.set(k, v)
    frozen = conf.freeze(os.path.join(job_dir, constants.FINAL_CONFIG_FILE))
    argv = [sys.executable, "-m", "tony_tpu_torch.coordinator",
            "--conf", frozen, "--app-id", app, "--history-root", hist,
            "--workdir", os.path.join(job_dir, "tasks"),
            "--addr-file", os.path.join(job_dir, "coordinator.addr"),
            "--user", "chip-smoke"]
    procs = []
    try:
        with open(os.path.join(base, "coordinator.log"), "ab") as out:
            procs.append(subprocess.Popen(argv, cwd=REPO, env=repo_env(),
                                          stdout=out,
                                          stderr=subprocess.STDOUT))
        rpc = coordinator_rpc(job_dir)
        poll(lambda: job_steps(rpc) >= 1, "the first step")
        rpc.close()
        pgid = os.path.join(job_dir, "tasks", "worker_0",
                            constants.USER_PGID_FILE)
        with open(pgid) as f:
            pid = int(f.read().strip())
        killed_at = time.time()
        procs[0].kill()
        procs[0].wait(timeout=60)
        os.unlink(os.path.join(job_dir, "coordinator.addr"))
        t0 = time.perf_counter()
        with open(os.path.join(base, "recover.log"), "ab") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tony_tpu_torch.cli", "recover", app,
                 "--workdir", work], cwd=REPO, env=repo_env(), stdout=out,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 120
        while True:
            recs = journal(hist, app)
            gens = [i for i, r in enumerate(recs)
                    if r.get("t") == "gen" and r.get("generation") == 2]
            reg = first_after(recs, gens[-1], "register") if gens else None
            if reg is not None:
                break
            check(time.monotonic() < deadline and procs[1].poll() is None,
                  "the worker never re-registered with the recovered "
                  "coordinator")
            time.sleep(0.05)
        outage = reg["ts"] / 1e3 - killed_at
        with open(pgid) as f:
            same = int(f.read().strip()) == pid and alive(pid)
        check(same, f"the worker's process {pid} did not survive the "
              "outage")
        rc = procs[1].wait(timeout=FAIL_TIMEOUT_S)
        recover_s = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        kill_app(app)
    with open(os.path.join(base, "recover.log"), errors="replace") as f:
        text = f.read()
    check(rc == 0, f"recover exited {rc}: {text[-3000:]}\n"
          f"{job_task_log(work, app, 'stderr.log')[-3000:]}")
    status, job_dir_hist, _ = job_history(hist, app)
    check(status == "SUCCEEDED", f"recovered job: history says {status}")
    epochs = [r["session"] for r in journal(hist, app)
              if r.get("t") == "epoch"]
    check(epochs == [0], f"recovered job: epochs {epochs}, expected [0]")
    run, _ = worker_run(work, app)
    check(len(run["losses"]) == RECOVER_STEPS and run["start_step"] == 0,
          f"recovered job: {len(run['losses'])} losses from step "
          f"{run['start_step']}")
    check_job_launches("recovered job", run, RECOVER_STEPS,
                       total=RECOVER_STEPS)
    err = held_to("recovered job", run["losses"][:20], want, 0)
    log(f"failures (a) coordinator SIGKILL + cli recover: {app} SUCCEEDED "
        f"in one epoch, worker pid {pid} unchanged, outage (SIGKILL to the "
        f"worker's re-registration) {outage:.4f} s, recover's wall "
        f"{recover_s:.4f} s, {RECOVER_STEPS} steps with 16 launches of each "
        f"flash kernel per step, first 20 losses {err:.3e} from the "
        f"uninterrupted run's; {card}")
    return job_dir_hist


def migrate_drill(tmp, corpus, want, card, ckpt_url=None,
                  steps=FAIL_STEPS):
    """(b) ``cli migrate`` of a one-worker elastic flagship job of
    ``steps`` steps: the drain TERMs the trainer, its handler saves the
    state of the last whole step, and the relaunched trainer resumes from
    it with no step re-run; its losses are held to ``want``'s same steps
    (as far as ``want`` goes). With ``ckpt_url`` (the store's, as phase
    14 b runs it) the checkpoints go there, named by the job's
    ``tony.application.checkpoint-dir`` and not in the command. Returns the
    job dir and the drain save's seconds."""
    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.conf import keys as K

    base = os.path.join(tmp, "migrate")
    hist, work = os.path.join(base, "history"), os.path.join(base, "work")
    command = (f"exec {TRAINER} --data {corpus} --steps {steps} "
               f"--save-every {FAIL_SAVE_EVERY}")
    extra = [(K.ELASTIC_ENABLED, True),
             (K.ELASTIC_DRAIN_GRACE_S, FAIL_DRAIN_GRACE_S)]
    if ckpt_url is None:
        ckpt = os.path.join(base, "ckpt")
        command += f" --ckpt-dir {ckpt}"
    else:
        ckpt = ckpt_url
        extra.append((K.APPLICATION_CHECKPOINT_DIR, ckpt))
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "submit",
            "--workdir", work]
    for k, v in failure_conf(hist, command, extra=extra):
        argv += ["--conf", f"{k}={v}"]
    os.makedirs(base)
    out_path = os.path.join(base, "submit.log")
    app = None
    with open(out_path, "w") as out:
        submit = subprocess.Popen(argv, cwd=REPO, env=repo_env(),
                                  stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while app is None:
            with open(out_path) as f:
                m = re.search(r"submitted application (\S+)", f.read())
            app = m.group(1) if m else None
            check(app or (time.monotonic() < deadline
                          and submit.poll() is None),
                  "migrate: no application id from the CLI")
            time.sleep(0.1)
        rpc = coordinator_rpc(os.path.join(work, "jobs", app))
        mgr = CheckpointManager(ckpt)
        # A store lists only steps whose manifest object exists.
        poll(lambda: job_steps(rpc) >= FAIL_MIGRATE_AT
             and (0 in mgr.all_steps() if ckpt_url
                  else os.path.exists(mgr.manifest_path(0))),
             f"step {FAIL_MIGRATE_AT} and the first step's save")
        requested = time.time()
        r = subprocess.run([sys.executable, "-m", "tony_tpu_torch.cli",
                            "migrate", app, "slice-1", "--workdir", work],
                           cwd=REPO, env=repo_env(), capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f"cli migrate exited {r.returncode}: "
              f"{r.stdout}{r.stderr}")

        def applied():
            recs = journal(hist, app)
            done = [i for i, x in enumerate(recs) if x.get("t") == "migrate"
                    and x.get("phase") == "applied"]
            report = rpc.call("get_application_report")
            return done and first_after(recs, done[-1], "register") \
                and not (report.get("elastic") or {}).get("resizing")
        poll(applied, "the migration to land",
             timeout=FAIL_DRAIN_GRACE_S + 240)
        rpc.close()
        rc = submit.wait(timeout=FAIL_TIMEOUT_S)
    finally:
        if submit.poll() is None:
            submit.terminate()       # the CLI kills its application
            submit.wait(timeout=120)
        if app:
            kill_app(app)
    with open(out_path, errors="replace") as f:
        text = f.read()
    check(rc == 0, f"migrate: the CLI exited {rc}: {text[-3000:]}\n"
          f"{job_task_log(work, app, 'stderr.log')[-3000:]}")
    status, job_dir, _ = job_history(hist, app)
    check(status == "SUCCEEDED", f"migrated job: history says {status}")
    recs = journal(hist, app)
    epochs = [x["session"] for x in recs if x.get("t") == "epoch"]
    moves = [(i, x) for i, x in enumerate(recs) if x.get("t") == "migrate"]
    check(epochs == [0] and [x["phase"] for _, x in moves]
          == ["start", "applied"], f"migrated job: epochs {epochs}, "
          f"migrate records {[x for _, x in moves]}")
    reg = first_after(recs, moves[-1][0], "register")
    wall = reg["ts"] / 1e3 - requested
    run, err_log = worker_run(work, app)
    saved = re.search(r"saving preemption checkpoint at step (\d+)",
                      err_log)
    durable = re.search(r"preemption checkpoint durable in ([\d.]+) s",
                        err_log)
    check(saved and durable, "migrated job: the drained trainer logged no "
          f"preemption save: {err_log[-3000:]}")
    k = int(saved.group(1))
    start = run["start_step"]
    check(run["restored_step"] == k and start == k + 1,
          f"migrated job: the drain saved step {k}, the relaunch restored "
          f"{run['restored_step']} and started at {start}: "
          f"{k + 1 - start} steps re-run")
    check(len(run["losses"]) == steps - start,
          f"migrated job: {len(run['losses'])} losses from step {start}")
    check_job_launches("migrated job", run, steps - start, total=steps)
    check(start < len(want), f"migrated job: the drain landed at step {k}, "
          f"after the uninterrupted run's {len(want)} steps")
    err = held_to("migrated job", run["losses"][:len(want) - start], want,
                  start)
    mgr = CheckpointManager(ckpt)
    size = mgr.step_bytes(k)
    if ckpt_url is not None:
        kept = mgr.all_steps()
        check(kept == [0, k, steps - 1] and mgr.verify_step(k),
              f"migrated job: the store holds steps {kept}, expected "
              f"the first, the drain's and the last: [0, {k}, "
              f"{steps - 1}]")
        stray = [os.path.join(r, d) for r, ds, _ in os.walk(work)
                 for d in ds if d == "gs:"]
        check(not stray, f"migrated job: {stray} on local disk")
    mgr.close()
    drain_s = float(durable.group(1))
    where = f" ({ckpt})" if ckpt_url else ""
    log(f"failures (b) cli migrate {app} slice-1{where}: SUCCEEDED, one "
        f"epoch, "
        f"REC_MIGRATE start and applied; the drain's save of step {k} "
        f"{size / 2**30:.3f} GiB in {drain_s:.3f} s "
        f"(tony.elastic.drain-grace-s default 15 s; this job's "
        f"{FAIL_DRAIN_GRACE_S} s), the relaunch's restore "
        f"{run['restore_s']:.3f} s and start at step {start}: "
        f"{k + 1 - start} steps re-run; migration wall (request to the "
        f"relaunched worker's re-registration) {wall:.4f} s; "
        f"{steps - start} steps with 16 launches of each flash kernel "
        f"per step, losses {err:.3e} from the uninterrupted run's (to step "
        f"{len(want) - 1}); {card}")
    return job_dir, drain_s


def phase_failures(card):
    """Phase 14: surviving failures on the card. (b)'s store is a
    ``FakeGcsStore`` under a temporary ``TONY_FAKE_GCS_ROOT``, set in this
    process's environment only while the phase runs."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.storage.store import FAKE_GCS_ROOT_ENV

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fail-")
    previous = os.environ.get(FAKE_GCS_ROOT_ENV)
    try:
        cfg = trainer.flagship_config(seq=2048)
        corpus = trainer.write_corpus(os.path.join(tmp, "corpus.bin"),
                                      cfg.vocab_size)
        ref = trainer.train(cfg, corpus, batch=4, seq=2048,
                            steps=FAIL_STEPS)
        want = ref["losses"]
        del ref
        gc.collect()
        torch.cuda.empty_cache()   # the jobs need the card's memory
        recovered = recover_drill(tmp, corpus, want, card)
        os.environ[FAKE_GCS_ROOT_ENV] = os.path.join(tmp, "gcs")
        moved, drain_s = migrate_drill(tmp, corpus, want, card,
                                       ckpt_url=STORE_MIGRATE_URL,
                                       steps=MIGRATE_STEPS)
        for job_dir in (recovered, moved):
            r = subprocess.run([sys.executable, "-m", "tony_tpu_torch.cli",
                                "check", job_dir], cwd=REPO, env=repo_env(),
                               capture_output=True, text=True, timeout=300)
            check(r.returncode == 0, f"cli check {job_dir} exited "
                  f"{r.returncode}: {r.stdout[-3000:]}{r.stderr[-2000:]}")
        log("failures (c) cli check: both job dirs clean")
    finally:
        if previous is None:
            os.environ.pop(FAKE_GCS_ROOT_ENV, None)
        else:
            os.environ[FAKE_GCS_ROOT_ENV] = previous
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"failures: {time.perf_counter() - t0:.1f} s")
    return want, drain_s


# Phase 15: the GPU host backend and the fleet on the card.
# The fleet's job: phase 14's corpus and seed, so phase 14's uninterrupted
# losses hold its steps; migrated once it is past FLEET_MIGRATE_AFTER.
FLEET_STEPS = 150
FLEET_MIGRATE_AFTER = 20
FLEET_TIMEOUT_S = 480
TASK_ENV_FILE = "task_env.txt"


def host_backend_job(tmp, in_process, cold, card):
    """(a) The flagship, 10 steps, submitted on the ``gpu-host`` backend
    with the fake provisioner (one LocalSim host): the task runs under
    ``<workdir>/<host id>/`` with the backend's host env and nothing of
    libtpu, 16 launches of each flash kernel per step, and ``cli check``
    clean on the job dir."""
    from tony_tpu_torch.ops import _flash_cuda

    command = (f"env > {TASK_ENV_FILE} && exec {TRAINER} --model flagship "
               f"--steps {STEPS}")
    rc, text, app, hist, work, cmdlines, _ = submit_job(
        tmp, "gpu-host", command, backend="gpu-host",
        conf=["tony.slice.provisioner=fake", "tony.slice.num-hosts=1"])
    tasks = os.path.join(work, "jobs", app, "tasks")
    hosts = sorted(os.listdir(tasks)) if os.path.isdir(tasks) else []
    check(rc == 0 and hosts, f"gpu-host: the CLI exited {rc}, task dirs "
          f"{hosts}: {text[-3000:]}")
    task_dir = os.path.join(tasks, hosts[0], "worker_0")
    with open(os.path.join(task_dir, "stderr.log"), errors="replace") as f:
        err_text = f.read()
    status, job_dir, _ = job_history(hist, app)
    check(status == "SUCCEEDED", f"gpu-host: history says {status}: "
          f"{err_text[-3000:]}")
    check(hosts == ["fakehost-0"] and os.listdir(os.path.join(
        tasks, hosts[0])) == ["worker_0"],
        f"gpu-host: the task ran under {hosts}, not <workdir>/fakehost-0/")
    env = {}
    with open(os.path.join(task_dir, TASK_ENV_FILE), errors="replace") as f:
        for line in f:
            k, sep, v = line.rstrip("\n").partition("=")
            if sep:
                env[k] = v
    tpu = sorted(k for k in env if k.startswith("TPU_WORKER_"))
    check(env.get("TONY_HOST_ID") == hosts[0]
          and env.get("TONY_HOST_LOCAL_ORDINAL") == "0" and not tpu
          and env.get("CUDA_VISIBLE_DEVICES")
          == os.environ.get("CUDA_VISIBLE_DEVICES"),
          f"gpu-host: the task's host env TONY_HOST_ID="
          f"{env.get('TONY_HOST_ID')} TONY_HOST_LOCAL_ORDINAL="
          f"{env.get('TONY_HOST_LOCAL_ORDINAL')}, libtpu's {tpu}, "
          f"CUDA_VISIBLE_DEVICES={env.get('CUDA_VISIBLE_DEVICES')}")
    with open(os.path.join(task_dir, "stdout.log"), errors="replace") as f:
        run = json.loads(f.read().strip().splitlines()[-1])
    check(all(math.isfinite(x) for x in run["losses"]),
          f"gpu-host: non-finite loss {run['losses']}")
    for name in _flash_cuda.KERNELS:
        check(run["launches_per_step"][name] == 16,
              f"gpu-host: {name} {run['launches_per_step'][name]} launches "
              "per step, expected 16")
    check(any("-m tony_tpu_torch.coordinator" in c for c in cmdlines)
          and any("-m tony_tpu_torch.executor" in c for c in cmdlines),
          f"gpu-host: no coordinator or executor of the port among "
          f"{sorted(cmdlines)}")
    bad = [c for c in cmdlines if REFERENCE_MODULE.search(c)]
    check(not bad, f"gpu-host: a process ran the reference: {bad}")
    latency, bd, _, _, _ = first_step_latency(job_dir)
    rc, out = cli("check", job_dir)
    check(rc == 0, f"gpu-host: cli check exited {rc}: {out[-3000:]}")
    log(f"host backend (a) gpu-host + fake provisioner: {app} SUCCEEDED on "
        f"host {env['TONY_HOST_ID']} (TONY_HOST_LOCAL_ORDINAL "
        f"{env['TONY_HOST_LOCAL_ORDINAL']}, no TPU_WORKER_*), "
        f"submit_to_first_step_s {latency:.4f} against phase 12's cold "
        f"local backend {cold[0]:.4f}; phases {json.dumps(bd['phases'])} "
        f"against {json.dumps(cold[1]['phases'])}; "
        f"{run['tokens_per_sec']:.1f} tokens/s against {in_process:.1f} in "
        f"process (phase 4), {run['step_ms']:.3f} ms/step, launches per "
        f"step {json.dumps(run['launches_per_step'])}; cli check clean; "
        f"{card}")


def fleet_rows(fleet_dir):
    """The fleet's job rows by job id, from a live daemon."""
    from tony_tpu_torch.fleet.client import FleetClient

    client = FleetClient(fleet_dir)
    try:
        return {r["job"]: r for r in client.status().get("jobs", [])}
    finally:
        client.close()


def fleet_job(tmp, want, card):
    """(b) The flagship as phase 14 (b)'s elastic job, submitted through
    ``cli fleet`` to a daemon of two one-host slices backed by a warm pool
    of one executor, moved to slice 1 by ``fleet migrate`` once it is past
    step ``FLEET_MIGRATE_AFTER``: no step re-run, the losses phase 14's
    uninterrupted run's, ``cli check`` clean on the fleet dir."""
    from tony_tpu_torch import constants, trainer
    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.conf import keys as K
    from tony_tpu_torch.fleet import ledger as fledger

    cfg = trainer.flagship_config(seq=2048)
    corpus = trainer.write_corpus(os.path.join(tmp, "corpus.bin"),
                                  cfg.vocab_size)
    pool_dir = os.path.join(tmp, "pool")
    fleet_dir = os.path.join(tmp, "fleet")
    hist = os.path.join(fleet_dir, "history")
    ckpt = os.path.join(tmp, "ckpt")
    command = (f"exec {TRAINER} --data {corpus} --steps {FLEET_STEPS} "
               f"--ckpt-dir {ckpt} --save-every {FAIL_SAVE_EVERY}")
    # Phase 14's job settings; the fleet sets the gang size, the backend's
    # pool dir and the history root.
    own = {K.APPLICATION_BACKEND, "tony.worker.instances",
           K.HISTORY_LOCATION}
    conf = [(k, v) for k, v in failure_conf(hist, command, extra=[
        (K.ELASTIC_ENABLED, True),
        (K.ELASTIC_DRAIN_GRACE_S, FAIL_DRAIN_GRACE_S)]) if k not in own]
    t0 = time.perf_counter()
    rc, out = cli("pool", "start", "--dir", pool_dir, "--size", "1")
    check(rc == 0, f"fleet: pool start exited {rc}: {out[-2000:]}")
    with open(os.path.join(pool_dir, constants.POOL_ADDR_FILE)) as f:
        pool_pid = int(json.load(f)["pid"])
    daemon, job, app, top = None, None, None, ""
    try:
        rc, out = cli("fleet", "start", "--dir", fleet_dir, "--slices", "2",
                      "--hosts-per-slice", "1", "--pool-dir", pool_dir,
                      "--conf", f"{K.FLEET_TICK_INTERVAL_S}=0.2")
        check(rc == 0, f"fleet start exited {rc}: {out[-2000:]}")
        with open(os.path.join(fleet_dir, constants.FLEET_ADDR_FILE)) as f:
            daemon = int(json.load(f)["pid"])
        argv = ["fleet", "submit", "--dir", fleet_dir, "--tenant",
                "chip-smoke", "--hosts", "1", "--model", "flagship"]
        for k, v in conf:
            argv += ["--conf", f"{k}={v}"]
        rc, out = cli(*argv)
        m = re.search(r"queued (\S+)", out)
        check(rc == 0 and m, f"fleet submit exited {rc}: {out[-2000:]}")
        job = m.group(1)
        work = os.path.join(fleet_dir, "jobs", job)
        row = poll(lambda: (lambda r: r if r.get("state") == "RUNNING"
                            and r.get("app_id") else None)(
                                fleet_rows(fleet_dir).get(job, {})),
                   f"{job} granted and its application found")
        app = row["app_id"]
        rpc = coordinator_rpc(os.path.join(work, "jobs", app))
        poll(lambda: job_steps(rpc) > FLEET_MIGRATE_AFTER,
             f"{job} past step {FLEET_MIGRATE_AFTER}")
        requested = time.time()
        rc, out = cli("fleet", "migrate", "--dir", fleet_dir, job, "1")
        check(rc == 0, f"fleet migrate exited {rc}: {out[-2000:]}")

        def applied():
            recs = journal(hist, app)
            done = [i for i, x in enumerate(recs) if x.get("t") == "migrate"
                    and x.get("phase") == "applied"]
            report = rpc.call("get_application_report")
            return done and first_after(recs, done[-1], "register") \
                and not (report.get("elastic") or {}).get("resizing")
        poll(applied, "the migration to land",
             timeout=FAIL_DRAIN_GRACE_S + 240)
        rpc.close()
        row = poll(lambda: (lambda r: r if r.get("state") in (
            "FINISHED", "FAILED", "CANCELLED") else None)(
                fleet_rows(fleet_dir).get(job, {})),
            f"{job} to finish", timeout=FLEET_TIMEOUT_S)
        rc, top = cli("fleet", "top", "--dir", fleet_dir, "--once")
        check(rc == 0, f"fleet top exited {rc}: {top[-2000:]}")
    finally:
        if daemon is not None:
            cli("fleet", "stop", "--dir", fleet_dir)
        cli("pool", "stop", "--dir", pool_dir)
        if app:
            kill_app(app)
        left = [p for p in (daemon, pool_pid) if p is not None]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and any(alive(p) for p in left):
            time.sleep(0.2)
    left = [p for p in (daemon, pool_pid) if p is not None and alive(p)]
    check(not left, f"fleet: daemon processes still alive: {left}")
    check(row["state"] == "FINISHED", f"fleet: {job} ended {row['state']}:"
          f" {job_task_log(work, app, 'stderr.log')[-3000:]}")
    recs = journal(hist, app)
    epochs = [x["session"] for x in recs if x.get("t") == "epoch"]
    moves = [(i, x) for i, x in enumerate(recs) if x.get("t") == "migrate"]
    check(epochs == [0] and [x["phase"] for _, x in moves]
          == ["start", "applied"], f"fleet job: epochs {epochs}, migrate "
          f"records {[x for _, x in moves]}")
    reg = first_after(recs, moves[-1][0], "register")
    wall = reg["ts"] / 1e3 - requested
    run, err_log = worker_run(work, app)
    saved = re.search(r"saving preemption checkpoint at step (\d+)",
                      err_log)
    durable = re.search(r"preemption checkpoint durable in ([\d.]+) s",
                        err_log)
    check(saved and durable, "fleet job: the drained trainer logged no "
          f"preemption save: {err_log[-3000:]}")
    k = int(saved.group(1))
    start = run["start_step"]
    check(run["restored_step"] == k and start == k + 1,
          f"fleet job: the drain saved step {k}, the relaunch restored "
          f"{run['restored_step']} and started at {start}: "
          f"{k + 1 - start} steps re-run")
    check(len(run["losses"]) == FLEET_STEPS - start,
          f"fleet job: {len(run['losses'])} losses from step {start}")
    check_job_launches("fleet job", run, FLEET_STEPS - start,
                       total=FLEET_STEPS)
    err = held_to("fleet job", run["losses"], want, start)
    size = CheckpointManager(ckpt).step_bytes(k)
    led = fledger.fold_fleet_dir(fleet_dir)["jobs"][job]
    ph = led["phases_s"]
    start_kind = f"{led.get('start_kind') or 'cold'}_start"
    rc, out = cli("check", fleet_dir)
    check(rc == 0, f"fleet: cli check exited {rc}: {out[-3000:]}")
    log(f"fleet (b) {job} ({app}) FINISHED in one epoch: queue wait "
        f"{ph.get('queued', 0):.4f} s, grant to first step "
        f"{ph.get('provision', 0) + ph.get(start_kind, 0):.4f} s "
        f"(provision {ph.get('provision', 0):.4f} + {start_kind} "
        f"{ph.get(start_kind, 0):.4f}); fleet migrate {job} 1: wall (request "
        f"to the relaunched worker's re-registration) {wall:.4f} s, the "
        f"drain's save of step {k} {size / 2**30:.3f} GiB durable in "
        f"{float(durable.group(1)):.3f} s (tony.elastic.drain-grace-s "
        f"default 15 s; this job's {FAIL_DRAIN_GRACE_S} s), restore "
        f"{run['restore_s']:.3f} s, start at step {start}: "
        f"{k + 1 - start} steps re-run; {FLEET_STEPS - start} steps with 16 "
        f"launches of each flash kernel per step, losses {err:.3e} from "
        f"phase 14's uninterrupted run's; ledger goodput_fraction "
        f"{led['goodput_fraction']}, held {led['held_chip_s']} "
        f"chip-seconds, phases {json.dumps(ph)}, chip-seconds "
        f"{json.dumps(led['chip_seconds'])}; cli check on the fleet dir "
        f"clean; {time.perf_counter() - t0:.1f} s; {card}")
    log("fleet (b) fleet top --once:\n" + top.rstrip())
    return float(durable.group(1))


def phase_host_and_fleet(in_process, cold, want, card):
    """Phase 15: the GPU host backend and the fleet on the card."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    try:
        host_backend_job(tmp, in_process, cold, card)
        drain_s = fleet_job(tmp, want, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"host backend and fleet: {time.perf_counter() - t0:.1f} s")
    return drain_s


# Phase 16: a live flagship job observed through the CLI and the portal.
# top's MFU is the job's mean since its first step, start-up included, so
# top reads after 450 steps (~38 s at phase 4's ~84 ms); the capture and
# its export take 40-60 steps (3.4-5.0 s, NVIDIA H100 80GB HBM3 at 700 W),
# and 100 steps remain while alerts and the portal are read.
OBS_STEPS = 610
OBS_TOP_AFTER = 450
OBS_PROFILE_STEPS = 3
# top's MFU against the trainer's own, run alone as a process of its own
# just before the job, relative. The reference is taken next to the job it
# judges and the way the job runs: this script's process, which has run
# every earlier phase, steps the same flagship anywhere from 82 to 135 ms
# (phase 4, and again before the job: 89.8, then 93.9 ms, while the jobs
# of phases 12-16 ran 82.7-85.2 ms; NVIDIA H100 80GB HBM3, 700 W).
TOL_OBS_MFU = 0.10
OBS_REFERENCE_STEPS = 30
OBS_TIMEOUT_S = 300


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_get(url, timeout=30):
    """(status, body) of a GET; an HTTP error's status, not a raise."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def gpu_clocks():
    """The card's SM clock, power draw and temperature now, as
    ``nvidia-smi`` reads them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                        "temperature.gpu", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def top_task_row(frame):
    """The worker's row of a ``cli top`` frame: (MFU, device bytes in
    use), from its MFU and HBM columns."""
    lines = frame.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("TASK"))
    cols = lines[head + 1].split() + [""] * 6
    units = {"B": 1, "KiB": 2**10, "MiB": 2**20, "GiB": 2**30, "TiB": 2**40}
    m = re.fullmatch(r"([0-9.]+)([KMGT]?i?B)", cols[5])
    check(cols[0] == "worker:0" and m is not None
          and re.fullmatch(r"[0-9.]+", cols[4]) is not None,
          f"observers: no worker row with MFU and device memory in "
          f"{frame!r}")
    return float(cols[4]), float(m.group(1)) * units[m.group(2)]


def trace_kernel_counts(path):
    """CUDA kernel events of a Chrome trace by ``flagship_kind``, and the
    number of kernel events in all."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    counts = collections.Counter(flagship_kind(str(e.get("name", "")).lower())
                                 for e in kernels)
    return counts, len(kernels)


def observed_job(tmp, reference, in_process, card):
    """Phase 16's job: submitted, watched by top, profiled, its alerts and
    portal read while it runs; checked after it. ``reference`` is the
    trainer's own result, run alone, that top's MFU is held to;
    ``in_process`` is phase 4's."""
    from tony_tpu_torch import constants
    from tony_tpu_torch.conf import keys as K
    from tony_tpu_torch.ops import _flash_cuda

    hist, work = os.path.join(tmp, "history"), os.path.join(tmp, "work")
    jobs = os.path.join(work, "jobs")
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "submit",
            "--workdir", work]
    for kv in ((K.APPLICATION_FRAMEWORK, "pytorch"),
               (K.APPLICATION_BACKEND, "local"),
               ("tony.worker.instances", 1),
               ("tony.worker.command",
                f"exec {TRAINER} --model flagship --steps {OBS_STEPS}"),
               (K.HISTORY_LOCATION, hist),
               (K.APPLICATION_TIMEOUT_S, OBS_TIMEOUT_S)):
        argv += ["--conf", f"{kv[0]}={kv[1]}"]
    port = free_port()
    portal_argv = [sys.executable, "-m", "tony_tpu_torch.cli", "portal",
                   "--history-root", hist, "--port", str(port)]
    base = f"http://127.0.0.1:{port}"
    os.makedirs(hist)
    procs = {}
    figures = {}
    try:
        with open(os.path.join(tmp, "submit.out"), "w") as out:
            procs["submit"] = subprocess.Popen(
                argv, cwd=REPO, env=repo_env(), stdout=out,
                stderr=subprocess.STDOUT)
        with open(os.path.join(tmp, "portal.out"), "w") as out:
            procs["portal"] = subprocess.Popen(
                portal_argv, cwd=REPO, env=repo_env(), stdout=out,
                stderr=subprocess.STDOUT)
        app = poll(lambda: (os.listdir(jobs)[:1] or [None])[0]
                   if os.path.isdir(jobs) else None, "the job's dir", 120)
        job_dir = os.path.join(hist, constants.HISTORY_INTERMEDIATE, app)
        rpc = coordinator_rpc(os.path.join(jobs, app))
        try:
            poll(lambda: job_steps(rpc) >= OBS_TOP_AFTER,
                 f"{OBS_TOP_AFTER} steps", OBS_TIMEOUT_S, interval=1.0)
        finally:
            rpc.close()
        pgid = os.path.join(jobs, app, "tasks", "worker_0",
                            constants.USER_PGID_FILE)
        with open(pgid) as f:
            pid = int(f.read().strip())

        rc, frame = cli("top", app, "--once", "--workdir", work)
        figures["clocks"] = gpu_clocks()
        check(rc == 0, f"observers: cli top exited {rc}: {frame[-2000:]}")
        mfu, hbm = top_task_row(frame)
        total = torch.cuda.get_device_properties(0).total_memory
        want = reference["mfu_vs_peak_bf16"]
        figures["top"] = frame
        check(abs(mfu - want) <= TOL_OBS_MFU * want,
              f"observers: top's MFU {mfu} against the trainer alone's "
              f"{want:.4f} just before the job (phase 4's "
              f"{in_process['mfu_vs_peak_bf16']:.4f}), limit {TOL_OBS_MFU} "
              f"relative\n{frame}")
        check(0 < hbm <= total, f"observers: top's device memory {hbm} "
              f"bytes, the card holds {total}")

        t0 = time.perf_counter()
        rc, text = cli("profile", app, "--steps", str(OBS_PROFILE_STEPS),
                       "--workdir", work, "--timeout", "120",
                       "--interval", "0.1")
        capture_s = time.perf_counter() - t0
        check(rc == 0 and "captured:" in text,
              f"observers: cli profile exited {rc}: {text[-2000:]}")
        captured = text.split("captured: ", 1)[1].splitlines()[0].strip()
        check(os.path.dirname(captured) == os.path.join(job_dir, "profile")
              and os.path.basename(captured).startswith("ondemand-"),
              f"observers: the capture landed at {captured}, not under "
              f"{job_dir}/profile/ondemand-*")
        trace = os.path.join(captured, "trace.json")
        counts, n_kernels = trace_kernel_counts(trace)
        for name in _flash_cuda.KERNELS:
            check(counts[name] == 16 * OBS_PROFILE_STEPS,
                  f"observers: the trace holds {counts[name]} {name} "
                  f"kernels, expected {16 * OBS_PROFILE_STEPS} "
                  f"({n_kernels} CUDA kernel events in all: "
                  f"{dict(counts)})")
        with open(pgid) as f:
            same = int(f.read().strip()) == pid and alive(pid)
        check(same, f"observers: the worker's process {pid} did not "
              "survive the capture")

        rc, rows = cli("alerts", app, "--workdir", work)
        check(rc == 0 and "RULE" in rows,
              f"observers: cli alerts exited {rc}: {rows[-2000:]}")
        figures["alerts"] = rows

        for path in ("/", f"/jobs/{app}"):
            code, body = http_get(base + path)
            check(code == 200 and app.encode() in body,
                  f"observers: portal {path} answered {code}")
        code, body = http_get(f"{base}/profile/{app}?format=json")
        listed = [t["name"] for t in json.loads(body)] if code == 200 else []
        check(listed == [os.path.basename(captured)],
              f"observers: portal /profile/{app} answered {code} listing "
              f"{listed}")
        code, body = http_get(base + "/metrics")
        check(code == 200 and f'app="{app}"'.encode() in body
              and b"tony_task_steps_per_sec{" in body,
              f"observers: portal /metrics answered {code} without the "
              f"job's series: {body[:2000]!r}")
        check(procs["submit"].poll() is None,
              "observers: the job ended before the portal was read")

        rc_submit = procs["submit"].wait(timeout=OBS_TIMEOUT_S)
        with open(os.path.join(tmp, "submit.out")) as f:
            submit_text = f.read()
        check(rc_submit == 0, f"observers: the job's CLI exited "
              f"{rc_submit}: {submit_text[-3000:]}\n"
              f"{job_task_log(work, app, 'stderr.log')[-3000:]}")
        code, body = http_get(f"{base}/trace/{app}?format=json")
        check(code == 200 and json.loads(body).get("traceEvents"),
              f"observers: portal /trace/{app} answered {code}")
    finally:
        for name, p in procs.items():
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=60)
    check(not alive(procs["portal"].pid),
          "observers: the portal's process outlived its stop")

    status, job_dir, events = job_history(hist, app)
    check(status == "SUCCEEDED", f"observers: history says {status}")
    with open(os.path.join(job_dir, constants.JOURNAL_FILE)) as f:
        epochs = [r["session"] for r in map(json.loads, f)
                  if r.get("t") == "epoch"]
    check(epochs == [0], f"observers: epochs {epochs}, expected [0]")
    profiled = [e for e in events if e.type == "TASK_PROFILED"]
    check(len(profiled) == 1 and profiled[0].payload.get("status")
          == "captured", f"observers: TASK_PROFILED events {profiled}")
    run, _ = worker_run(work, app)
    check(len(run["losses"]) == OBS_STEPS
          and all(math.isfinite(x) for x in run["losses"]),
          f"observers: {len(run['losses'])} losses, finite "
          f"{all(math.isfinite(x) for x in run['losses'])}")
    for name in _flash_cuda.KERNELS:
        check(run["launches_per_step"][name] == 16,
              f"observers: {name} {run['launches_per_step'][name]} "
              "launches per step, expected 16")
    inside = run["profiled_steps"]
    check(len(inside) == OBS_PROFILE_STEPS,
          f"observers: the trainer saw steps {inside} under the capture")
    step_s = run["step_s"]
    outside = [t for i, t in enumerate(step_s[run["warmup"]:],
                                       run["warmup"])
               if i not in inside and i - 1 not in inside]
    before_top = step_s[run["warmup"]:OBS_TOP_AFTER]
    rc, out = cli("check", job_dir)
    check(rc == 0, f"observers: cli check exited {rc}: {out[-3000:]}")
    log("observers: top frame while the job ran:\n" + figures["top"])
    log("observers: alerts while the job ran:\n" + figures["alerts"])
    log(f"observers: the job's first {run['warmup']} steps "
        f"{sum(step_s[:run['warmup']]):.4f} s, then median "
        f"{statistics.median(before_top):.4f} s/step until top read; the "
        f"trainer's own MFU over its timed steps "
        f"{run['mfu_vs_peak_bf16']}; clocks.sm, power.draw, "
        f"temperature.gpu at the top read: {figures['clocks']}")
    log(f"observers: {app} SUCCEEDED in one epoch, worker pid {pid} "
        f"unchanged; top MFU {mfu} against the trainer alone's "
        f"{reference['mfu_vs_peak_bf16']:.4f} ({reference['step_ms']:.3f} "
        f"ms/step) just before the job (phase 4's "
        f"{in_process['mfu_vs_peak_bf16']:.4f}), device memory "
        f"{hbm / 2**30:.3f} GiB of {total / 2**30:.3f}; capture of "
        f"{OBS_PROFILE_STEPS} steps {capture_s:.4f} s from the request to "
        f"captured, trace {os.path.getsize(trace) / 1e6:.3f} MB with "
        f"{n_kernels} CUDA kernel events ({json.dumps(dict(counts))}); "
        f"host s/step inside the capture "
        f"{json.dumps([round(step_s[i], 4) for i in inside])}, the step "
        f"after it {step_s[inside[-1] + 1]:.4f}, outside it median "
        f"{statistics.median(outside):.4f} (min {min(outside):.4f}, max "
        f"{max(outside):.4f}, {len(outside)} steps); {OBS_STEPS} steps at "
        f"{run['tokens_per_sec']:.1f} tokens/s, {run['step_ms']:.3f} "
        f"ms/step; launches per step "
        f"{json.dumps(run['launches_per_step'])}; cli check clean; {card}")


def phase_observers(in_process, card):
    """Phase 16: a live flagship job observed on the card."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()   # the reference and the job need the memory
    r = subprocess.run(f"{TRAINER} --model flagship --steps "
                       f"{OBS_REFERENCE_STEPS}".split(), cwd=REPO,
                       env=repo_env(), capture_output=True, text=True,
                       timeout=OBS_TIMEOUT_S)
    check(r.returncode == 0, f"observers: the trainer alone exited "
          f"{r.returncode}: {r.stderr[-3000:]}")
    reference = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"observers: the trainer alone before the job: "
        f"{reference['tokens_per_sec']:.1f} tokens/s, "
        f"{reference['step_ms']:.3f} ms/step, MFU "
        f"{reference['mfu_vs_peak_bf16']} (phase 4 in this process: "
        f"{in_process['step_ms']:.3f} ms/step, MFU "
        f"{in_process['mfu_vs_peak_bf16']}); {card}")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-obs-")
    try:
        observed_job(tmp, reference, in_process, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"observers: {time.perf_counter() - t0:.1f} s")


# Phase 17: the decoders' mesh layouts on the card.
def mesh_turns(label, cfg, card, mode=None):
    """(a), (b): ``cfg`` trained unsharded and on the world-1 mesh in
    alternating turns, each turn's launches checked; returns the medians
    of tokens/s."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda, quant

    want = None
    rates = {"unsharded": [], "sharded": []}
    steps = QMESH_STEPS + 2
    for kind in ("unsharded", "sharded", "unsharded", "sharded"):
        _flash_cuda.reset_launch_counts()
        quant.reset_launch_counts()
        gc.collect()
        torch.cuda.empty_cache()
        r = trainer.measure(cfg, batch=4, seq=2048, steps=steps, warmup=2,
                            device="cuda", seed=0,
                            mesh="fsdp=1" if kind == "sharded" else "")
        counts = dict(_flash_cuda.launch_counts)
        qcounts = dict(quant.launch_counts)
        rates[kind].append(r["tokens_per_sec"])
        log(f"mesh layouts {label} {kind}: {r['tokens_per_sec']:.1f} "
            f"tokens/s, {r['step_ms']:.3f} ms/step, peak memory "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
            f"{json.dumps(counts)}, quantized products {json.dumps(qcounts)}"
            f"; {card}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"{label} {kind}: non-finite loss")
        check_flash_counts(f"{label} {kind}", counts, cfg.n_layers * steps)
        nq = 7 * cfg.n_layers * steps if mode else 0
        check(qcounts.get(mode, 0) == nq and sum(qcounts.values()) == nq,
              f"{label} {kind}: quantized products {qcounts}, expected {nq}")
        check(quant.fallback_events() == {},
              f"{label}: degraded {quant.fallback_events()}")
        if want is None:
            want = r["losses"]
            continue
        got = r["losses"]
        rel = max_rel(got, want)
        log(f"mesh layouts {label} {kind} losses {got}; against the first "
            f"unsharded turn: largest difference "
            f"{max(abs(a - b) for a, b in zip(got, want)):.3e} (relative "
            f"{rel:.3e}), bit for bit {got == want}")
        check(rel <= TOL_QMESH_REL,
              f"{label} {kind} losses differ from the unsharded by {rel}")
    medians = {k: statistics.median(v) for k, v in rates.items()}
    log(f"mesh layouts {label}: sharded / unsharded tokens/s "
        f"{medians['sharded'] / medians['unsharded']:.4f} (medians of 2 "
        f"alternating turns each; unsharded {medians['unsharded']:.1f}, "
        f"sharded {medians['sharded']:.1f}); {card}")
    return medians


def quant_mesh_cli(card):
    """(a): the trainer's command line with ``--matmul-dtype int8 --mesh
    fsdp=1`` on the card."""
    steps = 3
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.trainer", "--matmul-dtype",
         "int8", "--mesh", "fsdp=1", "--steps", str(steps)],
        env=repo_env(), cwd=REPO, capture_output=True, text=True,
        timeout=300)
    check(proc.returncode == 0,
          f"trainer --matmul-dtype int8 --mesh fsdp=1 exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"mesh layouts (a) python -m tony_tpu_torch.trainer --matmul-dtype "
        f"int8 --mesh fsdp=1 --steps {steps}: {time.perf_counter() - t0:.1f}"
        f" s, mesh {json.dumps(out['mesh'])}, losses {out['losses']}, "
        f"launches per step {json.dumps(out['launches_per_step'])}, "
        f"quantized products per step {out['quantized_products_per_step']},"
        f" fallback {out['quant_fallback']}; {card}")
    check(all(math.isfinite(x) for x in out["losses"]),
          "the int8 trainer on the mesh: non-finite loss")
    check(out["mesh"] is not None, "the int8 trainer ran off the mesh")
    check(out["quantized_products_per_step"] == 7 * 16,
          f"the int8 trainer on the mesh ran "
          f"{out['quantized_products_per_step']} quantized products per "
          "step, expected 112")
    check(out["quant_fallback"] == {},
          f"the int8 trainer degraded: {out['quant_fallback']}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(out["launches_per_step"][name] == 16,
              f"the int8 trainer on the mesh: {name} "
              f"{out['launches_per_step'][name]} per step, expected 16")


def moe_mesh_layouts(card, earlier_run):
    """(c): the MoE decoder at the flagship's widths and all 16 layers on
    the world-1 mesh, its experts on ``(ep, tp)``, against unsharded."""
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.models.moe import MoETransformer
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel import (MeshSpec, TrainState, adamw,
                                         build_mesh, init_sharded_state,
                                         sharded_train_step, train_step)
    from tony_tpu_torch.trainer import moe_loss

    cfg = moe_flagship_config()
    steps = 3
    batches = [synthetic_lm_batch(s, 4, 2048, cfg.vocab_size,
                                  device="cuda") for s in range(steps)]
    runs = {}
    for kind in ("unsharded", "sharded"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if kind == "sharded":
            mesh = build_mesh(MeshSpec(), "cuda")
            state, _ = init_sharded_state(
                lambda d: MoETransformer(cfg, device=d),
                lambda g: adamw(g, 3e-4), mesh, seed=0)
            gate = state.model.layers[0].moe.gate
            check(type(gate).__name__ == "DTensor"
                  and gate.device_mesh.mesh_dim_names[-2:] == ("ep", "tp"),
                  "MoE experts are not DTensors on (ep, tp)")

            def step(b):
                return sharded_train_step(moe_loss, mesh, state, b)[1]
        else:
            model = MoETransformer(
                cfg, device="cuda",
                generator=torch.Generator("cuda").manual_seed(0))
            state = TrainState(model, adamw(model.parameters(), 3e-4),
                               moe_loss)

            def step(b):
                return train_step(state, b)
        _flash_cuda.reset_launch_counts()
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(steps):
            losses.append(float(step(batches[s])["loss"]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        counts = dict(_flash_cuda.launch_counts)
        runs[kind] = losses
        log(f"mesh layouts (c) MoE at the flagship's widths, "
            f"{cfg.n_layers} layers, {kind}: losses {losses}, {ms:.1f} "
            f"ms/step (first step included), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
            f"launches per step "
            f"{json.dumps({k: v / steps for k, v in counts.items()})}; "
            f"{card}")
        check(all(math.isfinite(x) for x in losses),
              f"MoE {kind}: non-finite loss")
        for name, n in flash_launches_per_step(cfg).items():
            check(counts[name] == n * steps, f"MoE {kind}: {name} launched "
                  f"{counts[name]} times, expected {n} per step")
        del state, step
    rel = max_rel(runs["sharded"], runs["unsharded"])
    log(f"mesh layouts (c) MoE on the world-1 mesh against unsharded: max "
        f"rel {rel:.3e}, bit for bit {runs['sharded'] == runs['unsharded']};"
        f" phase 11 (c) at {earlier_run['layers']} layers: "
        f"{earlier_run['mesh_ms']:.1f} ms/step on the mesh, "
        f"{earlier_run['unsharded_ms']:.1f} unsharded")
    check(rel <= TOL_MESH_REL, f"MoE on the mesh differs by {rel}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_mesh_layouts(card, moe_run):
    """Phase 17: the quantized, the tied and the MoE decoder on the
    world-1 mesh."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import quant

    dist = torch.distributed
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-layouts-")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))
    try:
        rates = {}
        for mode in quant.MODES:
            full = trainer.flagship_config(2048, mode)
            rates[mode] = mesh_turns(
                cut_label(f"(a) flagship {mode}", full), earlier(full),
                card, mode)
        log(f"mesh layouts (a): {time.perf_counter() - t0:.1f} s")
        quant_mesh_cli(card)
        t1 = time.perf_counter()
        tied = dataclasses.replace(trainer.flagship_config(2048),
                                   tie_embeddings=True)
        mesh_turns(cut_label("(b) flagship tied", tied), earlier(tied), card)
        log(f"mesh layouts (b): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        moe_mesh_layouts(card, moe_run)
        log(f"mesh layouts (c): {time.perf_counter() - t1:.1f} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not dist.is_initialized(), "the NCCL group was not torn down")
    log(f"mesh layouts: {time.perf_counter() - t0:.1f} s for parts (a)-(c)"
        f"; {card}")
    return rates


# Phase 18: the vision models' mesh layouts on the card.
# ResNet-50's norm widths [B, H·W, C] (the stem, stage 1's 3x3 and stage
# 3's projection) cut to one tp rank's channel shard at tp = 2, 4 and 8,
# and the stem at tp = 16: C = 4, the kernel's scalar path.
SHARD_WIDTHS = ((112 * 112, 64), (56 * 56, 256), (7 * 7, 2048))
SHARD_TPS = (2, 4, 8)
SCALAR_SHARD = (112 * 112, 64 // 16)
VISION_MESH_STEPS = 3


def vision_mesh_turns(kind, batch, card):
    """(a), (b): ``kind`` ("resnet50" or "mnist") trained unsharded and on
    the world-1 mesh under the tp plan in alternating turns, 3 SGD steps
    each from the same seed and batches; every sharded turn's losses
    against the first unsharded turn's within ``TOL_MESH_REL``, ResNet's
    convs DTensors on tp with 53 convfuse launches per step, the MLP with
    none. Returns the medians of samples/s."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _convfuse_cuda
    from tony_tpu_torch.parallel import (MeshSpec, build_mesh,
                                         sharded_train_step, train_step)

    batches = [trainer.vision_batch(kind, s, batch, device="cuda")
               for s in range(VISION_MESH_STEPS)]
    mesh = build_mesh(MeshSpec(), "cuda")
    want, rates = None, {"unsharded": [], "sharded": []}
    for turn in ("unsharded", "sharded", "unsharded", "sharded"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sharded = turn == "sharded"
        state = trainer.build_vision_state(kind, "cuda", seed=0,
                                           mesh=mesh if sharded else None)
        if sharded:
            first = (state.model.stem_conv if kind == "resnet50"
                     else state.model.dense[0]).weight
            check(type(first).__name__ == "DTensor"
                  and "tp" in first.device_mesh.mesh_dim_names,
                  f"{kind}: the tp plan left its first layer whole")

            def step(b):
                return sharded_train_step(state.loss_fn, mesh, state, b)[1]
        else:
            def step(b):
                return train_step(state, b)
        _convfuse_cuda.reset_launch_counts()
        # The first step warms the turn (cuDNN's plans, the allocator);
        # the rest are timed.
        losses = [float(step(batches[0])["loss"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [float(step(b)["loss"]) for b in batches[1:]]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (VISION_MESH_STEPS - 1) * 1e3
        launched = _convfuse_cuda.launch_counts["convfuse_apply"]
        rates[turn].append(batch / ms * 1e3)
        log(f"vision layouts {kind} {turn}: batch {batch}, losses "
            f"{losses}, {batch / ms * 1e3:.1f} samples/s, {ms:.3f} ms/step "
            f"(steps 2-{VISION_MESH_STEPS}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, convfuse "
            f"launches per step {launched / VISION_MESH_STEPS}; {card}")
        check(all(math.isfinite(x) for x in losses),
              f"{kind} {turn}: non-finite loss")
        per_step = RESNET_LAUNCHES_PER_STEP if kind == "resnet50" else 0
        check(launched == per_step * VISION_MESH_STEPS,
              f"{kind} {turn}: convfuse_apply launched {launched} times in "
              f"{VISION_MESH_STEPS} steps, expected {per_step} per step")
        del state, step
        if want is None:
            want = losses
            continue
        rel = max_rel(losses, want)
        log(f"vision layouts {kind} {turn} against the first unsharded "
            f"turn: largest difference "
            f"{max(abs(a - b) for a, b in zip(losses, want)):.3e} "
            f"(relative {rel:.3e}), bit for bit {losses == want}")
        check(rel <= TOL_MESH_REL,
              f"{kind} {turn} losses differ from the unsharded by {rel}")
    medians = {k: statistics.median(v) for k, v in rates.items()}
    log(f"vision layouts {kind}: sharded / unsharded samples/s "
        f"{medians['sharded'] / medians['unsharded']:.4f} (medians of 2 "
        f"alternating turns each); {card}")
    return medians


def vision_mesh_cli(card):
    """(b): ``python -m tony_tpu_torch.trainer --model resnet50 --mesh
    fsdp=1 --steps 3`` on the card."""
    steps = 3
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.trainer", "--model",
         "resnet50", "--mesh", "fsdp=1", "--steps", str(steps)],
        env=repo_env(), cwd=REPO, capture_output=True, text=True,
        timeout=300)
    check(proc.returncode == 0,
          f"trainer --model resnet50 --mesh fsdp=1 exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"vision layouts (b) python -m tony_tpu_torch.trainer --model "
        f"resnet50 --mesh fsdp=1 --steps {steps}: "
        f"{time.perf_counter() - t0:.1f} s, mesh {json.dumps(out['mesh'])}, "
        f"losses {out['losses']}, launches per step "
        f"{json.dumps(out['launches_per_step'])}; {card}")
    check(all(math.isfinite(x) for x in out["losses"]),
          "the ResNet-50 trainer on the mesh: non-finite loss")
    check(out["mesh"] is not None, "the ResNet-50 trainer ran off the mesh")
    check(out["launches_per_step"].get("convfuse_apply")
          == RESNET_LAUNCHES_PER_STEP,
          f"the ResNet-50 trainer on the mesh: convfuse "
          f"{out['launches_per_step']} per step, expected "
          f"{RESNET_LAUNCHES_PER_STEP}")


def phase_vision_layouts(card):
    """Phase 18: ResNet-50 and the MNIST MLP on the world-1 mesh under the
    tensor-parallel plan, and the convfuse kernel at tp shard widths."""
    dist = torch.distributed
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-vision-")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))
    try:
        rates = {"resnet50": vision_mesh_turns("resnet50", RESNET_BATCH,
                                               card)}
        log(f"vision layouts (a): {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        rates["mnist"] = vision_mesh_turns("mnist", MNIST_BATCH, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not dist.is_initialized(), "the NCCL group was not torn down")
    vision_mesh_cli(card)
    log(f"vision layouts (b): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    seed = 180
    for rows, c in SHARD_WIDTHS:
        for tp in SHARD_TPS:
            seed += 1
            check_convfuse_case(
                f"shard tp={tp} bf16 [{RESNET_BATCH}, {rows}, {c // tp}]",
                (RESNET_BATCH, rows, c // tp), torch.bfloat16, True, seed)
    rows, c = SCALAR_SHARD
    check_convfuse_case(f"scalar shard tp=16 bf16 [{RESNET_BATCH}, {rows}, "
                        f"{c}]", (RESNET_BATCH, rows, c), torch.bfloat16,
                        True, seed + 1)
    log(f"vision layouts (c): {time.perf_counter() - t1:.1f} s")
    log(f"vision layouts: {time.perf_counter() - t0:.1f} s for parts "
        f"(a)-(c); {card}")
    return rates


# Phase 19: checkpoints through the port's object store on the card.
STORE_CKPT_URL = "gs://tony-ckpt/flagship"
# One step per turn: one save each (a turn of more steps saves its first
# and its last, ~35 s of the store's writer), so that the script stays
# inside its time limit.
STORE_STEPS = 1


def state_tensors(state):
    """The training state's parameters and Adam moments, in order."""
    moments = state.optimizer.state_dict()["state"]
    return ([p.detach() for p in state.model.parameters()]
            + [moments[k][n] for k in sorted(moments)
               for n in sorted(moments[k]) if torch.is_tensor(moments[k][n])])


def bitwise(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def store_turns(tmp, card):
    """(a) The flagship's checkpoints in the store and on local disk, in
    turns: the writer's seconds, the restores and the bitwise gates."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.ops import _flash_cuda
    from tony_tpu_torch.parallel import checkpoint_tree, load_checkpoint_tree

    cfg = trainer.flagship_config(seq=2048)
    corpus = trainer.write_corpus(os.path.join(tmp, "corpus.bin"),
                                  cfg.vocab_size)
    log(f"store (a): {shutil.disk_usage(tmp).free / 2**30:.1f} GiB free "
        f"under {tmp}")
    cwd = os.getcwd()
    before = sorted(os.listdir(cwd))
    dirs = {"store": STORE_CKPT_URL, "local": os.path.join(tmp, "local")}
    restored = {}
    for label in ("store", "local"):
        _flash_cuda.reset_launch_counts()
        run = trainer.train(cfg, corpus, batch=4, seq=2048,
                            steps=STORE_STEPS, ckpt_dir=dirs[label],
                            save_interval=10_000, max_to_keep=1,
                            device="cuda", seed=0)
        check(run["async_errors"] == [],
              f"store (a) {label}: async errors {run['async_errors']}")
        check(all(math.isfinite(x) for x in run["losses"]),
              f"store (a) {label}: losses {run['losses']}")
        check_flash_counts(f"store (a) {label}",
                           dict(_flash_cuda.launch_counts), 16 * STORE_STEPS)
        saved = state_tensors(run.pop("state"))
        fresh = trainer.build_state(cfg, "cuda", seed=1)
        mgr = CheckpointManager(dirs[label])
        try:
            steps = mgr.all_steps()
            t0 = time.perf_counter()
            load_checkpoint_tree(fresh, mgr.restore(None,
                                                    checkpoint_tree(fresh)))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            size = mgr.step_bytes(STORE_STEPS - 1)
        finally:
            mgr.close()
        check(steps == [STORE_STEPS - 1] and fresh.step == STORE_STEPS,
              f"store (a) {label}: steps {steps}, restored step count "
              f"{fresh.step}")
        restored[label] = state_tensors(fresh)
        same = bitwise(saved, restored[label])
        log(f"store (a) {label} ({dirs[label]}): {STORE_STEPS} steps, "
            f"losses {run['losses']}, writer {json.dumps(run['write_s'])} s "
            f"per saved step, ckpt_stall {ms_by_step(run['save_stall_s'])} "
            f"ms, restore {restore_s:.3f} s, {size} bytes "
            f"({size / 2**30:.3f} GiB) per step; restored bitwise equal to "
            f"the trained state {same}; {card}")
        check(same, f"store (a) {label}: the restored state differs from "
              "the trained one")
        del saved, fresh
        gc.collect()
        torch.cuda.empty_cache()
    same = bitwise(restored["store"], restored["local"])
    stray = sorted(set(os.listdir(cwd)) - set(before))
    log(f"store (a): the store's step bitwise equal to the local one's "
        f"{same}; new entries under the working directory {stray}")
    check(same, "store (a): the store's step differs from the local one's")
    check(not stray and not os.path.exists(os.path.join(cwd, "gs:")),
          f"store (a): {stray} written under {cwd}")


def phase_store_checkpoints(store_drain_s, local_drain_s, card):
    """Phase 19: checkpoints on ``gs://`` through the port's store
    (``FakeGcsStore`` under a temporary ``TONY_FAKE_GCS_ROOT``, set in this
    process's environment only). (b), the migration through the store, ran
    in phase 14: its drain save is printed beside phase 15 (b)'s to local
    disk."""
    from tony_tpu_torch.storage.store import FAKE_GCS_ROOT_ENV

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-store-")
    previous = os.environ.get(FAKE_GCS_ROOT_ENV)
    os.environ[FAKE_GCS_ROOT_ENV] = os.path.join(tmp, "gcs")
    try:
        store_turns(tmp, card)
        log(f"store (a): {time.perf_counter() - t0:.1f} s")
        log(f"store (b): phase 14 (b)'s drain save to {STORE_MIGRATE_URL} "
            f"took {store_drain_s:.3f} s against phase 15 (b)'s "
            f"{local_drain_s:.3f} s to local disk "
            f"(tony.elastic.drain-grace-s default 15 s; both jobs' "
            f"{FAIL_DRAIN_GRACE_S} s); {card}")
    finally:
        if previous is None:
            os.environ.pop(FAKE_GCS_ROOT_ENV, None)
        else:
            os.environ[FAKE_GCS_ROOT_ENV] = previous
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"store: {time.perf_counter() - t0:.1f} s for parts (a)-(b); "
        f"{card}")


# Phase 20: tensor-parallel layouts under other rules tables at world 1
# (3 steps a turn, the first untimed; 5 until phase 21 took their time).
RULES_STEPS = 3
RULES_DEPTH = 4


def rules_tables():
    """The tables of ``tests/test_torch_rules.py`` (test data; the package
    exports only ``DEFAULT_RULES``): T1 keeps the kv heads whole, T2 puts
    ``embed`` over tp before any other rule, T3 the embedding table's embed
    dim over tp (its rows over fsdp), T4 the head's embed dim over
    ``(fsdp, tp)`` as a MaxText-style fallback list."""
    from tony_tpu_torch.parallel import DEFAULT_RULES as d

    return {
        "T1": tuple((n, None) if n == "kv_heads" else (n, a) for n, a in d),
        "T2": (("embed", "tp"),) + d,
        "T3": tuple(("vocab_table", "fsdp") if n == "vocab_table" else
                    ("embed_table", "tp") if n == "embed_table" else (n, a)
                    for n, a in d),
        "T4": tuple(r for r in d if r[0] not in ("embed", "vocab")) + (
            ("vocab", None), ("embed", ("fsdp", "tp")), ("embed", "fsdp")),
    }


# What each table must change, read off ``init_sharded_state``'s
# placements: (parameter, its mesh axes per dim).
RULES_LAYOUT = {
    "T1": ("layers.0.attn.wk.weight", ((), ("fsdp",))),
    "T2": ("layers.0.attn.wq.weight", ((), ("tp",))),
    "T3": ("embedding", (("fsdp",), ("tp",))),
    "T4": ("lm_head.weight", ((), ("fsdp", "tp"))),
}


def rules_turn(label, cfg, table, batches, unit, card):
    """One turn of ``RULES_STEPS`` steps: ``cfg`` (a ``TransformerConfig``,
    or None for the MNIST MLP) unsharded (``table`` None) or from
    ``init_sharded_state(..., rules=table)`` on the world-1 mesh, the
    first step untimed. Checks the launches; returns (losses, rate per
    second of ``unit``)."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.models import MnistMLP, Transformer
    from tony_tpu_torch.ops import _flash_cuda, quant
    from tony_tpu_torch.parallel import (MeshSpec, TrainState, adamw,
                                         build_mesh, init_sharded_state, sgd,
                                         sharded_train_step, train_step)

    if cfg is None:
        def build(device, generator=None):
            return MnistMLP(hidden=128, device=device, generator=generator)

        def opt(params):
            return sgd(params, trainer.VISION_LR,
                       momentum=trainer.VISION_MOMENTUM)
        loss = trainer.vision_loss
    else:
        def build(device, generator=None):
            return Transformer(cfg, device=device, generator=generator)

        def opt(params):
            return adamw(params, trainer.LEARNING_RATE)
        loss = trainer.lm_loss
    gc.collect()
    torch.cuda.empty_cache()
    if table is None:
        model = build("cuda", torch.Generator("cuda").manual_seed(0))
        state = TrainState(model, opt(model.parameters()), loss)

        def step(b):
            return train_step(state, b)
    else:
        mesh = build_mesh(MeshSpec(), "cuda")
        state, placements = init_sharded_state(build, opt, mesh,
                                               rules=rules_tables()[table],
                                               seed=0)
        if table in RULES_LAYOUT and cfg is not None:
            name, dims = RULES_LAYOUT[table]
            check(placements[name].dims == dims,
                  f"{label}: {name} laid out as {placements[name].dims}, "
                  f"{table} says {dims}")

        def step(b):
            return sharded_train_step(loss, mesh, state, b)[1]
    _flash_cuda.reset_launch_counts()
    quant.reset_launch_counts()
    losses = [float(step(batches[0])["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [float(step(b)["loss"]) for b in batches[1:]]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
    rows = next(iter(batches[0].values())).shape
    rate = rows[0] * (rows[1] if cfg is not None else 1) / ms * 1e3
    flash, qcounts = dict(_flash_cuda.launch_counts), dict(quant.launch_counts)
    log(f"rules {label}: losses {losses}, {rate:.1f} {unit}/s, {ms:.3f} "
        f"ms/step (steps 2-{len(batches)}), flash launches {json.dumps(flash)}"
        f", quantized products {json.dumps(qcounts)}; {card}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    want = 0 if cfg is None else cfg.n_layers * len(batches)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(flash.get(name, 0) == want,
              f"{label}: {name} launched {flash.get(name, 0)} times, "
              f"expected {want}")
    mode = cfg is not None and cfg.matmul_dtype
    nq = 7 * cfg.n_layers * len(batches) if mode else 0
    check(qcounts.get(mode, 0) == nq and sum(qcounts.values()) == nq,
          f"{label}: quantized products {qcounts}, expected {nq}")
    check(quant.fallback_events() == {},
          f"{label}: degraded {quant.fallback_events()}")
    del state, step
    return losses, rate


def phase_rules(card):
    """Phase 20: the flagship (4 layers) under T1-T4, int8 under T2, the
    tied flagship under T3 and the MNIST MLP under T2 on the world-1 mesh,
    each beside its unsharded twin."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.data import synthetic_lm_batch

    dist = torch.distributed
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-rules-")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))
    flagship = trainer.flagship_config(2048)
    cases = [
        ("flagship", earlier(flagship), ("T1", "T2", "T3", "T4")),
        ("flagship int8", earlier(trainer.flagship_config(2048, "int8")),
         ("T2",)),
        ("flagship tied", earlier(dataclasses.replace(
            flagship, tie_embeddings=True)), ("T3",)),
        ("MNIST MLP", None, ("T2",)),
    ]
    try:
        for name, cfg, tables in cases:
            if cfg is None:
                batches = [trainer.vision_batch("mnist", s, MNIST_BATCH,
                                                device="cuda")
                           for s in range(RULES_STEPS)]
                unit, label = "samples", f"{name} (batch {MNIST_BATCH})"
            else:
                batches = [synthetic_lm_batch(s, 4, 2048, cfg.vocab_size,
                                              device="cuda")
                           for s in range(RULES_STEPS)]
                unit = "tokens"
                label = cut_label(name, dataclasses.replace(
                    cfg, n_layers=flagship.n_layers))
            want, base = rules_turn(f"{label} unsharded", cfg, None,
                                    batches, unit, card)
            for table in tables:
                got, rate = rules_turn(f"{label} {table}", cfg, table,
                                       batches, unit, card)
                rel = max_rel(got, want)
                diff = max(abs(a - b) for a, b in zip(got, want))
                log(f"rules {label} {table} against unsharded: largest "
                    f"difference {diff:.3e} (relative {rel:.3e}), bit for "
                    f"bit {got == want};"
                    f" sharded / unsharded {unit}/s {rate / base:.4f} "
                    f"({rate:.1f} / {base:.1f}); {card}")
                check(rel <= TOL_MESH_REL,
                      f"{label} {table} losses differ from the unsharded by "
                      f"{rel}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not dist.is_initialized(), "the NCCL group was not torn down")
    log(f"rules: {time.perf_counter() - t0:.1f} s; {card}")


# Phase 21: the Llama-3-8B example (examples/llama3-8b/train_llama3.py) on
# the card at its full width and LLAMA_DEPTH of its 32 layers.
LLAMA_DEPTH = 2
LLAMA_STEPS = 3           # timed, after 2 warm ones
LLAMA_BATCHES = (8, 4, 2)     # the example's batch, then the cuts tried
LLAMA_SETTINGS = (        # label, remat, remat_policy, batches tried
    ("remat off", False, None, LLAMA_BATCHES),
    ("full remat", True, None, LLAMA_BATCHES),
    ("dots_with_no_batch_dims_saveable", True,
     "dots_with_no_batch_dims_saveable", LLAMA_BATCHES),
    ("dots_saveable", True, "dots_saveable", LLAMA_BATCHES),
    # Full remat at the batch the others were cut to on the H100 (80 GB),
    # so that every setting has a twin at its own batch.
    ("full remat at B4", True, None, (4,)),
)
MOE_POLICY_DEPTH = 4
POLICY_NAMES = (None, "nothing_saveable", "everything_saveable",
                "dots_saveable", "checkpoint_dots",
                "dots_with_no_batch_dims_saveable",
                "checkpoint_dots_with_no_batch_dims")


def llama_cut(cfg, depth=LLAMA_DEPTH):
    return dataclasses.replace(cfg, n_layers=depth)


def llama_setting(label, cfg, batches, card):
    """(a) One remat setting of the example's step at its full width, 2
    warm and ``LLAMA_STEPS`` timed steps through ``trainer.measure`` at the
    largest of ``batches`` that fits the card (a cut printed). Returns the
    result with its batch and the flash launches per step."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda

    for batch in batches:
        gc.collect()
        torch.cuda.empty_cache()
        _flash_cuda.reset_launch_counts()
        try:
            r = trainer.measure(
                cfg, batch=batch, seq=trainer.LLAMA_SEQ,
                steps=LLAMA_STEPS + 2, warmup=2, device="cuda", seed=0,
                chunked=True, loss_chunk=trainer.LLAMA_LOSS_CHUNK,
                weight_decay=trainer.LLAMA_WEIGHT_DECAY)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"llama (a) {label}: batch {batch} does not fit in the "
                f"card's memory; {card}")
            r = None
    check(r is not None, f"llama (a) {label}: no batch of {batches} fits")
    counts = {k: v / (LLAMA_STEPS + 2)
              for k, v in _flash_cuda.launch_counts.items()}
    cut = "" if batch == trainer.LLAMA_BATCH else \
        f" (batch cut from {trainer.LLAMA_BATCH}: B{trainer.LLAMA_BATCH} " \
        f"does not fit)"
    log(f"llama (a) {label}: {r['params']} params, batch {batch}{cut} x "
        f"seq {trainer.LLAMA_SEQ}, {r['tokens_per_sec']:.1f} tokens/s, "
        f"{r['step_ms']:.3f} ms/step, MFU {r['mfu_vs_peak_bf16']:.4f}, "
        f"peak_memory_bytes {r['peak_memory_bytes']} "
        f"({r['peak_memory_bytes'] / 2**30:.2f} GiB), flash launches per "
        f"step {json.dumps(counts)}, losses {r['losses']}; {card}")
    check(all(math.isfinite(x) for x in r["losses"]),
          f"llama (a) {label}: non-finite loss")
    expected = math.log(cfg.vocab_size) + 0.5
    check(abs(r["losses"][0] - expected) <= 0.5,
          f"llama (a) {label}: first loss {r['losses'][0]} not near "
          f"ln(vocab) + 1/2")
    for name, n in flash_launches_per_step(cfg).items():
        check(counts.get(name) == n, f"llama (a) {label}: {name} launched "
              f"{counts.get(name)} times a step, expected {n}")
    return dict(r, batch=batch, launches_per_step=counts)


def llama_job(cfg, batch, card):
    """(b) The job loop with ``--model llama3_8b``'s semantics (the CLI's
    ``main``, the depth cut through ``LM_POINTS``) on a uint32 token file of
    Llama-3's vocabulary: 3 steps, no checkpoint, at ``batch`` (the
    policy's in (a): the example's 8 unless it did not fit)."""
    import contextlib
    import io

    from tony_tpu_torch import trainer

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-llama-")
    point = trainer.LM_POINTS["llama3_8b"]
    default_batch = trainer.DEFAULT_BATCH["llama3_8b"]
    try:
        corpus = trainer.write_corpus(os.path.join(tmp, "corpus.bin"),
                                      cfg.vocab_size)
        check(os.path.getsize(corpus) == 4 * trainer.CORPUS_TOKENS,
              "llama (b): the corpus is not uint32")
        trainer.LM_POINTS["llama3_8b"] = (
            lambda seq: llama_cut(trainer.llama3_8b_config(seq)),) + point[1:]
        trainer.DEFAULT_BATCH["llama3_8b"] = batch
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = trainer.main(["--model", "llama3_8b", "--data", corpus,
                               "--steps", "3"])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        trainer.LM_POINTS["llama3_8b"] = point
        trainer.DEFAULT_BATCH["llama3_8b"] = default_batch
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"llama (b) python -m tony_tpu_torch.trainer --model llama3_8b "
        f"--data <uint32 corpus> --steps 3 ({LLAMA_DEPTH} of 32 layers, "
        f"batch {batch}): "
        f"exit {rc}, losses {out['losses']}, {out['tokens_per_sec']:.1f} "
        f"tokens/s over the loop (first step included), token dtype "
        f"{out['token_dtype']}, loss chunk {out['loss_chunk']}, weight "
        f"decay {out['weight_decay']}, remat policy {out['remat_policy']}, "
        f"launches per step {json.dumps(out['launches_per_step'])}; {card}")
    check(rc == 0, "llama (b): the trainer's main failed")
    check(out["token_dtype"] == "uint32" and out["loss_chunk"] == 2048
          and out["weight_decay"] == 0.1 and out["remat_policy"]
          == "dots_with_no_batch_dims_saveable",
          f"llama (b): not the example's job: {out}")
    check(len(out["losses"]) == 3 and all(math.isfinite(x)
                                          for x in out["losses"]),
          f"llama (b): losses {out['losses']}")
    expected = math.log(cfg.vocab_size) + 0.5
    check(abs(out["losses"][0] - expected) <= 0.5,
          f"llama (b): first loss {out['losses'][0]} not near ln(vocab) "
          "+ 1/2")
    for name, n in flash_launches_per_step(cfg).items():
        check(out["launches_per_step"].get(name) == n,
              f"llama (b): {name} {out['launches_per_step'].get(name)} "
              f"launches a step, expected {n}")
    return out


def moe_policy(card):
    """(c) The MoE decoder of phase 11 (c) at 4 layers under the no-batch
    policy against full remat: ms per step and peak memory."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda

    base = moe_flagship_config()
    res = {}
    for policy in (None, "dots_with_no_batch_dims_saveable"):
        cfg = dataclasses.replace(base, n_layers=MOE_POLICY_DEPTH,
                                  remat_policy=policy)
        gc.collect()
        torch.cuda.empty_cache()
        _flash_cuda.reset_launch_counts()
        r = trainer.measure(cfg, batch=4, seq=2048, steps=5, warmup=2,
                            device="cuda")
        counts = {k: v / 5 for k, v in _flash_cuda.launch_counts.items()}
        label = policy or "full remat"
        log(f"llama (c) MoE ({MOE_POLICY_DEPTH} of 16 layers) {label}: "
            f"{r['step_ms']:.3f} ms/step, {r['tokens_per_sec']:.1f} "
            f"tokens/s, peak_memory_bytes {r['peak_memory_bytes']} "
            f"({r['peak_memory_bytes'] / 2**30:.2f} GiB), flash launches per "
            f"step {json.dumps(counts)}, losses {r['losses']}; {card}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"llama (c) MoE {label}: non-finite loss")
        for name, n in flash_launches_per_step(cfg).items():
            check(counts.get(name) == n, f"llama (c) MoE {label}: {name} "
                  f"{counts.get(name)} launches a step, expected {n}")
        res[label] = r
    full, pol = res["full remat"], res["dots_with_no_batch_dims_saveable"]
    log(f"llama (c) MoE: the policy against full remat: ms/step "
        f"{pol['step_ms'] / full['step_ms']:.4f}, peak memory "
        f"{pol['peak_memory_bytes'] / full['peak_memory_bytes']:.4f}; {card}")
    return res


def small_policies(card):
    """(d) A small f32 decoder (head_dim 64) under None and each policy
    name on the card against full remat's losses and gradients on the
    card, and against the same weights on the CPU."""
    from tony_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig,
                                                   causal_lm_loss)

    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, (2, 256)))
    runs = {}
    for policy in POLICY_NAMES:
        cfg = TransformerConfig.tiny(vocab_size=512, dim=256, n_heads=4,
                                     n_kv_heads=2, mlp_dim=512,
                                     max_seq_len=256, remat=True,
                                     remat_policy=policy)
        cpu = Transformer(cfg, device="cpu")
        gpu = Transformer(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        got = []
        for model, tok in ((cpu, tokens), (gpu, tokens.cuda())):
            loss = causal_lm_loss(model(tok), tok)
            loss.backward()
            got.append((loss.item(), [p.grad.cpu() for p in
                                      model.parameters()]))
        runs[policy] = got
    (cpu_full, gpu_full) = runs[None]
    worst = {}
    for policy, (cpu, gpu) in runs.items():
        vs_full = max(rel_err(g, f) for g, f in zip(gpu[1], gpu_full[1]))
        vs_cpu = max(rel_err(g, c) for g, c in zip(gpu[1], cpu[1]))
        loss_rel = max(abs(gpu[0] - gpu_full[0]), abs(gpu[0] - cpu[0])) \
            / abs(cpu[0])
        worst[str(policy)] = (vs_full, vs_cpu)
        check(loss_rel <= TOL_MODEL_REL, f"llama (d) {policy}: loss "
              f"{gpu[0]} against full remat {gpu_full[0]} and the CPU "
              f"{cpu[0]}")
        check(vs_full <= TOL_MODEL_REL and vs_cpu <= TOL_MODEL_REL,
              f"llama (d) {policy}: grad rel err {vs_full} against full "
              f"remat, {vs_cpu} against the CPU")
    bitwise = {str(p): all(torch.equal(g, f) for g, f in
                           zip(r[1][1], gpu_full[1])) and r[1][0]
               == gpu_full[0] for p, r in runs.items()}
    log(f"llama (d) small f32 decoder under each remat policy, card: worst "
        f"grad rel err (against full remat, against the CPU) "
        f"{json.dumps(worst)}; bit for bit full remat's on the card "
        f"{json.dumps(bitwise)}; loss {gpu_full[0]:.6f} (cpu "
        f"{cpu_full[0]:.6f}); {card}")


def llama_kernels(card):
    """(e) The flash kernels against their plain versions at the path's
    own head layout, B1 S8192 H32/8 D128 bf16 causal, then timed beside
    SDPA as phase 3 times them."""
    from tony_tpu_torch.models.transformer import TransformerConfig
    from tony_tpu_torch.ops import _flash_cuda as K

    llama = TransformerConfig.llama3_8b()
    h, hk, d = llama.n_heads, llama.n_kv_heads, llama.dim // llama.n_heads
    gc.collect()
    torch.cuda.empty_cache()
    name = f"llama3-8b path bf16 B1 S8192 H{h}/{hk} D{d} causal"
    check_case(name, 1, 8192, h, hk, d, torch.bfloat16, True, 22)
    q, k, v, do = make_case(1, 8192, h, hk, d, torch.bfloat16, 23)
    o, lse = K.flash_fwd(q, k, v, d ** -0.5, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    res = time_flash(name, q, k, v, do, lse, delta, True, o)
    log(f"timing ({name}): {json.dumps(res)}; {card}")
    return res


def phase_llama(card):
    """Phase 21: the Llama-3-8B example on the card, (a)-(e)."""
    from tony_tpu_torch import trainer

    t0 = time.perf_counter()
    full = trainer.llama3_8b_config()
    cfg = llama_cut(full)
    log(f"llama: the example's geometry at {LLAMA_DEPTH} of "
        f"{full.n_layers} layers (dim {cfg.dim}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, mlp {cfg.mlp_dim}, vocab {cfg.vocab_size})")
    runs = {label: llama_setting(label, dataclasses.replace(
        cfg, remat=remat, remat_policy=policy), batches, card)
        for label, remat, policy, batches in LLAMA_SETTINGS}
    # Each setting against full remat at its own batch.
    full_at = {r["batch"]: r for label, r in runs.items()
               if label.startswith("full remat")}
    for label, r in runs.items():
        twin = full_at.get(r["batch"])
        if twin is None or twin is r:
            continue
        log(f"llama (a) {label} against full remat, both at batch "
            f"{r['batch']}: tokens/s "
            f"{r['tokens_per_sec'] / twin['tokens_per_sec']:.4f}, peak "
            f"memory {r['peak_memory_bytes'] / twin['peak_memory_bytes']:.4f}"
            f"; {card}")
    log(f"llama (a): {time.perf_counter() - t0:.1f} s")
    llama_job(cfg, runs["dots_with_no_batch_dims_saveable"]["batch"], card)
    moe_policy(card)
    small_policies(card)
    timing = llama_kernels(card)
    log(f"llama: {time.perf_counter() - t0:.1f} s for parts (a)-(e); {card}")
    return timing


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def main():
    started = time.perf_counter()
    card = phase_device()
    phase_build()
    timing = phase_kernels()
    timing["convfuse_apply"] = phase_convfuse()
    phase_small_model()
    phase_small_resnet()
    counts, main_run = phase_main_path()
    phase_profile()
    counts.update(phase_resnet_path())
    phase_resnet_profile()
    phase_training_job(main_run["tokens_per_sec"], main_run["step_ms"])
    long_timing = phase_long_context()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        timing[name]["longctx"] = {
            shape: {k: r[name][k] for k in ("ms", "bound_ms", "bound_by",
                                            "library_ms", "tflops")}
            for shape, r in long_timing.items()}
    phase_quant()
    mesh_run = phase_mesh(card)
    moe_run = phase_seq_expert(mesh_run, long_timing, card)
    cold = phase_orchestrator(main_run["tokens_per_sec"])
    pipe = phase_pipeline(main_run["tokens_per_sec"], card)
    want, store_drain_s = phase_failures(card)
    local_drain_s = phase_host_and_fleet(main_run["tokens_per_sec"], cold,
                                         want, card)
    phase_observers(main_run, card)
    phase_mesh_layouts(card, moe_run)
    phase_vision_layouts(card)
    phase_store_checkpoints(store_drain_s, local_drain_s, card)
    phase_rules(card)
    llama_timing = phase_llama(card)
    for name, r in llama_timing.items():
        timing[name]["llama3_8b_s8192"] = {k: r[k] for k in (
            "ms", "bound_ms", "bound_by", "library_ms", "tflops")}
    from tony_tpu_torch.ops import _convfuse_cuda, _flash_cuda

    kernels = []
    for name, spec in {**_flash_cuda.SPECS, **_convfuse_cuda.SPECS}.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tony_tpu_torch/csrc/{spec.source}",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("tflops", "llama3_8b", "longctx",
                                 "llama3_8b_s8192") if k in t},
            **({"pipelined_launches_per_step": {
                f"M={m}": counts_m[name] / STEPS
                for m, counts_m in pipe["launches"].items()}}
               if name in _flash_cuda.SPECS else {})})
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all; {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


REPLACES = {
    "flash_fwd": "tony_tpu/ops/attention.py:165",
    "flash_bwd_dq": "tony_tpu/ops/attention.py:258",
    "flash_bwd_dkv": "tony_tpu/ops/attention.py:303",
    "convfuse_apply": "tony_tpu/ops/convfuse.py:90",
}

if __name__ == "__main__":
    main()
