#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build every kernel source with nvcc (one process per source, in
     parallel) and print the seconds, ptxas's registers, static shared
     memory and spills of every STREAM and RMSNorm instantiation;
  1 obs. the observability bus on the card (``phase1_obs``): the
     sequence of ``scripts/torch_obs_smoke.py`` (two
     ``api.launch("stream.scale")``, B2, and one ``plan_for`` under a
     ``JsonlSink`` session), fatal unless the stream holds at least 3
     plan records with a miss and a hit and a launch with no session
     makes no sink call.  Phases 3b (its paged run), 3c (both ``Trainer``
     runs) and 3d (its first launch, ``--obs-jsonl``, rank 0 writing)
     stream too, each gated on its records (``obs:`` lines; 3b also
     prints a decode tick's host ms with no session and with a ring and a
     JSONL session), so does the measure phase, and after 3i ``python -m
     repro_torch.obs.report --fail-on-validation`` over the five streams
     must exit 0 (its summary on ``obs report:`` lines);
  3. the main path at real size through ``repro_torch.api.launch``:
     STREAM copy/scale/add/triad and the Schoenauer triad at n = 2**27
     (fp32 and bf16) and at one ragged n, a phase sweep of
     ``vector_triad_phased`` (stream k at element phase k*p, p = 0..64),
     ``jacobi_sweeps`` on a 16384 x 16384 fp32 grid, ``lbm_run`` for 20
     D3Q19 steps in both layouts at N = 256 and N = 250 (paper Fig. 7,
     MLUP/s printed), and ``vector_triad_segmented`` at n = 2**27 in 8
     segments (paper Fig. 5); launch counters are zeroed just before and
     read just after, and every output is checked against the registered
     plain oracle (or the flat triad) on the card, and STREAM, the triad
     and the phase sweep bit for bit against the kernels' plain versions;
  measure. right after 3 (``measure_phase``, ROADMAP A7.2-A7.5):
     ``measure.validate`` times each of the fifteen registry kernels'
     bodies at its plan on the main path's cells (``CARD_CASES``) against
     the plan's ``predicted_hbm_bytes`` at the data sheet's rate, fatal
     unless every ratio lies in its family's envelope (``measure:``
     lines); ``measure.sweep`` times each geometry of ``SWEEP_CELLS``,
     writes their profile, loads it back strictly and launches each cell
     under ``PlanContext.from_profile``, fatal unless the output equals
     the analytic plan's bit for bit and the cell's ``PlanEvent`` is an
     override from the profile; and it writes the profile of phase 3d's
     rank-local norm cell, which 3d's launches take (``--plan-profile``),
     fatal unless each of their local plans of that cell is an override;
  3b. serving at full Qwen3-4B width, its depth cut to 2 of 36 layers
     to make room for the later phases (bf16, seeded weights, one card):
     ``ContinuousBatcher`` with 8 slots, max_len 1024 and prefill chunk 16
     serves 12 seeded requests (prompts 16-32 tokens, 8-16 new tokens)
     with the paged KV cache and again with the dense one; fatal unless
     every request completes, paged tokens equal dense tokens, two requests
     re-run alone in the same slot geometry give the same tokens, and the
     rmsnorm launch counter, zeroed just before and read just after, is at
     least 5 (2 x 2 layers + the final norm) a decode step.  One
     ``make_prefill_step`` forward at B = 4, S = 512 (rmsnorm on 2048 x
     2560 rows) must give finite logits; ``api.launch("rmsnorm.gated")``
     runs at (2048, 4096);
  3l. right after 3b (``serve_mesh_phase``): 3b's requests served at the
     same width and depth on a (2, 2) mesh of four ranks of the one card
     through ``launch.serve --mesh 2x2 --kv-cache both`` (gloo, its
     collectives staged through pinned host buffers; every rank draws its
     block of the seed-0 weights leaf by leaf and serves under
     ``rules.decode_rules``: 4 of the 8 slots, 16 of 32 heads, 4 of 8 KV
     heads, half the MLP and 75,968 of the 151,936 vocabulary columns a
     rank), paged and dense, then a teacher-forced replay of the first 16
     tokens (32 before phase 3m) of 3b's first 8 one-device streams and one
     profiled decode
     tick; fatal unless every request completes on every rank, paged
     tokens equal dense tokens on every rank and the ranks agree, each
     rank launched B9 at least 5 times a decode step, each replayed
     step's logits (gathered over the vocab ranks) lie within
     ``REPLAY_ULPS`` (8) bf16 ulps of the step's largest one-device
     |logit| of 3b's, the greedy tokens equal 3b's wherever 3b's top-2
     gap exceeds that bound, and each free-running stream that is not
     3b's leaves it first at a token where 3b's top-2 gap (its stream
     teacher-forced on one device) is below the same bound; prints how
     many free-running streams equal 3b's, ms a decode step, collectives
     a step and their host ms, the tick's busy share and each rank's peak
     memory;
  3m. right after 3l (``serve_flash_phase``): flash decoding,
     Qwen2-0.5B at full width (2 of 24 layers, bf16, seed-0 weights)
     serving 3b's request shapes on a (1, 4) mesh of four ranks of the
     card through ``launch.serve --mesh 1x4 --kv-cache both`` under
     ``rules.decode_rules``: its 2 KV heads do not divide 4, so a rank's
     dense cache holds 256 of each slot's 1,024 positions of both KV
     heads (the owner of a position writes it), all 14 query heads, a
     quarter of the MLP and of the vocabulary, and every layer combines
     the ranks' softmax partials (a pmax and a psum); fatal unless every
     request completes on every rank, paged tokens equal dense tokens on
     every rank and the ranks agree, a rank's dense cache leaf holds 256
     positions, each rank launched B9 at least 5 times a decode step, and
     a teacher-forced replay of the first 16 prompt tokens of 8 requests
     lies within ``REPLAY_ULPS`` bf16 ulps of one device's logits with the
     greedy tokens equal wherever one device's top-2 gap exceeds that
     bound; prints ms a decode step, collectives a step and their host
     ms, each rank's peak memory and cache bytes against one device's;
  3c. training at full Qwen2-0.5B width, its depth cut to 8 of 24 layers
     to make room for phase 3k (``TRAIN_LAYERS``; d_model 896, 14/2
     heads, d_ff 4864, vocab 151936, tied embeddings, QKV bias; bf16 with
     an fp32 master, remat on, seeded weights, one card): first the
     reduced fp32 model's loss and every gradient leaf on the card against
     the CPU, and the full model's first backward (every leaf finite and
     nonzero somewhere); then ``Trainer`` runs 8 AdamW steps on
     ``DataConfig(151936, seq_len 512, batch 8)`` (4096 tokens a step,
     cosine schedule, peak 3e-4, warmup 2) with a checkpoint every 4 steps
     (keep 1) under build/, fatal unless every loss is finite, the loss of
     a batch the run never trains on (batch 8) is lower at the trained
     weights than at the initial ones, the cross-entropy kernel ran once a
     step and RMSNorm
     at least 17 times (2 x 8 layers + the final norm) a step; a fresh
     ``Trainer`` restores step 4, whose state
     must equal the one saved bit for bit, and replays steps 4-7: step 4's
     loss must equal the uninterrupted run's bit for bit, later ones to a
     stated tolerance.  The checkpoints are deleted at the end;
  3d. tensor- and vocab-parallel training on a (1, 2) mesh: the partial
     cross-entropy
     kernel (B12) first, at the (4096, 75968) vocab shards of M = 2 (both
     shards) and M = 4, fp32 and bf16, and a ragged shard, against its plain
     version (m and ll exact, l to rtol 1e-5 fp32 / 2e-2 bf16), and the
     shards' partials combined into each row's NLL against B11 on the whole
     row (rtol 1e-5); then the vocab-parallel backward on a (2, 2) mesh
     of four ranks on the card: ``xent`` and ``xent_grad`` at (256, 32000),
     logical vocab 31990, and the reduced fp32 model with a vocab of 500
     padded to 512 (``padded_for_mesh``) and the reduced fp32 moe (top-2
     of 8 at capacity factor 1, ``moe_groups`` 1, remat on), vlm, encdec,
     hybrid and ssm models, and the reduced grok-1-314b under
     ``expert_tp`` (``MESH_FAMILIES``), each under its launchers' rules
     (``rules.launcher_rules``: every family's layers tensor-parallel over
     the model axis, the hybrid and ssm norms split): each model's loss,
     gradient norm, every gradient leaf and two AdamW steps, each rank's
     block against the one-device port on the card, its unsharded leaves
     bit-equal on every rank, B12 and no B11 in each job, B9 where the
     model has it, the split passes of B10 (and of B9 for the sLSTM) and
     no one-pass B10 in the hybrid and ssm jobs
     (``mesh_backward_checks``), and the reduced qwen3-14b, qwen3-moe and
     grok-1-314b under FSDP's rules (``FSDP_CHECKS``: "embed" over "data"
     as well, a rank's embedding block (V/2, d/2)), and in the same spawn
     each reduced family (and qwen3-14b under FSDP's rules) served on the
     mesh under ``rules.decode_rules`` (``SERVE_FAMILIES``,
     ``mesh_checks.serve``: a replay's logits within rtol 1e-5 / atol 1e-5
     of their scale of the one-device port on the card, the ranks' paged
     streams equal to each other and to one device's up to any near-tie),
     the reduced Qwen2-0.5B once more under the flash-decoding override
     (``FLASH_CHECK_RULES``: 2 of 4 query heads a rank, both KV heads,
     half the positions, q gathered; paged equal to dense), and
     the masked loss of the padded reduced Qwen2-0.5B under a seeded, an
     all-ones and an all-zeros mask (``hold_masked``: the backward
     check's gates against one device's masked loss, the all-ones mask at
     the unmasked loss, the all-zeros one 0); then
     the
     full-width Qwen2-0.5B backward (``TRAIN_LAYERS``) in fp32 from
     ``model.init`` on one
     device against a (1, 2) mesh of two ranks on the card, the loss, the
     norm and every gradient leaf (``full_width_backward_check``, whose
     docstring argues the tolerances); then
     ``python -m repro_torch.launch.train --mesh 1x2``
     (``launch.train.main``) spawns two ranks on the one card (gloo, its
     collectives staged through pinned host buffers) that train Qwen2-0.5B
     at full width (``TRAIN_LAYERS``) from seed 0 for 3 steps of the
     training phase's batches
     (``--baseline``: the unpadded vocab, so the weights are the training
     phase's), tensor-parallel: a rank holds 7 of the 14 heads, 1 of the 2
     KV heads, 2,432 of the 4,864 MLP columns and half the vocab, a
     checkpoint every 2 steps gathered into the one-device layout, and one
     more step profiled on rank 0.  Fatal unless each rank's blocks have
     those shapes, the first two losses equal the training phase's to
     ``TP_LOSS_RTOL`` (1e-4, argued where it is defined; step 0's rate is 0
     under warmup: both are forwards of the initial weights), every loss
     is finite, the unsharded leaves of the state hold the same bits on both
     ranks, B12 ran once a rank a step and B11 never; a second launch
     restores step 2 and replays step 2, its loss bit-equal.  The
     bf16 gradient norms are printed beside the one-device run's, not
     gated (the training phase prints the one-device step-0 norm beside
     the same batch's as two microbatches, the spread rounding gives).
     ``spmd:`` lines give ms a step, tokens/s, each rank's peak memory, the
     collective transport, the collectives' calls, bytes and host time, and
     the profiled step's busy share.  Phase 3d's second part runs after
     3h, whose one-device whisper-tiny run it is held against
     (``whisper_mesh_phase``): ``launch.train --arch whisper-tiny`` at
     full width, 4 steps of batch 8 x 448 and one profiled, on a (2, 1)
     mesh (``--baseline``: B11 on each rank's 4 rows) and on a (1, 2) one
     (the vocab padded to the model axis: B12 on each half; 3 of the 6
     heads and half the MLP a rank, tensor-parallel); fatal unless
     every loss is finite and equal on both ranks, B11 ran once a step and
     B12 never on (2, 1) and the reverse on (1, 2), the unsharded leaves
     hold the same bits on both ranks, and the losses of steps 0 and 1
     (forwards of the initial weights: step 0's rate is 0 under warmup)
     are within ``WHISPER_MESH_RTOL`` (1e-4, argued where it is defined)
     of phase 3h's one-device steps 0 and 1 on (2, 1) and within
     ``TP_LOSS_RTOL`` of one-device forwards of the padded config's seeded
     weights on the same batches on (1, 2), with
     ``spmd:`` and ``profile:`` lines.  Two ranks on one card stand in
     for ranks on separate cards: their times are not scaling numbers;
  3j. right after 3d (``recurrent_tp_phase``): the hybrid and ssm
     families tensor-parallel at full width through ``launch.train
     --mesh 1x2 --baseline`` on two ranks of the one card, bf16 + fp32
     master, remat, no checkpoints, 2 steps of 2 x 1024 tokens and one
     profiled for zamba2 (xlstm's profile is not taken, for 3k's seconds):
     zamba2-1.2b at 6 layers (six Mamba2 layers, then its
     shared block: a rank holds 32 of the 64 SSM heads and 2,048 of the
     4,096 ``d_inner`` columns, 16 of the shared block's 32 heads and
     4,096 of its 8,192 MLP columns) and xlstm-1.3b at 8 (seven mLSTM
     layers, 2 of 4 heads and 2,048 of 4,096 columns a rank, and one
     sLSTM, 1,024 of 2,048 columns), each rank's norms split (B10's, and
     B9's for the sLSTM, stats and apply passes around a sum over the
     ranks).  Fatal unless every loss is finite and equal on both ranks,
     step 0's loss is within ``TP_LOSS_RTOL`` of a one-device bf16 loss
     of the same seed's weights on the same batch, each rank's blocks
     have those shapes (``recurrent_cut``), each rank launched B12 once a
     step and no B11, the split passes once a layer a forward (remat's
     recomputation one more) and no one-pass B10, and the unsharded
     leaves hold the same bits on both ranks; ``spmd:`` and ``profile:``
     lines give ms a step, tokens/s, busy share, collectives and peaks;
  3k. right after 3j (``fsdp_phase``): FSDP, qwen3-14b at full width
     (d_model 5120, 40 heads over 8 KV heads, d_ff 17408, vocab 151936),
     its depth cut to 1 of 40 layers, through ``launch.train --mesh 2x1``
     under its launchers' rules (``fsdp`` on: every "embed" dim cut over
     "data"), bf16 + fp32 master, remat, 2 steps of 4 x 1024 tokens and one
     profiled, the final save gathered leaf by leaf and written by rank 0
     (deleted after); fatal unless each rank's blocks of the parameters,
     moments and master copy hold half of every "embed" dim, every loss is
     finite and equal on both ranks, the losses and gradient norms are
     within ``TP_LOSS_RTOL`` and ``FSDP_NORM_RTOL`` of one-device bf16
     train steps of the same seed's state, step 1's update in the final
     save's master copy within ``FSDP_UPDATE_RTOL`` of one device's, the
     unsharded leaves hold the same bits on both ranks, B11
     ran once a rank a step and B12 never, and each rank's peak memory is
     below the replicated train state's bytes; ``spmd:`` and ``profile:``
     lines give ms a step, tokens/s, busy share, peaks beside the FSDP
     and replicated states, the collectives a step, and the save's seconds,
     bytes and the disk's free space;
  3e. the hybrid at full zamba2-1.2b width, its depth cut to 12 of its 38
     Mamba2 layers to make room for the later phases (d_model 2048,
     d_inner 4096, 64 SSM heads of 64, state 64; one shared attention
     block applied after every 6, so at two stages, each with its own KV
     cache; vocab 32000), bf16, seeded
     weights,
     one card: ``ContinuousBatcher`` with 3b's slots, max_len, prefill
     chunk and 12 requests, paged and dense; fatal unless every request
     completes, paged tokens equal dense tokens, requests 0 and 1 re-run
     alone in the same slot geometry give the batched tokens (a reused
     slot's SSM state is reset), and the counters, zeroed just before and
     read just after, show at least 17 B9 launches (12 mamba ln1, 2 x 2
     of the shared block, the final norm) and 12 B10 launches (each Mamba2
     gate and norm) a decode step; a ``profile:`` line of one decode tick;
     one ``make_prefill_step`` forward at B = 4, S = 512 (two chunks of
     the SSD, where the reference's forward is NaN; B10 on 2048 x 4096
     rows inside the model) with finite logits and exactly 17 and 12
     launches; the reduced fp32 hybrid's loss and every gradient leaf at
     S = 300 (across a chunk) on the card (B9, B10, B11 under their
     autograd Functions, remat on) against the CPU, loss rtol 1e-5, each
     leaf rtol 1e-4 / atol 1e-2 of its scale, every leaf nonzero; then one
     bf16 forward each of minicpm-2b and qwen3-14b at full width, B = 1,
     S = 512, fatal unless the logits are finite and B9 ran 81 times
     (2 x 40 layers + the final norm), each model freed before the next;
  3f. the ssm family at full xlstm-1.3b width, its depth cut to 8 of its
     48 layers (1 of its 6 x [7 mLSTM, 1 sLSTM] blocks) to make room for
     the later phases (d_model 2048, mLSTM d_inner 4096 in 4 heads of 1024;
     vocab 50304; no attention), bf16, seeded weights, one card:
     ``ContinuousBatcher`` with 3b's slots, max_len, prefill chunk and 16
     requests, paged and dense; fatal unless every request completes, paged
     tokens equal dense tokens, requests 0 and 1 re-run alone in the same
     slot geometry give the batched tokens (a reused slot's mLSTM and sLSTM
     state is reset), and the counters, zeroed just before and read just
     after, show at least 10 B9 launches (8 ln1, 1 sLSTM output norm on
     fp32 rows, the final norm) and 7 B10 launches (each mLSTM gate and
     norm) a decode step, over the runs and in one decode step alone; a
     ``profile:`` line of one decode tick and one of the mLSTM state
     update's ops on the 2.8 GB of matrix memory (CUDA events, its share
     of the tick); two ``make_prefill_step`` forwards at B = 4, S = 512
     (two mLSTM chunks) with finite logits and exactly 28 and 21 launches
     each, both timed (the first includes warm-up); the reduced fp32
     xlstm's loss and every gradient leaf at S = 300 (past the length
     where the reference's mLSTM gradient is NaN) on the card (B9, B10,
     B11 under their autograd Functions, remat on) against the CPU, loss
     rtol 1e-5, each leaf rtol 1e-4 / atol 1e-2 of its scale, every leaf
     nonzero;
  3g. the moe family at full qwen3-moe-30b-a3b width (48 layers, d_model
     2048, 32/4 heads of 128, 128 experts of d_ff 768, top-8, capacity
     factor 1.25, skewed expert placement; vocab 151936), bf16, seeded
     weights, one card: the whole model initialised on the card (its
     parameter count, bytes and peak memory printed), one
     ``make_prefill_step`` forwards at B = 4, S = 512 through all 48
     layers with finite logits and exactly 97 B9 launches each, both timed
     (the first includes warm-up); ``ContinuousBatcher``
     with 3b's slots, max_len, prefill chunk and 12 requests over the
     first ``MOE_SERVE_LAYERS`` layers (views of the same stacked tensors),
     paged and dense, fatal unless every request completes, paged tokens
     equal dense tokens at the config's capacity factor and the counter,
     zeroed just before and read just after, shows at least 2 x layers + 1
     B9 launches a decode step, over the runs and in one step alone; a
     ``profile:`` line of one decode tick and one of the three expert
     products over the served layers beside their byte bound; requests 0
     and 1 batched and each alone at capacity factor 16 (>= E / k, so
     nothing drops) give the same tokens; the reduced fp32 MoE (top-2 of 8,
     capacity factor 1.0, so assignments drop) loss and every gradient leaf
     on the card (B9, B11 under their autograd Functions, remat on) against
     the CPU with the same expert picks and kept masks, loss rtol 1e-5,
     each leaf within 1e-4 of its scale;
  3h. the vlm family at full pixtral-12b width (40 layers, d_model 5120,
     32/8 heads of 128, d_ff 14336, vocab 131072 untied, a 1,024-token
     image prefix) and the encdec family at full whisper-tiny width (4
     encoder and 4 decoder layers, d_model 384, 6 heads, LayerNorm, GELU,
     vocab 51865 tied, 1,500 frames), seeded weights, one card, after
     every earlier tensor is freed: pixtral's whole model initialised in
     bf16 (its parameter count, equal to its param_defs', bytes and peak
     memory printed), two forwards at full depth of B = 4 rows of 1,024
     seeded image embeddings and 512 text tokens, fatal unless the logits
     are finite of shape (4, 512, 131072) and B9 ran exactly 81 times
     each; ``ContinuousBatcher`` serving text with 3b's slots, max_len,
     prefill chunk and 12 requests through the first ``VLM_SERVE_LAYERS``
     layers (views of the same tensors), paged and dense, fatal unless
     every request completes, paged tokens equal dense tokens and B9 ran
     at least 2 x layers + 1 times a decode step, over the runs and in one
     step alone, and a ``profile:`` line of one decode tick; then
     whisper's fp32 forward on the card against the CPU (TF32 off, rtol
     1e-4 / atol 1e-4) and its decode steps against its forward over 32
     positions (the reference's 2e-3); a static batch of 8 rows over 1,500
     seeded frames, 64 prompt and 384 new tokens, served twice through
     ``launch.serve.serve_static`` (``prefill_cross``, then one token a
     step), fatal unless both runs give the same tokens and the bf16
     model's decode steps match its forward over 32 positions within 8
     bf16 ulps of the largest logit, with ``serve:`` and ``profile:``
     lines; ``Trainer`` runs 8 steps at batch 8 x 448
     tokens (bf16, fp32 master, remat), fatal unless every loss is finite,
     the held-out loss falls and B11 ran once a step, reading the (3584,
     51865) logits in place (the pointer it gets in the profiled step
     and its warm-up is the logits' ``data_ptr``, and a step traced with
     its shapes pads no tensor of the vocab's width); and the reduced fp32
     pixtral (8 image
     embeddings) and whisper (2 + 4 layers, 16 frames) train steps on the
     card (B9 and B11 under their autograd Functions, remat on) against
     the CPU, loss rtol 1e-5, each leaf within 1e-4 of its scale;
  3i. the Jacobi and LBM halo-exchange shard bodies on a (2, 1) mesh of
     two ranks of the one card in one spawn, gloo with the halos staged
     through pinned host buffers (``launch.mesh_checks.halo_card``): each
     rank makes the main path's 16384 x 16384 fp32 grid and its N = 256
     and 250 lattices from the seed and keeps its half (8,192 rows; 128 or
     125 X planes), its counters zeroed just before ``jacobi_sweeps`` (20
     sweeps) and ``lbm_run`` (20 steps, both layouts) and read just after;
     fatal unless on both ranks each result equals one device's by
     ``torch.equal``, the overlapped Jacobi body equals the blocking one,
     B7 and B8 give every interior site the same bits, ``overlap_report``
     finds both shifts of the overlapped bodies overlappable and none of
     the blocking body's, the bytes ``Mesh.comm`` counted equal
     ``predicted_comm_bytes``, and B6, B7 and B8 launched; the same spawn
     runs ``measure.validate.validate_comm`` with the exposed check on
     Jacobi's grid and both LBM layouts at N = 256 (``HALO_COMM_CASES``),
     fatal unless every record of both ranks is ok.  ``halo:``
     lines give ms a sweep or step overlapped, blocking and on one device
     (rank 0 alone), the interior's CUDA-event time, the halo's bytes and
     host seconds, and, once step 5 has timed the B1 copy, the planner's
     predicted exposed bytes at the copy's and the bare shifts' measured
     rates beside the overlapped time less the interior's.  Two ranks on
     one card share its memory: not a scaling result;
  4. each kernel against its plain PyTorch version on the same inputs at
     the main path's shapes (and B6 on a 3-row slab of the grid, and phase
     3i's boundary launches: B6's row entry on a boundary row, B7 on two
     planes at N = 256; and at
     zamba2-1.2b's: B9 at (8, 2048) and
     (2048, 2048), B10 at (8, 4096), bf16; at xlstm-1.3b's sLSTM norm: B9
     on fp32 rows at (8, 2048) and (2048, 2048); and at qwen3-moe-30b-a3b's
     ln1 and ln2: B9 at (8, 2048) and (2048, 2048) bf16; at pixtral-12b's
     norms: B9 at (8, 5120) and (6144, 5120) bf16; at whisper-tiny's loss:
     B11 at (3584, 51865) fp32 and bf16 on the unpadded logits, and at
     its meshes' shapes, B11 on a (2, 1) rank's (1792, 51865) and B12 on
     a (1, 2) rank's (3584, 25984) half of the padded vocab; at
     minicpm-2b's vocab: B11 at (2048, 122753) fp32; B11 and B12 on views
     at storage offset 1; the split norm's stats and apply passes at
     phase 3j's ranks' blocks: B10's at a zamba2 and an mLSTM rank's
     (2048, 2048) bf16, B9's at an sLSTM rank's (2048, 1024) fp32, the
     apply pass with the whole row's width), with the tolerance stated;
  5. CUDA-event times (median of 10 samples after warm-up,
     ``measure.timing.time_ms``) of each kernel, its plain version and one
     PyTorch library call computing the same function (``F.conv2d`` for B6
     with cuDNN's TF32 off, as the line says), beside the least time the
     card could take (``bound_ms``: the larger of the plan's
     ``predicted_hbm_bytes`` over the data sheet's memory rate, or the
     bytes counted here where no plan has the launch's shape, and the
     operations over the fp32 rate),
     with the kernel/library ratio and the share of the bound; the kernel
     and the library call are each timed twice, in turns (kernel, library,
     library, kernel), and the mean kept;
     the LBM collision's time per layout and size apart from the whole
     step, and the segmented triad's time over the flat triad's.

A ``serve:`` line gives requests, generated tokens, seconds, tokens/s,
ticks, ms a decode step, preemptions and the page size (for zamba2-1.2b,
xlstm-1.3b, qwen3-moe-30b-a3b and pixtral-12b also the B9 (and B10)
launches a step, and for xlstm-1.3b, qwen3-moe-30b-a3b, pixtral-12b and
whisper-tiny a summary with the card's busy share of a decode tick), and
a ``profile:``
line where the device time of one decode tick goes; ``train:`` lines the loss at each
step, ms a step (median of steps 1-7), tokens/s and the peak of
``torch.cuda.max_memory_allocated``, and a ``profile:`` line one train
step.

The last three lines are the card's name and power limit as nvidia-smi
reports them, the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the CUDA-event timer and the data-sheet rates: one copy, in ``measure``
from repro_torch.measure.timing import datasheet, time_ms  # noqa: E402

N = 1 << 27                # 512 MiB per fp32 array, far above the 50 MB L2
N_RAGGED = N - 12_345
GRID = 16_384              # Jacobi grid edge: 1 GiB per fp32 buffer
SWEEPS = 20
SCALAR = 3.0
PHASES = range(0, 65)
LBM_SIZES = (256, 250)     # 256: N % 64 == 0, 1.27 GB a lattice; 250: ragged
LBM_STEPS = 20
LBM_BF16_N = 64
OMEGA = 1.2
SEGMENTS = 8               # segmented triad: 8 segments, align 128, shift 16
# serving at full Qwen3-4B width
SERVE_ARCH = "qwen3-4b"
# the depth of phase 3b, cut from 36 layers to 2 so that the script with
# whisper-tiny on two meshes stays near 14 minutes, far enough from its
# 20-minute limit on a slow host; every width is the config's
SERVE_LAYERS = 2
# 12 requests (16 before, cut for phase 3l's seconds): 4 still reuse a slot
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK, SERVE_REQUESTS = 8, 1024, 16, 12
# prompts and new tokens a request (from (32, 256) and (16, 64): 2,452,
# 704 and 1,048 steps; then (16, 32), 455 steps; new tokens halved again
# for phase 3k's seconds, 374 steps; prompts from (32, 128) to (32, 64) and
# 12 requests for phase 3l's seconds, 176 steps; prompts to (16, 32) for
# phase 3m's seconds; a request still crosses up to 2 prefill chunks and 3
# pages of 16 positions)
SERVE_PROMPT, SERVE_GEN = (16, 32), (8, 16)
PREFILL_B, PREFILL_S = 4, 512
# phase 3l: phase 3b's serving on a (2, 2) mesh of four ranks of the card
# through ``launch.serve --mesh 2x2`` (the slots' rows over "data", the
# heads, KV heads, MLP and vocabulary over "model"), paged and dense, and
# a teacher-forced replay of REPLAY_STEPS decode steps of phase 3b's
# one-device token streams (its first SERVE_SLOTS requests).  Each step's
# logits, gathered over the vocab ranks, are held to one device's within
# REPLAY_ULPS bf16 ulps of that step's largest |logit|, and the greedy
# tokens to one device's wherever one device's top-1/top-2 gap exceeds that
# bound.  The bound lies between two readings of scripts/replay_bound.py
# on an H100 (PERF.md): one device with its row-parallel partials rounded
# twice, as the mesh's sums round them, moves a step by 1.6 ulps at most;
# one model rank's fault in one layer (a dropped partial, the wrong
# KV-head shard) by 74 ulps or more at its largest step
# (16 steps, 32 before phase 3m, for its seconds)
SERVE_MESH, REPLAY_STEPS, REPLAY_ULPS = "2x2", 16, 8
SERVE_MESH_DIR = ROOT / "build" / "chip_smoke_serve_mesh"
# phase 3m: flash decoding (ROADMAP A11.5), Qwen2-0.5B at full width on a
# (1, 4) mesh of the card under rules.decode_rules: its 2 KV heads do not
# divide 4 (nor do its 14 query heads), so the dense cache's 1,024
# positions are cut four ways and the softmax's partials combined; depth
# cut to 2 of 24 layers, as 3l serves Qwen3-4B.  Its replay streams are the
# first REPLAY_STEPS prompt tokens of 3b's first SERVE_SLOTS requests
# (drawn for Qwen2-0.5B's vocabulary), held at 3l's REPLAY_ULPS: against
# one device a rank's MLP output is four bf16 partials summed (3l's two
# moved a step by 1.6 ulps at most, so four by about twice that), and the
# combine's fp32 exps and products round the context once where one
# device rounds its probabilities and the context (half an ulp more);
# a dropped or misplaced partial moves a step by tens of ulps (3l's
# readings)
FLASH_ARCH, FLASH_MESH, FLASH_LAYERS = "qwen2-0.5b", "1x4", 2
FLASH_DIR = ROOT / "build" / "chip_smoke_flash"
GATED_SHAPE = (2048, 4096)  # the d_inner of a zamba2-1.2b Mamba2 block
# the obs event streams of phases 1, 3b, 3c and 3d (ROADMAP A7.1), read
# back by the gates and by ``python -m repro_torch.obs.report``
OBS_DIR = ROOT / "build" / "chip_smoke_obs"
# host_ms rounds of a decode tick with no obs session, a RingBufferSink
# session and a JsonlSink session, in turns (10 calls a reading)
OBS_TICK_ROUNDS = 5
SEED = 0
# the measure phase (ROADMAP A7.2-A7.5): the main path's cells whose
# planner knobs give more than one geometry, swept, profiled and replayed
# through ``PlanContext.from_profile``; the profile of phase 3d's
# rank-local norm cell, which 3d's launches take through --plan-profile
MEASURE_DIR = ROOT / "build" / "chip_smoke_measure"
SWEEP_CELLS = (("stream.copy", (N,), "float32"),
               ("rmsnorm", (PREFILL_B * PREFILL_S, 2560), "bfloat16"),
               ("rmsnorm.sumsq", (PREFILL_B * PREFILL_S, 1024), "float32"),
               ("rmsnorm.gated", GATED_SHAPE, "bfloat16"))
SPMD_PROFILE = MEASURE_DIR / "spmd_profile.json"
# training at full Qwen2-0.5B width, depth cut to TRAIN_LAYERS of its 24
# layers for phase 3k's seconds (a run's five saves, and the (1, 2)
# launch's and its replay's gathered saves, shrink with the layers)
TRAIN_ARCH, TRAIN_LAYERS = "qwen2-0.5b", 8
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY = 512, 8, 8, 4
TRAIN_PEAK, TRAIN_WARMUP = 3e-4, 2
# phase 3e: serving at full zamba2-1.2b width (the dense phase's slots,
# max_len, chunk and requests), the reduced hybrid's train step at a length
# that crosses the SSD's 256-token chunk, and full-width prefill forwards of
# the two other dense configs
HYBRID_ARCH = "zamba2-1.2b"
# the depth of phase 3e, cut from 38 Mamba2 layers (6 shared-block
# applications) to 12 (2, so that the shared parameters serve two stages,
# each with its own cache, and the second Mamba run reads the shared
# block's output) so that the script stays near 14 minutes; every width is
# the config's
HYBRID_LAYERS = 12
HYBRID_TRAIN_SEQ = 300
DENSE_ARCHS = ("minicpm-2b", "qwen3-14b")
DENSE_PREFILL_S = 512
# phase 3f: serving at full xlstm-1.3b width (the dense phase's slots,
# max_len, chunk and requests), its prefill at two mLSTM chunks, and the
# reduced xlstm's train step at a length past the one where the reference's
# mLSTM gradient is NaN
XLSTM_ARCH = "xlstm-1.3b"
# the depth of phase 3f, cut from 48 layers to 1 of its 6 blocks of 7
# mLSTM and 1 sLSTM so that the script stays near 14 minutes; every width
# is the config's
XLSTM_LAYERS = 8
XLSTM_TRAIN_SEQ = 300
# phase 3g: the moe family at full qwen3-moe-30b-a3b width (the dense
# phase's slots, max_len, chunk and requests): the whole 48-layer model on
# the card and its prefill forward; serving of its first MOE_SERVE_LAYERS
# layers (views of the same stacked tensors, every width the config's) so
# that the script stays near 13 minutes
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PARAMS = 30_532_122_624
MOE_SERVE_LAYERS = 8       # 16 before, cut for phase 3k's seconds
# isolated re-runs at a capacity factor >= E / k (128 / 8): cap >= T, so
# nothing drops and a request alone must give its batched tokens; the
# first MOE_ISOLATED requests batched, then each alone
MOE_NO_DROP_CF, MOE_ISOLATED = 16.0, 2
# the reduced MoE's train step with real routing (top-2 of 8) at a
# capacity factor where assignments drop
MOE_TRAIN_CF, MOE_TRAIN_SEQ = 1.0, 64
# phase 3h: the vlm family at full pixtral-12b width (the whole 40-layer
# model on the card and its prefill forward behind its 1,024-token image
# prefix; serving of text through its first VLM_SERVE_LAYERS layers, views
# of the same stacked tensors, every width the config's, cut for time) and
# the encdec family at full whisper-tiny width (a static batch of 8 rows
# over 1,500 frames, 64 prompt and 384 new tokens: Whisper's 448-position
# decoder context; training at batch 8 x 448 tokens)
VLM_ARCH = "pixtral-12b"
VLM_PARAMS = 12_247_782_400
VLM_SERVE_LAYERS = 8
VLM_PREFILL_S = 512            # text positions behind the image prefix
ENCDEC_ARCH = "whisper-tiny"
ENCDEC_ROWS, ENCDEC_PROMPT, ENCDEC_GEN = 8, 64, 384
ENCDEC_CHECK = 32              # decode = forward over the first positions
ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_STEPS = 448, 8, 8
MULTIMODAL_DIR = ROOT / "build" / "chip_smoke_multimodal"
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
# a replayed step after the first: a backward that sums with atomics may
# change the last bits of a gradient, and a bf16 weight whose fp32 master
# crosses a rounding boundary then moves by one bf16 ulp
REPLAY_RTOL = 1e-3
XENT_RAGGED = (1000, 32_008, 32_000)   # (tokens, width, logical vocab) bf16
# B11 at minicpm-2b's vocab, no whole number of 16-B vectors a row:
# (tokens, width, logical vocab) fp32
XENT_MINICPM = (2048, 122_753, 122_753)
# vocab-parallel training on two ranks of the one card
# phase 3i: the Jacobi and LBM halo bodies on a (2, 1) mesh of two ranks
# of the one card, each rank a half of the main path's grid and lattices
HALO_MESH = (2, 1)
# phase 3i's comm census (ROADMAP A7.2, ``measure.validate.validate_comm``
# with the exposed check) at the main path's global cells, in 3i's spawn
HALO_COMM_CASES = {"jacobi": ((GRID, GRID), "float32"),
                   "lbm.soa": ((19,) + (LBM_SIZES[0],) * 3, "float32"),
                   "lbm.ivjk": ((19,) + (LBM_SIZES[0],) * 3, "float32")}
SPMD_MESH, SPMD_STEPS, SPMD_CKPT_EVERY = "1x2", 3, 2
SPMD_DIR = ROOT / "build" / "chip_smoke_spmd"
# a tensor-parallel (1, 2) run's first two losses against one device's:
# the schedule's warmup gives step 0 a rate of 0, so both are forwards of
# the same weights.  bf16: each layer's row-parallel outputs (attention's
# wo, the MLP's wo; whisper's cross attention too) are two partial GEMMs
# rounded to bf16 and their sum rounded again, where one device rounds the
# whole product once, so a value moves by at most one more half ulp (2^-9
# of it), with random signs over the values.  Over Qwen2-0.5B's 48 such
# sums (whisper-tiny's 20) the final hidden state moves by about
# sqrt(48) * 2^-9 = 1.4e-2 of itself, and a row's label logit (below 1 at
# the init, the tied head's 0.02 std) by about that share; the loss is the
# mean of 4,096 (3,584) rows' NLL, those moves of random sign, so about
# 1.4e-2 / sqrt(4096) = 2e-4 absolute, 2e-5 of the initial loss ln(V) =
# 11.9 (10.9).  The gate is 1e-4 relative, five times that.  Before tensor
# parallelism the (1, 2) body was whole on both ranks and the gate 1e-6.
# The hybrid and ssm launches (phase 3j) hold step 0 to the same gate: their
# recurrent blocks' row-parallel partials are summed in fp32 and rounded
# once (``blocks.row_parallel``), since in bf16 xlstm-1.3b's moved 2.5e-4;
# what remains is the GEMMs' other tiles at a rank's widths, which the
# mLSTM amplifies: one device's own xlstm loss moves by a like share when
# the batch is evaluated row by row (printed beside the gate), and the same
# cut in fp32 lands within FULL_LOSS_RTOL of one device (phase 3j's
# witness, ``full_width_backward_check``), where a fault would not
TP_LOSS_RTOL = 1e-4
# the vocab-parallel backward where rounding cannot hide a fault: reduced
# fp32 qwen2-0.5b with a vocab of 500 padded for the model axis to 512 (the
# logical limit inside the last shard) on a (2, 2) mesh of four ranks on the
# card, and the loss alone at (tokens, vocab, logical vocab), both against
# the one-device port on the card from the same inputs
MESH_CHECK, MESH_CHECK_VOCAB, MESH_CHECK_LR = (2, 2), 500, 1e-3
# the other families on the same (2, 2) mesh (ROADMAP A11.4-5), reduced
# fp32, each under its launchers' rules (name -> arch, config changes): the
# MoE with real routing, top-2 of 8 at the capacity factor where
# assignments drop, moe_groups 1 (every config's: each rank gathers the
# slot ids), remat on (its recomputation gathers again, on autograd's
# device thread) and its experts split over the model ranks; grok-1-314b
# under expert_tp, each expert's MLP split over them (ROADMAP §C's input)
MESH_FAMILIES = {
    "moe": (MOE_ARCH, dict(top_k=2, capacity_factor=MOE_TRAIN_CF,
                           moe_groups=1, remat=True)),
    "vlm": (VLM_ARCH, {}),
    "encdec": (ENCDEC_ARCH, {}),
    "hybrid": (HYBRID_ARCH, {}),
    "ssm": (XLSTM_ARCH, {}),
    "grok": ("grok-1-314b", {}),
}
MESH_FAMILY_SEQ = 64
# phase 3j: the hybrid and ssm families tensor-parallel at full width on a
# (1, 2) mesh of the card through the launcher: arch -> layers, zamba2-1.2b
# cut to six Mamba2 layers and its shared block, xlstm-1.3b to one of its
# blocks of seven mLSTM and one sLSTM; 1,024 tokens a row cross the SSD's
# and the mLSTM's 256-token chunks
RECURRENT_TP = {HYBRID_ARCH: 6, XLSTM_ARCH: 8}
# 2 steps (not 3), for phase 3k's seconds
RECURRENT_TP_STEPS, RECURRENT_TP_BATCH, RECURRENT_TP_SEQ = 2, 2, 1024
RECURRENT_TP_DIR = ROOT / "build" / "chip_smoke_recurrent_tp"
# phase 3k: FSDP (ROADMAP A11.5), qwen3-14b at full width through the
# launcher on a (2, 1) mesh of the card under its launchers' rules
# (``fsdp`` on: "embed" cut over "data"), depth cut to 1 of 40 layers, bf16
# with an fp32 master copy, remat on; each rank holds half of every "embed"
# dim of the parameters, the moments and the master copy.  Its steps are
# held to one-device bf16 train steps of the same seed's state on the same
# batches at TP_LOSS_RTOL: steps 0 and 1 forward the initial weights
# (warmup gives step 0 a rate of 0).  A rank computes its own 2 of the 4
# rows with the whole weights, gathered, so only the GEMMs' other M can
# move a bf16 rounding (whisper-tiny's (2, 1) steps 0-1 are bit-equal,
# phase 3d).  Step 1's update, from the ranks' bf16 gradients
# reduce-scattered over "data" (the FSDP leaves' only sum) and written
# into the donated state, is in the final save
# (1 layer, 2 before phase 3m, for its seconds)
FSDP_ARCH, FSDP_LAYERS, FSDP_STEPS = "qwen3-14b", 1, 2
# step 1's update moves a third step's loss by less than TP_LOSS_RTOL
# (5.06e-5 of it on an H100 80GB HBM3 at 700 W), so the update itself is
# held: the final checkpoint's fp32 master copy of these leaves (two cut by
# FSDP, two whole) less the initial weights, against one device's, as the
# norm of the difference over the norm of one device's (FSDP_UPDATE_RTOL).  Each
# element's gradient differs from one device's by bf16 roundings (2^-8 of
# it) and Adam's m / sqrt(v) is smooth in it, so a few 2^-8 is expected; a
# block's update from another block's gradient, or none, is off by about 1.
# Each step's global gradient norm is held at FSDP_NORM_RTOL, one bf16
# rounding of every element: a leaf summed twice over "data", or not at
# all, moves it by far more
FSDP_UPDATE_LEAVES = ("s00_dense/attn/wq", "s00_dense/mlp/wi",
                      "s00_dense/ln1/scale", "final_norm/scale")
FSDP_UPDATE_RTOL, FSDP_NORM_RTOL = 5e-2, 2.0 ** -8
FSDP_SEQ, FSDP_BATCH = 1024, 4
FSDP_DIR = ROOT / "build" / "chip_smoke_fsdp"
# the reduced fp32 models of the (2, 2) check trained under FSDP's rules,
# make_rules(fsdp=True, expert_tp=cfg.expert_tp): name -> arch, changes
FSDP_CHECKS = {
    "fsdp-dense": (FSDP_ARCH, {}),
    "fsdp-moe": (MOE_ARCH, dict(top_k=2, capacity_factor=MOE_TRAIN_CF,
                                moe_groups=1, remat=True)),
    "fsdp-grok": ("grok-1-314b", {}),
}
# the (2, 2) check's serving jobs (ROADMAP A11.5): each reduced family
# under rules.decode_rules (the moe with real routing), the reduced
# qwen3-14b under FSDP's rules; each serves SERVE_CHECK's requests (count,
# slots, max_len, prefill chunk, replay steps, a static batch's new tokens)
# through the paged cache (phase 3l and the CPU tests hold paged to dense)
SERVE_FAMILIES = {"dense": (TRAIN_ARCH, {}),
                  **{k: v for k, v in MESH_FAMILIES.items() if k != "grok"},
                  "fsdp-dense": (FSDP_ARCH, {})}
SERVE_CHECK = (3, 2, 32, 4, 4, 4)
# flash decoding in the same check (ROADMAP A11.5): the reduced Qwen2-0.5B
# (4 heads, 2 KV heads) under the flash-decoding override on the (2, 2)
# mesh's model axis, so a rank's 2 query heads read every KV head over
# its half of the positions, q gathered over the heads' ranks (the case
# the reduced config reaches at a model axis of 4 on the CPU,
# tests/test_torch_flash_decode.py), paged and dense
FLASH_CHECK_RULES = {"cache_seq": ("model",), "kv_heads": None}
# its cache: 16 positions, 8 a model rank, so SERVE_CHECK's requests (up
# to 7 prompt and 6 new tokens) write into both ranks' blocks
FLASH_CHECK_MAX_LEN = 16
# the masked loss on the same mesh (ROADMAP A11.5): the reduced Qwen2-0.5B
# of the backward check (vocab 500 padded to 512) on batch 0 under a seeded
# mask, an all-ones and an all-zeros mask, against the one-device port
MASK_CHECK_KEEP = 0.6
# phase 3d's second part, after phase 3h: whisper-tiny at full width trained
# through the launcher on a (2, 1) mesh of the card (--baseline: B11 on
# each rank's 4 of the 8 rows x 448) and on a (1, 2) one (the vocab padded
# for the model axis, B12 on each half), a few steps each
WHISPER_MESH_STEPS = 4
WHISPER_MESH_DIR = ROOT / "build" / "chip_smoke_whisper_mesh"
# (2, 1)'s step-0 loss against phase 3h's one-device run of the same
# weights and batch.  A rank computes the same rows with every GEMM's M
# halved (1,792 tokens, 6,000 frames); where cuBLAS picks another kernel
# for the smaller M, a bf16 output may round to its neighbour, one bf16
# ulp (2^-8 of it).  The loss is the mean of 3,584 rows' NLL, each moved
# by its label logit and its log-sum-exp, so at most 2 ulps of the
# largest logit a row, and those roundings have random signs over the
# rows: about 2 * 2^-8 / sqrt(3584) = 1.3e-4 of the logits' scale (below
# 1, the init's tied head), 1.2e-5 of the initial loss ln(51865) = 10.9.
# The gate is 1e-4 relative, eight times that and inside 1e-3.  Step 1 is
# held the same way: step 0's rate is 0 under warmup in both runs, so
# step 1 is a forward of the initial weights on batch 1 in both.
WHISPER_MESH_RTOL = 1e-4
# the full-width fp32 backward, one device against a (1, 2) mesh: the loss,
# the global gradient norm, each leaf as a share of its largest magnitude
# (the argument is in full_width_backward_check)
FULL_LOSS_RTOL, FULL_NORM_RTOL, FULL_LEAF_ATOL = 1e-5, 1e-4, 1e-4
MESH_XENT = (256, 32_000, 31_990)
# a B12 shard with local padding past vl, the vocab ending inside it:
# (tokens, width, vl, offset, logical vocab) bf16
XENT_PARTIAL_RAGGED = (1000, 32_008, 32_000, 96_000, 127_990)

# Each ported kernel: its CUDA source under src/repro_torch/kernels/csrc/
# and where the TPU kernel it replaces is defined.
KERNELS = {
    "stream.copy": ("stream.cu", "src/repro/kernels/stream/kernel.py:21"),
    "stream.scale": ("stream.cu", "src/repro/kernels/stream/kernel.py:25"),
    "stream.add": ("stream.cu", "src/repro/kernels/stream/kernel.py:29"),
    "stream.triad": ("stream.cu", "src/repro/kernels/stream/kernel.py:33"),
    "triad": ("stream.cu", "src/repro/kernels/triad/kernel.py:26"),
    "jacobi": ("jacobi.cu", "src/repro/kernels/jacobi/kernel.py:31"),
    "lbm.soa": ("lbm.cu", "src/repro/kernels/lbm/kernel.py:51"),
    "lbm.ivjk": ("lbm.cu", "src/repro/kernels/lbm/kernel.py:57"),
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:29"),
    "rmsnorm.gated": ("rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:34"),
    # the split norm's passes on a tensor-parallel rank's block of a row
    "rmsnorm.sumsq": ("rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:29"),
    "rmsnorm.apply": ("rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:29"),
    "rmsnorm.gated.sumsq": ("rmsnorm.cu",
                            "src/repro/kernels/rmsnorm/kernel.py:34"),
    "rmsnorm.gated.apply": ("rmsnorm.cu",
                            "src/repro/kernels/rmsnorm/kernel.py:34"),
    "xent": ("xent.cu", "src/repro/kernels/xent/kernel.py:25"),
    "xent.partial": ("xent.cu", "src/repro/kernels/xent/kernel.py:54"),
}
NO_LIBRARY = {"lbm.soa": "no single PyTorch call computes a BGK collision",
              "lbm.ivjk": "no single PyTorch call computes a BGK collision",
              "rmsnorm.gated": "no single PyTorch call gates x by silu(z) "
                               "before an RMSNorm",
              "rmsnorm.apply": "no PyTorch call computes a split norm's "
                               "pass",
              "rmsnorm.gated.sumsq": "no PyTorch call computes a split "
                                     "norm's pass",
              "rmsnorm.gated.apply": "no PyTorch call computes a split "
                                     "norm's pass",
              "xent.ragged": "F.cross_entropy does not mask padded vocab "
                             "columns"}
# the nearest PyTorch call to a kernel that no single call computes
NEAREST = {"xent.partial": "torch.logsumexp(x.float(), -1) of the shard: "
                           "the lse alone, not (m, l, ll)"}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_ms(fn, calls: int = 10) -> float:
    """Host milliseconds to enqueue one call of ``fn`` (no synchronise
    inside the window; the card drains the queue afterwards)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def device_profile(label: str, fn, top: int = 6) -> None:
    """Print the device time of one call of ``fn`` by kernel, as
    torch.profiler's CUDA activity records it, beside the call's
    CUDA-event time; their difference is the card's idle time in the
    call.  Returns (CUDA-event ms, device-kernel ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    # device-side events only (kernels, copies, fills): a host op such as
    # aten::roll also reports the time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.device_time_total for e in rows) / 1e3
    wall = start.elapsed_time(end)
    print(f"profile: {label}: {wall:.3f} ms, device kernels {busy:.3f} ms "
          f"(busy {busy / wall:.1%}) in {sum(e.count for e in rows)} "
          f"launches; "
          + "; ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.3f} ms "
                      f"x{e.count}" for e in rows[:top]))
    return wall, busy


@contextlib.contextmanager
def xent_pointers():
    """Yield (handed, received), filled while the block runs: the
    ``data_ptr`` of every logits tensor handed to ``dispatch.launch("xent")``
    and every logits pointer B11's C entry ``xent_launch`` received, in
    order."""
    from repro_torch.api import dispatch
    from repro_torch.kernels.xent import kernel as xent_kernel

    launch, entry = dispatch.launch, xent_kernel._entry
    lib, c_fn = entry()
    handed, received = [], []

    def spy_launch(kernel, *tensors, **kw):
        if kernel == "xent":
            handed.append(tensors[0].data_ptr())
        return launch(kernel, *tensors, **kw)

    def spy_entry(*args):
        received.append(args[2])
        return c_fn(*args)

    dispatch.launch = spy_launch
    xent_kernel._entry = lambda: (lib, spy_entry)
    try:
        yield handed, received
    finally:
        dispatch.launch, xent_kernel._entry = launch, entry


def pad_inputs(fn) -> list[list[int]]:
    """Run ``fn`` once under torch.profiler with shapes recorded; return
    the input shape of every ``aten::constant_pad_nd`` or ``aten::pad``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return [list(e.input_shapes[0]) if e.input_shapes else []
            for e in prof.events()
            if e.name in ("aten::constant_pad_nd", "aten::pad")]


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    """Fail unless |got - want| <= atol + rtol * |want| everywhere and
    every value is finite; returns the max abs error.  Callers pass logical
    elements only: a padded LBM site's velocity is NaN by design."""
    import torch

    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.to(torch.float32), want.to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite values")
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        fail(f"{what}: max abs err {float(err.max())} over rtol {rtol} "
             f"atol {atol}")
    return float(err.max())


def tol(dtype) -> tuple[float, float]:
    """Tolerance of the main path against the plain oracle: the oracle
    rounds after each operation in the array dtype and the kernels round
    once, so bf16 may differ by one bf16 rounding (2e-2 relative, as
    tests/test_kernels.py uses); fp32 kernels and oracles both round each
    product and sum separately (rtol 1e-5, atol 1e-6 as there)."""
    import torch

    return (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-6)


def read_stream(path) -> list[dict]:
    """The records of a ``JsonlSink`` stream, one a line."""
    with open(path) as f:
        return [json.loads(line) for line in f]


def kind_counts(records) -> dict[str, int]:
    out: dict[str, int] = {}
    for r in records:
        out[r["kind"]] = out.get(r["kind"], 0) + 1
    return out


def check_serve_stream(ring, batcher, reqs, records) -> None:
    """Phase 3b's gates on the paged run's obs stream (``ring`` in memory,
    ``records`` read back from its file): a ``batcher_tick`` a tick, an
    admission for every request, the preemptions of ``preemption_log`` in
    its order, a page-pool record a tick whose pages add up, and no
    abandoned request; prints the ``obs:`` line."""
    if [r["kind"] for r in records] != [e.kind for e in ring.events()]:
        fail("obs: serve: the file's records are not the ring's events")
    by = {k: [r for r in records if r["kind"] == k] for k in
          ("batcher_tick", "admission", "preemption", "page_pool", "plan",
           "request_abandoned")}
    if [r["tick"] for r in by["batcher_tick"]] != list(
            range(1, batcher.ticks + 1)):
        fail(f"obs: serve: {len(by['batcher_tick'])} batcher_tick records "
             f"for {batcher.ticks} ticks")
    rids = sorted(r["rid"] for r in by["admission"])
    if set(rids) != {r.rid for r in reqs}:
        fail(f"obs: serve: admissions {rids} do not cover the requests "
             f"{[r.rid for r in reqs]}")
    got = [(r["rid"], r["reason"]) for r in by["preemption"]]
    if got != [tuple(p) for p in batcher.preemption_log]:
        fail(f"obs: serve: preemption records {got} != preemption_log "
             f"{batcher.preemption_log}")
    if len(by["page_pool"]) != batcher.ticks:
        fail(f"obs: serve: {len(by['page_pool'])} page_pool records for "
             f"{batcher.ticks} ticks")
    for r in by["page_pool"]:
        if r["used_pages"] + r["free_pages"] != r["live_pages"]:
            fail(f"obs: serve: page_pool record {r}: used + free != live")
    if by["request_abandoned"]:
        fail(f"obs: serve: {len(by['request_abandoned'])} request_abandoned "
             f"records")
    hits = sum(r["cache"] == "hit" for r in by["plan"])
    print(f"obs: phase 3b paged serve stream: {len(records)} records "
          f"{kind_counts(records)}; "
          f"{len(by['plan']) / batcher.micro_steps:.2f} plan records a "
          f"decode step over {batcher.micro_steps} steps ({hits} hits, "
          f"{len(by['plan']) - hits} misses); batcher_tick = ticks "
          f"({batcher.ticks}), admissions cover all {len(reqs)} requests "
          f"({len(rids)} with replays), preemptions = preemption_log "
          f"({len(got)}), used + free = live pages on every page_pool "
          f"record, no request_abandoned: ok")


def serving_phase() -> tuple[dict[str, int], dict]:
    """Phase 3b: continuous-batching serving at full Qwen3-4B width
    (``SERVE_LAYERS`` of its 36 layers), a
    prefill forward, and the gated norm's launch path.  Each rmsnorm
    counter is zeroed just before a run and read just after; returns the
    launches of each kernel over the phase, and for phase 3l the paged
    run's streams, the first ``SERVE_SLOTS`` requests' first
    ``REPLAY_STEPS`` tokens and their teacher-forced logits on one
    device, and every request's ``decisions``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import api, obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import make_requests, teacher_forced_logits
    from repro_torch.models import build_model
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED)
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)
    per_step = 2 * cfg.n_layers + 1      # ln1 + ln2 a layer, the final norm
    counts = {"rmsnorm": 0, "rmsnorm.gated": 0}

    def serve(kv, subset, sinks=()):
        """The requests of ``subset`` served with the ``kv`` cache, under an
        obs session delivering to ``sinks`` where any are given."""
        scope = obs.session(*sinks) if sinks else contextlib.nullcontext()
        with scope:
            batcher = ContinuousBatcher(model, params, slots=SERVE_SLOTS,
                                        max_len=SERVE_MAX_LEN, kv_cache=kv,
                                        prefill_chunk=SERVE_CHUNK)
            torch.cuda.synchronize()
            rms_kernel.LAUNCHES["plain"] = 0
            t0 = time.perf_counter()
            out = batcher.run([Request(r.rid, list(r.prompt),
                                       r.max_new_tokens) for r in subset])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = rms_kernel.LAUNCHES["plain"]
        counts["rmsnorm"] += launched
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {kv}: request {r.rid} did not complete")
        if launched < per_step * batcher.micro_steps:
            fail(f"serve {kv}: {launched} rmsnorm launches for "
                 f"{batcher.micro_steps} decode steps (< {per_step} a step)")
        return batcher, out, secs, launched

    # the paged run streams to the obs bus, the dense one runs outside any
    # session: paged = dense below also holds that the session changes no
    # token
    ring = obs.RingBufferSink(capacity=1 << 20)
    jsonl = obs.JsonlSink(OBS_DIR / "serve.jsonl")
    runs = {}
    for kv in ("paged", "dense"):
        batcher, out, secs, launched = serve(
            kv, reqs, (jsonl, ring) if kv == "paged" else ())
        runs[kv] = (batcher, out)
        tokens = sum(len(v) for v in out.values())
        page = batcher.geometry.page_len if batcher.geometry else None
        print(f"serve: {SERVE_ARCH} bf16 {cfg.n_layers} layers {kv}: "
              f"{len(out)} requests, "
              f"{tokens} generated tokens in {secs:.3f} s, "
              f"{tokens / secs:.2f} tokens/s, {batcher.ticks} ticks, "
              f"{batcher.micro_steps} decode steps "
              f"({secs / batcher.micro_steps * 1e3:.2f} ms a step), "
              f"{len(batcher.preemption_log)} preemptions, page {page}, "
              f"rmsnorm launches {launched}")
    if runs["paged"][1] != runs["dense"][1]:
        bad = [r.rid for r in reqs
               if runs["paged"][1][r.rid] != runs["dense"][1][r.rid]]
        fail(f"serve: paged tokens differ from dense for requests {bad}")
    print(f"serve: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests")
    jsonl.close()
    check_serve_stream(ring, runs["paged"][0], reqs,
                       read_stream(OBS_DIR / "serve.jsonl"))
    for rid in (0, 1):
        _, alone, _, _ = serve("paged", [reqs[rid]])
        if alone[rid] != runs["paged"][1][rid]:
            fail(f"serve: request {rid} alone gave other tokens than batched")
    print("serve: requests 0 and 1 re-run alone in the same slot geometry "
          "give the batched tokens")

    # where the device time of one decode tick goes (all slots stepping)
    batcher = runs["paged"][0]
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(params, batcher.cache, feed)

    device_profile(f"decode tick {SERVE_ARCH} ({cfg.n_layers} layers) "
                   f"{SERVE_SLOTS} slots paged "
                   f"max_len {SERVE_MAX_LEN}", tick, top=8)
    # the bus's cost on this host-bound tick: host ms to enqueue one tick
    # with no session (the default: one enabled() scan a plan_for), in a
    # RingBufferSink session (a PlanEvent built a launch) and in a
    # JsonlSink session (its record also written and flushed), in turns
    tick_sink = obs.JsonlSink(OBS_DIR / "tick.jsonl")
    scopes = {"none": (), "ring": (obs.RingBufferSink(),),
              "jsonl": (tick_sink,)}
    readings = {k: [] for k in scopes}
    for _ in range(OBS_TICK_ROUNDS):
        for k, sinks in scopes.items():
            with obs.session(*sinks) if sinks else contextlib.nullcontext():
                readings[k].append(host_ms(tick))
    tick_sink.close()
    plans = tick_sink.emitted / (OBS_TICK_ROUNDS * 11)
    med = {k: statistics.median(v) for k, v in readings.items()}
    print(f"obs: decode tick host_ms, median of {OBS_TICK_ROUNDS} readings "
          f"of 10 calls in turns: no session {med['none']:.4f}, a "
          f"RingBufferSink session {med['ring']:.4f} "
          f"({med['ring'] - med['none']:+.4f}), a JsonlSink session "
          f"{med['jsonl']:.4f} ({med['jsonl'] - med['none']:+.4f}); "
          f"{plans:.2f} plan records a tick; readings "
          + str({k: [round(x, 4) for x in v] for k, v in readings.items()}))
    # phase 3l's replay input and its one-device logits
    streams = np.array([(r.prompt + runs["paged"][1][r.rid])[:REPLAY_STEPS]
                        for r in reqs[:SERVE_SLOTS]], dtype=np.int32)
    one = {"completed": runs["paged"][1], "streams": streams,
           "replay": teacher_forced_logits(
               model, params, torch.from_numpy(streams).cuda()).cpu(),
           "decisions": decisions(model, params, reqs, runs["paged"][1])}
    del runs, batcher

    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    rms_kernel.LAUNCHES["plain"] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        logits = prefill(params, {"tokens": tokens})
        end.record()
    end.synchronize()
    launched = rms_kernel.LAUNCHES["plain"]
    counts["rmsnorm"] += launched
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size):
        fail(f"prefill: logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("prefill: non-finite logits")
    if launched != per_step:
        fail(f"prefill: {launched} rmsnorm launches, want {per_step}")
    print(f"prefill: {SERVE_ARCH} bf16 B={PREFILL_B} S={PREFILL_S} "
          f"(rmsnorm on {PREFILL_B * PREFILL_S} x {cfg.d_model} rows): "
          f"{start.elapsed_time(end):.3f} ms, logits finite, rmsnorm "
          f"launches {launched}")
    del model, params, logits

    x, z = (torch.randn(GATED_SHAPE, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    scale = (torch.randn(GATED_SHAPE[-1:], generator=gen, device="cuda")
             + 1).to(torch.bfloat16)
    rms_kernel.LAUNCHES["gated"] = 0
    y = api.launch("rmsnorm.gated", x, z, scale)
    counts["rmsnorm.gated"] = rms_kernel.LAUNCHES["gated"]
    err = check_close(f"rmsnorm.gated {GATED_SHAPE} bf16", y,
                      api.ref("rmsnorm.gated", x, z, scale),
                      *tol(torch.bfloat16))
    print(f"main: rmsnorm.gated {GATED_SHAPE} bf16 through api.launch vs "
          f"its oracle: max abs err {err:.3g}: ok")
    torch.cuda.empty_cache()
    return counts, one


def decisions(model, params, reqs, completed: dict) -> dict:
    """One device's greedy decisions along each request's served stream:
    per request, the top-1/top-2 gap and the largest |logit| at each of
    its new tokens, from its prompt and tokens teacher-forced
    (``teacher_forced_logits``, every request a row, the shorter streams
    padded at their end, which no earlier position reads)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import teacher_forced_logits

    seqs = [r.prompt + completed[r.rid][:-1] for r in reqs]
    streams = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, seq in enumerate(seqs):
        streams[i, :len(seq)] = seq
    logits = teacher_forced_logits(model, params,
                                   torch.from_numpy(streams).cuda())
    top = torch.topk(logits, 2, dim=-1).values
    gap = (top[..., 0] - top[..., 1]).cpu()              # (T, B)
    peak = logits.abs().amax(-1).cpu()
    del logits, top
    out = {}
    for i, r in enumerate(reqs):
        at = slice(len(r.prompt) - 1, len(seqs[i]))
        out[r.rid] = (gap[at, i], peak[at, i])
    return out


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def serve_mesh_phase(one: dict) -> dict[str, int]:
    """Phase 3l: phase 3b's requests served at full Qwen3-4B width
    (``SERVE_LAYERS`` layers, bf16, seed-0 weights) on a (2, 2) mesh of
    four ranks of the one card through ``launch.serve --mesh 2x2
    --kv-cache both`` (gloo, its collectives staged through pinned host
    buffers): a rank holds 4 of the 8 slots, 16 of 32 heads, 4 of 8 KV
    heads, half the MLP and half the vocabulary.  Each rank zeroes its
    counters just before each run and reads them just after.  Fatal unless
    every request completes on every rank, paged tokens equal dense tokens
    on every rank and the ranks agree, each rank launched B9 at least
    2 x layers + 1 times a decode step, and the teacher-forced replay of
    phase 3b's streams (``one``) holds each step's logits within
    ``REPLAY_ULPS`` bf16 ulps of the step's largest one-device |logit| and
    the greedy tokens equal wherever one device's top-2 gap exceeds that
    bound, and each free-running stream that is not phase 3b's leaves it
    first where one device's top-2 gap (``one["decisions"]``) is below the
    same bound.  Prints how many free-running streams equal phase 3b's, ms a
    decode step, collectives a step and their host ms, a profiled tick's
    busy share and each rank's peak memory; returns the launches summed
    over the ranks."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    SERVE_MESH_DIR.mkdir(parents=True, exist_ok=True)
    path = SERVE_MESH_DIR / "replay.npy"
    np.save(path, one["streams"])
    argv = ["--arch", SERVE_ARCH, "--mesh", SERVE_MESH, "--layers",
            str(SERVE_LAYERS), "--slots", str(SERVE_SLOTS), "--max-len",
            str(SERVE_MAX_LEN), "--requests", str(SERVE_REQUESTS),
            "--prompt-len", *map(str, SERVE_PROMPT), "--gen",
            *map(str, SERVE_GEN), "--kv-cache", "both", "--prefill-chunk",
            str(SERVE_CHUNK), "--seed", str(SEED), "--replay", str(path),
            "--profile"]
    t0 = time.perf_counter()
    try:
        res = serve_launcher.main(argv)
    except RuntimeError as e:
        fail(f"serve mesh: {e}")
    secs = time.perf_counter() - t0
    ranks = res["ranks"]
    per_step = 2 * SERVE_LAYERS + 1
    reqs = {rid: len(toks) for rid, toks in one["completed"].items()}
    launched = 0
    for r in ranks:
        where = f"serve mesh: rank {r['rank']} at {r['coords']}"
        for kv, run in r["runs"].items():
            got = {rid: len(t) for rid, t in run["completed"].items()}
            if got != reqs:
                fail(f"{where} {kv}: completed {got}, want {reqs}")
            n = run["launches"]["plain"]
            launched += n
            if n < per_step * run["micro_steps"]:
                fail(f"{where} {kv}: {n} rmsnorm launches for "
                     f"{run['micro_steps']} decode steps (< {per_step} a "
                     f"step)")
        if r["runs"]["paged"]["completed"] != r["runs"]["dense"]["completed"]:
            fail(f"{where}: paged tokens differ from dense")
    mesh_out = ranks[0]["runs"]["paged"]["completed"]
    # the replay against one device, step by step
    got, want = ranks[0]["replay"], one["replay"]
    if tuple(got.shape) != (REPLAY_STEPS, SERVE_SLOTS, cfg.vocab_size):
        fail(f"serve mesh: replay logits {tuple(got.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("serve mesh: non-finite replay logits")
    top = torch.topk(want, 2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    worst, decided, tight = 0.0, 0, 0
    for t in range(REPLAY_STEPS):
        bound = REPLAY_ULPS * bf16_ulp(float(want[t].abs().max()))
        err = float((got[t] - want[t]).abs().max())
        worst = max(worst, err / bound)
        if err > bound:
            fail(f"serve mesh: replay step {t}: logits {err:.4g} from one "
                 f"device's, over {REPLAY_ULPS} bf16 ulps ({bound:.4g})")
        clear = gap[t] > bound
        if not torch.equal(got[t].argmax(-1)[clear],
                           want[t].argmax(-1)[clear]):
            fail(f"serve mesh: replay step {t}: greedy tokens differ from "
                 f"one device's where its top-2 gap exceeds {bound:.4g}")
        decided += int(clear.sum())
        tight += int((~clear).sum())
    # a free-running stream that leaves phase 3b's must leave it at a
    # near-tie: one device's top-2 gap there below the replay's bound
    same, gaps = 0, []
    for rid, toks in one["completed"].items():
        if mesh_out[rid] == toks:
            same += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(mesh_out[rid], toks))
                 if a != b)
        gap, peak = (float(v[j]) for v in one["decisions"][rid])
        bound = REPLAY_ULPS * bf16_ulp(peak)
        gaps.append(f"request {rid} at token {j}: {gap:.4g} "
                    f"({gap / bound:.3f} of the bound)")
        if gap >= bound:
            fail(f"serve mesh: request {rid} leaves phase 3b's stream at "
                 f"token {j}, where one device's top-2 gap {gap:.4g} "
                 f"exceeds {REPLAY_ULPS} bf16 ulps ({bound:.4g})")
    print(f"serve mesh: {SERVE_ARCH} bf16 {SERVE_LAYERS} layers on a "
          f"{SERVE_MESH} mesh of four ranks on the card "
          f"({ranks[0]['transport']}): every request completes on every "
          f"rank, paged tokens equal dense tokens, the ranks agree; B9 "
          f">= {per_step} launches a decode step on every rank; replay of "
          f"{REPLAY_STEPS} steps x {SERVE_SLOTS} streams: logits within "
          f"{worst:.3f} of the {REPLAY_ULPS}-ulp bound at worst, greedy "
          f"tokens equal at all {decided} decisions whose one-device gap "
          f"exceeds it ({tight} below it); free-running streams equal to "
          f"phase 3b's: {same} of {len(one['completed'])}, each other one "
          f"leaves it where one device's top-2 gap is below the bound"
          f"{' (' + '; '.join(gaps) + ')' if gaps else ''}: ok")
    for kv, run in ranks[0]["runs"].items():
        c = run["comm"]
        steps = max(run["micro_steps"], 1)
        tokens = sum(len(v) for v in run["completed"].values())
        print(f"serve: {SERVE_ARCH} bf16 {SERVE_LAYERS} layers {kv} on "
              f"{SERVE_MESH}: {len(run['completed'])} requests, {tokens} "
              f"generated tokens in {run['seconds']:.3f} s, "
              f"{tokens / run['seconds']:.2f} tokens/s, {run['ticks']} "
              f"ticks, {run['micro_steps']} decode steps "
              f"({run['seconds'] / steps * 1e3:.2f} ms a step), "
              f"{run['preemptions']} preemptions, page {run['page_len']}; "
              f"rank 0's collectives {c['calls']} ({c['calls'] / steps:.1f} "
              f"a step), {c['bytes']} bytes, {c['seconds'] * 1e3:.1f} ms "
              f"on the host's clock ({c['seconds'] / steps * 1e3:.2f} ms a "
              f"step), rmsnorm launches {run['launches']['plain']}")
    prof = ranks[0]["runs"]["paged"]["profile"]
    print_profile(f"decode tick rank 0 of {SERVE_MESH} {SERVE_ARCH} "
                  f"({SERVE_LAYERS} layers) {SERVE_SLOTS} slots paged", prof)
    print("serve mesh: peak memory "
          + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} GiB"
                      for r in ranks)
          + f"; {secs:.1f} s for the launch (spawn, init, two runs, the "
          f"replay, the profiled tick); the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    path.unlink()
    del res, ranks, got
    return {"rmsnorm": launched}


def serve_flash_phase() -> dict[str, int]:
    """Phase 3m: flash decoding (ROADMAP A11.5).  Qwen2-0.5B at full width
    (``FLASH_LAYERS`` of its 24 layers, bf16, seed-0 weights) serves
    phase 3b's request shapes on a (1, 4) mesh of four ranks of the card
    through ``launch.serve --mesh 1x4 --kv-cache both`` under
    ``rules.decode_rules``: its 2 KV heads do not divide 4, so a rank's
    dense cache holds a quarter of each slot's ``SERVE_MAX_LEN``
    positions of both KV heads, every query head (14 do not divide 4
    either), a quarter of the MLP and of the vocabulary; a decode step
    combines the ranks' softmax partials (a pmax, then one psum) in every
    layer.  Each rank zeroes its counters just before each run and reads
    them just after.  Fatal unless every request completes on every rank,
    paged tokens equal dense tokens on every rank and the ranks agree, a
    rank's dense cache leaf holds ``SERVE_MAX_LEN / 4`` positions, each
    rank launched B9 at least 2 x layers + 1 times a decode step, and a
    teacher-forced replay (the first ``REPLAY_STEPS`` prompt tokens of the
    first ``SERVE_SLOTS`` requests) holds each step's logits within
    ``REPLAY_ULPS`` bf16 ulps of the step's largest |logit| of one
    device's run of the same depth and the greedy tokens equal wherever
    one device's top-2 gap exceeds that bound.  Prints ms a decode step
    paged and dense, collectives a step and their host ms, each rank's
    peak memory and its cache bytes against one device's; returns the
    launches summed over the ranks."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch.serve import make_requests, teacher_forced_logits
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(FLASH_ARCH), n_layers=FLASH_LAYERS)
    n = int(FLASH_MESH.split("x")[1])
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)
    streams = np.array([r.prompt[:REPLAY_STEPS] for r in
                        reqs[:SERVE_SLOTS]], dtype=np.int32)
    model = build_model(cfg)
    params = model.init(SEED)
    want = teacher_forced_logits(model, params,
                                 torch.from_numpy(streams).cuda()).cpu()
    one_bytes = {"dense": sum(
        math.prod(d.shape) * d.dtype.itemsize for _, d in
        leaves(model.cache_defs(SERVE_SLOTS, SERVE_MAX_LEN)))}
    del model, params
    torch.cuda.empty_cache()
    FLASH_DIR.mkdir(parents=True, exist_ok=True)
    path = FLASH_DIR / "replay.npy"
    np.save(path, streams)
    argv = ["--arch", FLASH_ARCH, "--mesh", FLASH_MESH, "--layers",
            str(FLASH_LAYERS), "--slots", str(SERVE_SLOTS), "--max-len",
            str(SERVE_MAX_LEN), "--requests", str(SERVE_REQUESTS),
            "--prompt-len", *map(str, SERVE_PROMPT), "--gen",
            *map(str, SERVE_GEN), "--kv-cache", "both", "--prefill-chunk",
            str(SERVE_CHUNK), "--seed", str(SEED), "--replay", str(path)]
    t0 = time.perf_counter()
    try:
        res = serve_launcher.main(argv)
    except RuntimeError as e:
        fail(f"serve flash: {e}")
    secs = time.perf_counter() - t0
    ranks = res["ranks"]
    per_step = 2 * FLASH_LAYERS + 1
    want_len = {r.rid: r.max_new_tokens for r in reqs}
    positions = SERVE_MAX_LEN // n
    launched = 0
    for r in ranks:
        where = f"serve flash: rank {r['rank']} at {r['coords']}"
        for kv, run in r["runs"].items():
            got = {rid: len(t) for rid, t in run["completed"].items()}
            if got != want_len:
                fail(f"{where} {kv}: completed {got}, want {want_len}")
            k = run["launches"]["plain"]
            launched += k
            if k < per_step * run["micro_steps"]:
                fail(f"{where} {kv}: {k} rmsnorm launches for "
                     f"{run['micro_steps']} decode steps (< {per_step} a "
                     f"step)")
        if r["runs"]["paged"]["completed"] != r["runs"]["dense"]["completed"]:
            fail(f"{where}: paged tokens differ from dense")
        shape = r["runs"]["dense"]["cache_shapes"]["s00_dense/k"]
        if shape[3] != positions:
            fail(f"{where}: its dense cache leaf is {shape}, not "
                 f"{positions} of {SERVE_MAX_LEN} positions")
    got = ranks[0]["replay"]
    if tuple(got.shape) != tuple(want.shape):
        fail(f"serve flash: replay logits {tuple(got.shape)}, want "
             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("serve flash: non-finite replay logits")
    top = torch.topk(want, 2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    worst, decided, tight = 0.0, 0, 0
    for t in range(REPLAY_STEPS):
        bound = REPLAY_ULPS * bf16_ulp(float(want[t].abs().max()))
        err = float((got[t] - want[t]).abs().max())
        worst = max(worst, err / bound)
        if err > bound:
            fail(f"serve flash: replay step {t}: logits {err:.4g} from one "
                 f"device's, over {REPLAY_ULPS} bf16 ulps ({bound:.4g})")
        clear = gap[t] > bound
        if not torch.equal(got[t].argmax(-1)[clear],
                           want[t].argmax(-1)[clear]):
            fail(f"serve flash: replay step {t}: greedy tokens differ from "
                 f"one device's where its top-2 gap exceeds {bound:.4g}")
        decided += int(clear.sum())
        tight += int((~clear).sum())
    print(f"serve flash: {FLASH_ARCH} bf16 {FLASH_LAYERS} layers on a "
          f"{FLASH_MESH} mesh of {n} ranks on the card "
          f"({ranks[0]['transport']}), the cache's positions cut {n} ways "
          f"(a rank's dense cache leaf "
          f"{ranks[0]['runs']['dense']['cache_shapes']['s00_dense/k']}: "
          f"{positions} of {SERVE_MAX_LEN} positions): every request "
          f"completes on every rank, paged tokens equal dense tokens, the "
          f"ranks agree; B9 >= {per_step} launches a decode step on every "
          f"rank; replay of {REPLAY_STEPS} steps x {SERVE_SLOTS} streams: "
          f"logits within {worst:.3f} of the {REPLAY_ULPS}-ulp bound at "
          f"worst, greedy tokens equal at all {decided} decisions whose "
          f"one-device gap exceeds it ({tight} below it): ok")
    for kv, run in ranks[0]["runs"].items():
        c = run["comm"]
        steps = max(run["micro_steps"], 1)
        tokens = sum(len(v) for v in run["completed"].values())
        print(f"serve: {FLASH_ARCH} bf16 {FLASH_LAYERS} layers {kv} on "
              f"{FLASH_MESH}: {len(run['completed'])} requests, {tokens} "
              f"generated tokens in {run['seconds']:.3f} s, "
              f"{tokens / run['seconds']:.2f} tokens/s, {run['ticks']} "
              f"ticks, {run['micro_steps']} decode steps "
              f"({run['seconds'] / steps * 1e3:.2f} ms a step), "
              f"{run['preemptions']} preemptions, page {run['page_len']}; "
              f"rank 0's collectives {c['calls']} ({c['calls'] / steps:.1f} "
              f"a step), {c['bytes']} bytes, {c['seconds'] * 1e3:.1f} ms "
              f"on the host's clock ({c['seconds'] / steps * 1e3:.2f} ms a "
              f"step), cache {run['cache_bytes']} bytes a rank"
              + (f" against one device's {one_bytes[kv]}" if kv in one_bytes
                 else "") + f", rmsnorm launches {run['launches']['plain']}")
    print("serve flash: peak memory "
          + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} GiB"
                      for r in ranks)
          + f"; {secs:.1f} s for the launch (spawn, init, two runs, the "
          f"replay); the phase took {time.perf_counter() - t_phase:.1f} s")
    path.unlink()
    return {"rmsnorm": launched}


def hybrid_phase() -> dict[str, int]:
    """Phase 3e: continuous-batching serving at full zamba2-1.2b width
    (``HYBRID_LAYERS`` of its 38 Mamba2 layers, and a shared attention
    block; B9 and B10 inside the model), a
    prefill forward past the SSD's chunk, the reduced hybrid's train step on
    the card against the CPU, and full-width prefill forwards of
    minicpm-2b and qwen3-14b.  Each rmsnorm counter is zeroed just before a
    run and read just after; returns the launches of each kernel over the
    phase."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves
    from repro_torch.parallel import steps
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    counts = {"rmsnorm": 0, "rmsnorm.gated": 0}

    def zero():
        rms_kernel.LAUNCHES["plain"] = rms_kernel.LAUNCHES["gated"] = 0

    def read():
        plain, gated = rms_kernel.LAUNCHES["plain"], rms_kernel.LAUNCHES[
            "gated"]
        counts["rmsnorm"] += plain
        counts["rmsnorm.gated"] += gated
        return plain, gated

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS)
    n_mamba = sum(n for kind, n in cfg.stages() if kind == "mamba")
    n_shared = sum(kind == "shared_attn" for kind, _ in cfg.stages())
    # a mamba layer's ln1, a shared block's ln1 and ln2, the final norm;
    # a mamba layer's gated norm
    plain_step, gated_step = n_mamba + 2 * n_shared + 1, n_mamba
    d_inner = cfg.ssm_expand * cfg.d_model
    model = build_model(cfg)
    params = model.init(SEED)
    n_params = sum(t.numel() for _, t in leaves(params))
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)

    def serve(kv, subset):
        batcher = ContinuousBatcher(model, params, slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, kv_cache=kv,
                                    prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                           for r in subset])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read()
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {HYBRID_ARCH} {kv}: request {r.rid} did not "
                     f"complete")
        steps_run = batcher.micro_steps
        if (launched[0] < plain_step * steps_run
                or launched[1] < gated_step * steps_run):
            fail(f"serve {HYBRID_ARCH} {kv}: {launched} (rmsnorm, "
                 f"rmsnorm.gated) launches for {steps_run} decode steps "
                 f"(< ({plain_step}, {gated_step}) a step)")
        return batcher, out, secs, launched

    runs = {}
    for kv in ("paged", "dense"):
        batcher, out, secs, launched = serve(kv, reqs)
        runs[kv] = (batcher, out)
        tokens = sum(len(v) for v in out.values())
        page = batcher.geometry.page_len if batcher.geometry else None
        print(f"serve: {HYBRID_ARCH} bf16 {cfg.n_layers} layers {kv}, "
              f"{n_params} parameters: "
              f"{len(out)} requests, {tokens} generated tokens in "
              f"{secs:.3f} s, {tokens / secs:.2f} tokens/s, "
              f"{batcher.ticks} ticks, {batcher.micro_steps} decode steps "
              f"({secs / batcher.micro_steps * 1e3:.2f} ms a step), "
              f"{len(batcher.preemption_log)} preemptions, page {page}, "
              f"launches rmsnorm {launched[0]} "
              f"({launched[0] / batcher.micro_steps:.1f} a step), "
              f"rmsnorm.gated {launched[1]} "
              f"({launched[1] / batcher.micro_steps:.1f} a step)")
    if runs["paged"][1] != runs["dense"][1]:
        bad = [r.rid for r in reqs
               if runs["paged"][1][r.rid] != runs["dense"][1][r.rid]]
        fail(f"serve {HYBRID_ARCH}: paged tokens differ from dense for "
             f"requests {bad}")
    print(f"serve: {HYBRID_ARCH}: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests")
    for rid in (0, 1):
        _, alone, _, _ = serve("paged", [reqs[rid]])
        if alone[rid] != runs["paged"][1][rid]:
            fail(f"serve {HYBRID_ARCH}: request {rid} alone gave other "
                 f"tokens than batched")
    print(f"serve: {HYBRID_ARCH}: requests 0 and 1 re-run alone in the same "
          f"slot geometry (their slots' SSM state reset on reuse) give the "
          f"batched tokens")

    batcher = runs["paged"][0]
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(params, batcher.cache, feed)

    device_profile(f"decode tick {HYBRID_ARCH} {SERVE_SLOTS} slots paged "
                   f"max_len {SERVE_MAX_LEN}", tick, top=8)
    del runs, batcher

    # the prefill forward where the reference's SSD gives NaN: two chunks
    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    zero()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        logits = prefill(params, {"tokens": tokens})
        end.record()
    end.synchronize()
    launched = read()
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size):
        fail(f"prefill {HYBRID_ARCH}: logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"prefill {HYBRID_ARCH}: non-finite logits")
    if launched != (plain_step, gated_step):
        fail(f"prefill {HYBRID_ARCH}: {launched} (rmsnorm, rmsnorm.gated) "
             f"launches, want ({plain_step}, {gated_step})")
    print(f"prefill: {HYBRID_ARCH} bf16 B={PREFILL_B} S={PREFILL_S} (two "
          f"SSD chunks; rmsnorm on {PREFILL_B * PREFILL_S} x {cfg.d_model} "
          f"rows, rmsnorm.gated on {PREFILL_B * PREFILL_S} x {d_inner}): "
          f"{start.elapsed_time(end):.3f} ms, logits finite, launches "
          f"rmsnorm {launched[0]}, rmsnorm.gated {launched[1]}")
    del model, params, logits
    torch.cuda.empty_cache()

    # the reduced fp32 hybrid: the card (B9, B10, B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights on both, 300 tokens a row across the SSD's chunk; the
    # dense phase's tolerance (loss rtol 1e-5; each gradient leaf rtol 1e-4
    # with an atol of 1e-2 of its scale)
    small = build_model(dataclasses.replace(reduce_for_smoke(cfg),
                                            remat=True))
    tree = numpy_params(small.param_defs(), SEED, true_fan_in=True)
    data = DataConfig(vocab_size=small.cfg.vocab_size,
                      seq_len=HYBRID_TRAIN_SEQ, global_batch=4)
    zero()
    loss, grads = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg), make_batch(data, 0))
    launched = read()
    want, want_g = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg, device="cpu"),
        make_batch(data, 0, device="cpu"))
    if launched[1] < small.cfg.n_layers:
        fail(f"reduced {HYBRID_ARCH} train step: {launched[1]} "
             f"rmsnorm.gated launches for {small.cfg.n_layers} mamba layers")
    check_close(f"reduced {HYBRID_ARCH} train step loss, card vs cpu",
                loss.cpu(), want, 1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced {HYBRID_ARCH} train step: gradient of {name} is "
                 f"zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced {HYBRID_ARCH} train step grad {name}, "
                          f"card vs cpu", g.cpu(), w, 1e-4, 1e-2 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {HYBRID_ARCH} fp32 (remat on) S="
          f"{HYBRID_TRAIN_SEQ}: loss {float(loss)!r} on the card, "
          f"{float(want)!r} on the cpu; launches rmsnorm {launched[0]}, "
          f"rmsnorm.gated {launched[1]}; every one of "
          f"{len(list(leaves(grads)))} gradient leaves finite, nonzero and "
          f"within rtol 1e-4 / atol 1e-2 of its scale (worst {worst:.3g} of "
          f"scale): ok")
    del grads, want_g

    # the other dense configs at full width: one bf16 prefill forward each
    for arch in DENSE_ARCHS:
        dcfg = get_config(arch)
        dmodel = build_model(dcfg)
        dparams = dmodel.init(SEED)
        n = sum(t.numel() for _, t in leaves(dparams))
        tokens = torch.randint(0, dcfg.vocab_size, (1, DENSE_PREFILL_S),
                               generator=gen, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        zero()
        start.record()
        with torch.inference_mode():
            logits, _ = dmodel(dparams, tokens)
        end.record()
        end.synchronize()
        launched = read()
        want_plain = 2 * dcfg.n_layers + 1
        if tuple(logits.shape) != (1, DENSE_PREFILL_S, dcfg.vocab_size):
            fail(f"prefill {arch}: logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"prefill {arch}: non-finite logits")
        if launched[0] != want_plain:
            fail(f"prefill {arch}: {launched[0]} rmsnorm launches, want "
                 f"{want_plain}")
        print(f"prefill: {arch} bf16 full width, {n} parameters, B=1 "
              f"S={DENSE_PREFILL_S}: {start.elapsed_time(end):.3f} ms, "
              f"logits finite, rmsnorm launches {launched[0]}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del dmodel, dparams, logits
        torch.cuda.empty_cache()
    print(f"hybrid: the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def xlstm_phase() -> dict[str, int]:
    """Phase 3f: continuous-batching serving at full xlstm-1.3b width
    (mLSTM and sLSTM blocks, no attention; B10 inside each mLSTM layer, B9
    behind every layer and inside each sLSTM layer), the share of a decode
    step the mLSTM state update takes, two prefill forwards past the
    mLSTM's chunk, and the reduced xlstm's train step on the card against
    the CPU.  Each rmsnorm counter is zeroed just before a run and read
    just after; returns the launches of each kernel over the phase."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves
    from repro_torch.parallel import steps
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counts = {"rmsnorm": 0, "rmsnorm.gated": 0}

    def zero():
        rms_kernel.LAUNCHES["plain"] = rms_kernel.LAUNCHES["gated"] = 0

    def read():
        plain, gated = rms_kernel.LAUNCHES["plain"], rms_kernel.LAUNCHES[
            "gated"]
        counts["rmsnorm"] += plain
        counts["rmsnorm.gated"] += gated
        return plain, gated

    cfg = dataclasses.replace(get_config(XLSTM_ARCH), n_layers=XLSTM_LAYERS)
    n_m = sum(n for kind, n in cfg.stages() if kind == "mlstm")
    n_s = sum(n for kind, n in cfg.stages() if kind == "slstm")
    # ln1 a layer, an sLSTM's output norm, the final norm; an mLSTM's gate
    # and norm
    plain_step, gated_step = cfg.n_layers + n_s + 1, n_m
    d_inner = 2 * cfg.d_model
    model = build_model(cfg)
    params = model.init(SEED)
    n_params = sum(t.numel() for _, t in leaves(params))
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)

    def serve(kv, subset):
        batcher = ContinuousBatcher(model, params, slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, kv_cache=kv,
                                    prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                           for r in subset])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read()
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {XLSTM_ARCH} {kv}: request {r.rid} did not "
                     f"complete")
        steps_run = batcher.micro_steps
        if (launched[0] < plain_step * steps_run
                or launched[1] < gated_step * steps_run):
            fail(f"serve {XLSTM_ARCH} {kv}: {launched} (rmsnorm, "
                 f"rmsnorm.gated) launches for {steps_run} decode steps "
                 f"(< ({plain_step}, {gated_step}) a step)")
        return batcher, out, secs, launched

    runs, batcher = {}, None
    for kv in ("paged", "dense"):
        b, out, secs, launched = serve(kv, reqs)
        tokens = sum(len(v) for v in out.values())
        ms = secs / b.micro_steps * 1e3
        runs[kv] = (out, tokens / secs, ms)
        if kv == "paged":
            batcher = b
        state = sum(t.numel() * t.element_size()
                    for key, sub in b.cache.items() if isinstance(sub, dict)
                    for _, t in leaves(sub))
        page = b.geometry.page_len if b.geometry else None
        print(f"serve: {XLSTM_ARCH} bf16 {kv}, {n_params} parameters, "
              f"{state} B of recurrent state: {len(out)} requests, {tokens} "
              f"generated tokens in {secs:.3f} s, {tokens / secs:.2f} "
              f"tokens/s, {b.ticks} ticks, {b.micro_steps} decode steps "
              f"({ms:.2f} ms a step), {len(b.preemption_log)} preemptions, "
              f"page {page}, launches rmsnorm {launched[0]} "
              f"({launched[0] / b.micro_steps:.1f} a step), rmsnorm.gated "
              f"{launched[1]} ({launched[1] / b.micro_steps:.1f} a step)")
        del b
    if runs["paged"][0] != runs["dense"][0]:
        bad = [r.rid for r in reqs
               if runs["paged"][0][r.rid] != runs["dense"][0][r.rid]]
        fail(f"serve {XLSTM_ARCH}: paged tokens differ from dense for "
             f"requests {bad}")
    print(f"serve: {XLSTM_ARCH}: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests")

    # one decode tick (all slots stepping): its launches, where its device
    # time goes, and the mLSTM state update's share of it
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(params, batcher.cache, feed)

    tick()
    torch.cuda.synchronize()
    zero()
    tick()
    torch.cuda.synchronize()
    launched = read()
    if launched[0] < plain_step or launched[1] < gated_step:
        fail(f"decode step {XLSTM_ARCH}: {launched} (rmsnorm, "
             f"rmsnorm.gated) launches (< ({plain_step}, {gated_step}))")
    print(f"serve: {XLSTM_ARCH}: one decode step launches rmsnorm "
          f"{launched[0]} and rmsnorm.gated {launched[1]} times (gates "
          f">= {plain_step}, >= {gated_step})")
    wall, busy = device_profile(
        f"decode tick {XLSTM_ARCH} {SERVE_SLOTS} slots paged max_len "
        f"{SERVE_MAX_LEN}", tick, top=8)
    # the decode step's ops on the matrix memory C of every mLSTM layer, as
    # models.xlstm.mlstm_decode_step runs them (C *= f; C += (i k) v^T; q C),
    # with f = 1 and i = 0 so the state keeps its values
    cs = [c for key, sub in batcher.cache.items()
          if key.endswith("_mlstm") for c in sub["c"].unbind(0)]
    b_, h_, p_ = cs[0].shape[:3]
    ones = torch.ones((b_, h_, 1, 1), device="cuda")
    ik = torch.zeros((b_, h_, p_, 1), device="cuda")
    v = torch.randn((b_, h_, 1, p_), device="cuda")
    q = torch.randn((b_, h_, p_), device="cuda")

    def state_update():
        with torch.inference_mode():
            for c in cs:
                c.mul_(ones)
                c.addcmul_(ik, v)
                torch.einsum("bhp,bhpq->bhq", q, c)

    c_bytes = sum(c.numel() * c.element_size() for c in cs)
    state_ms = time_ms(state_update, samples=5, per_sample=2)
    bw = datasheet(torch.cuda.get_device_name(0))[0]
    print(f"profile: {XLSTM_ARCH} mLSTM state update of a decode step (C *= "
          f"f, C += (i k) v^T, q C over {len(cs)} layers of "
          f"{tuple(cs[0].shape)} fp32, {c_bytes} B): {state_ms:.3f} ms, "
          f"{state_ms / busy:.1%} of the tick's device time and "
          f"{state_ms / wall:.1%} of its {wall:.3f} ms; five passes over "
          f"C, bound of the two a step needs {2 * c_bytes / bw * 1e3:.3f} ms")
    print(f"serve: {XLSTM_ARCH} summary: paged {runs['paged'][1]:.2f} "
          f"tokens/s, {runs['paged'][2]:.2f} ms a decode step; dense "
          f"{runs['dense'][1]:.2f} tokens/s, {runs['dense'][2]:.2f} ms a "
          f"decode step; the card busy {busy / wall:.1%} of a profiled "
          f"decode tick ({busy:.3f} of {wall:.3f} ms), the mLSTM state "
          f"update {state_ms / wall:.1%} of it")
    batched = runs["paged"][0]
    del batcher, cs, runs
    torch.cuda.empty_cache()

    # slot reuse with the mLSTM and sLSTM state: requests alone
    for rid in (0, 1):
        _, alone, _, _ = serve("paged", [reqs[rid]])
        if alone[rid] != batched[rid]:
            fail(f"serve {XLSTM_ARCH}: request {rid} alone gave other "
                 f"tokens than batched")
    print(f"serve: {XLSTM_ARCH}: requests 0 and 1 re-run alone in the same "
          f"slot geometry (their slots' mLSTM and sLSTM state reset on "
          f"reuse) give the batched tokens")
    torch.cuda.empty_cache()

    # two prefill forwards of two mLSTM chunks each: the first includes the
    # warm-up of the model's first forward (PERF.md §7)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(2):
        zero()
        with torch.inference_mode():
            start.record()
            logits = prefill(params, {"tokens": tokens})
            end.record()
        end.synchronize()
        launched = read()
        times.append(start.elapsed_time(end))
        if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size):
            fail(f"prefill {XLSTM_ARCH}: logits shape "
                 f"{tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"prefill {XLSTM_ARCH}: non-finite logits")
        if launched != (plain_step, gated_step):
            fail(f"prefill {XLSTM_ARCH}: {launched} (rmsnorm, "
                 f"rmsnorm.gated) launches, want ({plain_step}, "
                 f"{gated_step})")
    print(f"prefill: {XLSTM_ARCH} bf16 B={PREFILL_B} S={PREFILL_S} (two "
          f"mLSTM chunks; rmsnorm on {PREFILL_B * PREFILL_S} x "
          f"{cfg.d_model} rows, bf16 and the sLSTM's fp32, rmsnorm.gated on "
          f"{PREFILL_B * PREFILL_S} x {d_inner}): first {times[0]:.3f} ms, "
          f"second {times[1]:.3f} ms, logits finite, launches rmsnorm "
          f"{launched[0]}, rmsnorm.gated {launched[1]} a forward")
    del model, params, logits
    torch.cuda.empty_cache()

    # the reduced fp32 xlstm: the card (B9, B10, B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights on both, 300 tokens a row, where the reference's mLSTM
    # gradient is NaN; the dense phase's tolerance (loss rtol 1e-5; each
    # gradient leaf rtol 1e-4 with an atol of 1e-2 of its scale)
    small = build_model(dataclasses.replace(reduce_for_smoke(cfg),
                                            remat=True))
    tree = numpy_params(small.param_defs(), SEED, true_fan_in=True)
    data = DataConfig(vocab_size=small.cfg.vocab_size,
                      seq_len=XLSTM_TRAIN_SEQ, global_batch=4)
    zero()
    loss, grads = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg), make_batch(data, 0))
    launched = read()
    want, want_g = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg, device="cpu"),
        make_batch(data, 0, device="cpu"))
    small_m = sum(n for kind, n in small.cfg.stages() if kind == "mlstm")
    if launched[1] < small_m:
        fail(f"reduced {XLSTM_ARCH} train step: {launched[1]} "
             f"rmsnorm.gated launches for {small_m} mLSTM layers")
    check_close(f"reduced {XLSTM_ARCH} train step loss, card vs cpu",
                loss.cpu(), want, 1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced {XLSTM_ARCH} train step: gradient of {name} is "
                 f"zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced {XLSTM_ARCH} train step grad {name}, "
                          f"card vs cpu", g.cpu(), w, 1e-4, 1e-2 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {XLSTM_ARCH} fp32 (remat on) S="
          f"{XLSTM_TRAIN_SEQ}: loss {float(loss)!r} on the card, "
          f"{float(want)!r} on the cpu; launches rmsnorm {launched[0]}, "
          f"rmsnorm.gated {launched[1]}; every one of "
          f"{len(list(leaves(grads)))} gradient leaves finite, nonzero and "
          f"within rtol 1e-4 / atol 1e-2 of its scale (worst {worst:.3g} of "
          f"scale): ok")
    del grads, want_g
    print(f"xlstm: the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def moe_phase() -> dict[str, int]:
    """Phase 3g: the moe family at full qwen3-moe-30b-a3b width (48 layers
    of attention and 128 routed experts of d_ff 768, top-8, capacity factor
    1.25, skewed expert placement; B9 behind the attention and the experts
    of every layer): the whole model initialised on the card, a prefill
    forward at full depth, continuous-batching serving of the first
    ``MOE_SERVE_LAYERS`` layers (views of the same stacked tensors) paged
    and dense, isolated re-runs where nothing drops, one profiled decode
    tick beside the expert products' byte bound, and the reduced MoE's
    train step on the card against the CPU.  The rmsnorm counter is zeroed
    just before a run and read just after; returns the launches of each
    kernel over the phase."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.xent import kernel as xent_kernel
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, moe
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.parallel import steps
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counts = {"rmsnorm": 0, "xent": 0}

    def zero():
        rms_kernel.LAUNCHES["plain"] = 0

    def read():
        counts["rmsnorm"] += rms_kernel.LAUNCHES["plain"]
        return rms_kernel.LAUNCHES["plain"]

    full = get_config(MOE_ARCH)
    model = build_model(full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = [t for _, t in leaves(params) if t.is_floating_point()]
    n_params = sum(t.numel() for t in weights)
    n_bytes = sum(t.numel() * t.element_size() for t in weights)
    print(f"init: {MOE_ARCH} bf16 full width, {full.n_layers} layers, "
          f"{n_params} parameters, {n_bytes} B of weights, in {init_s:.1f} "
          f"s; peak {torch.cuda.max_memory_allocated()} B "
          f"(torch.cuda.max_memory_allocated) of "
          f"{torch.cuda.get_device_properties(0).total_memory} B")
    if n_params != MOE_PARAMS:
        fail(f"init {MOE_ARCH}: {n_params} parameters, want {MOE_PARAMS}")

    # the prefill forward at full depth: B9 is ln1 and ln2 of every layer
    # and the final norm (the qk-norm is plain torch)
    full_step = 2 * full.n_layers + 1
    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, full.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(2):
        zero()
        with torch.inference_mode():
            start.record()
            logits = prefill(params, {"tokens": tokens})
            end.record()
        end.synchronize()
        launched = read()
        times.append(start.elapsed_time(end))
        if tuple(logits.shape) != (PREFILL_B, full.vocab_size):
            fail(f"prefill {MOE_ARCH}: logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"prefill {MOE_ARCH}: non-finite logits")
        if launched != full_step:
            fail(f"prefill {MOE_ARCH}: {launched} rmsnorm launches, want "
                 f"{full_step}")
    print(f"prefill: {MOE_ARCH} bf16 full depth B={PREFILL_B} S={PREFILL_S} "
          f"(capacity {moe.capacity(full, PREFILL_B * PREFILL_S)} a expert; "
          f"rmsnorm on {PREFILL_B * PREFILL_S} x {full.d_model} rows): first "
          f"{times[0]:.3f} ms, second {times[1]:.3f} ms, logits finite, "
          f"rmsnorm launches {launched} a forward; peak "
          f"{torch.cuda.max_memory_allocated()} B")
    del logits

    # serving: the first MOE_SERVE_LAYERS layers, views of the stacked
    # tensors of the full model
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    served = dict(params)
    served["s00_moe"] = map_leaves(lambda a: a[:MOE_SERVE_LAYERS],
                                   params["s00_moe"])
    smodel = build_model(cfg)
    per_step = 2 * cfg.n_layers + 1
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)

    def serve(m, kv, subset):
        batcher = ContinuousBatcher(m, served, slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, kv_cache=kv,
                                    prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                           for r in subset])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read()
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {MOE_ARCH} {kv}: request {r.rid} did not "
                     f"complete")
        if launched < per_step * batcher.micro_steps:
            fail(f"serve {MOE_ARCH} {kv}: {launched} rmsnorm launches for "
                 f"{batcher.micro_steps} decode steps (< {per_step} a step)")
        return batcher, out, secs, launched

    runs, batcher = {}, None
    for kv in ("paged", "dense"):
        b, out, secs, launched = serve(smodel, kv, reqs)
        tokens_out = sum(len(v) for v in out.values())
        ms = secs / b.micro_steps * 1e3
        runs[kv] = (out, tokens_out / secs, ms)
        if kv == "paged":
            batcher = b
        page = b.geometry.page_len if b.geometry else None
        print(f"serve: {MOE_ARCH} bf16 {cfg.n_layers} of {full.n_layers} "
              f"layers {kv}, capacity factor {cfg.capacity_factor} "
              f"(capacity {moe.capacity(cfg, b.padded_slots)} a expert for "
              f"{b.padded_slots} rows): {len(out)} requests, {tokens_out} "
              f"generated tokens in {secs:.3f} s, {tokens_out / secs:.2f} "
              f"tokens/s, {b.ticks} ticks, {b.micro_steps} decode steps "
              f"({ms:.2f} ms a step), {len(b.preemption_log)} preemptions, "
              f"page {page}, rmsnorm launches {launched} "
              f"({launched / b.micro_steps:.1f} a step)")
        del b
    if runs["paged"][0] != runs["dense"][0]:
        bad = [r.rid for r in reqs
               if runs["paged"][0][r.rid] != runs["dense"][0][r.rid]]
        fail(f"serve {MOE_ARCH}: paged tokens differ from dense for "
             f"requests {bad}")
    print(f"serve: {MOE_ARCH}: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests at capacity factor "
          f"{cfg.capacity_factor}")

    # one decode tick (all slots stepping): its B9 launches, where its
    # device time goes, and the expert products' share of it
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(served, batcher.cache, feed)

    tick()
    torch.cuda.synchronize()
    zero()
    tick()
    torch.cuda.synchronize()
    launched = read()
    if launched < per_step:
        fail(f"decode step {MOE_ARCH}: {launched} rmsnorm launches "
             f"(< {per_step})")
    print(f"serve: {MOE_ARCH}: one decode step launches rmsnorm {launched} "
          f"times (gate >= {per_step})")
    wall, busy = device_profile(
        f"decode tick {MOE_ARCH} ({cfg.n_layers} layers) {SERVE_SLOTS} "
        f"slots paged max_len {SERVE_MAX_LEN}", tick, top=8)
    # the three expert products of a decode step over every served layer,
    # as models.moe.apply_moe runs them on an (E, cap, d) buffer
    cap = moe.capacity(cfg, batcher.padded_slots)
    stage = served["s00_moe"]["moe"]
    eb = torch.randn((cfg.n_experts, cap, cfg.d_model), generator=gen,
                     device="cuda").to(cfg.adtype)

    def expert_products():
        with torch.inference_mode():
            for wi, wg, wo in zip(stage["wi"], stage["wg"], stage["wo"]):
                h = torch.bmm(eb, wi)
                torch.bmm(torch.nn.functional.silu(torch.bmm(eb, wg)) * h, wo)

    expert_bytes = sum(stage[w].numel() * stage[w].element_size()
                       for w in ("wi", "wg", "wo"))
    expert_ms = time_ms(expert_products, samples=5, per_sample=2)
    bw = datasheet(torch.cuda.get_device_name(0))[0]
    bound_ms = expert_bytes / bw * 1e3
    print(f"profile: {MOE_ARCH} expert products of a decode step (3 bmm "
          f"over ({cfg.n_experts}, {cap}, {cfg.d_model}) x {cfg.n_layers} "
          f"layers, {expert_bytes} B of weights): {expert_ms:.3f} ms "
          f"against a byte bound of {bound_ms:.3f} ms ({bound_ms / expert_ms:.1%}"
          f" of it; {full.n_layers} layers: {expert_ms * full.n_layers / cfg.n_layers:.3f}"
          f" ms against {bound_ms * full.n_layers / cfg.n_layers:.3f}); "
          f"{expert_ms / busy:.1%} of the tick's device time and "
          f"{expert_ms / wall:.1%} of its {wall:.3f} ms")
    print(f"serve: {MOE_ARCH} summary: paged {runs['paged'][1]:.2f} "
          f"tokens/s, {runs['paged'][2]:.2f} ms a decode step; dense "
          f"{runs['dense'][1]:.2f} tokens/s, {runs['dense'][2]:.2f} ms a "
          f"decode step; the card busy {busy / wall:.1%} of a profiled "
          f"decode tick ({busy:.3f} of {wall:.3f} ms), the expert products "
          f"{expert_ms / wall:.1%} of it")
    del batcher, runs, eb
    torch.cuda.empty_cache()

    # isolated re-runs where the reference's semantics make them hold: at
    # a capacity factor >= E / k the capacity is >= T and nothing drops
    nodrop = build_model(dataclasses.replace(cfg,
                                             capacity_factor=MOE_NO_DROP_CF))
    subset = reqs[:MOE_ISOLATED]
    _, batched, _, _ = serve(nodrop, "paged", subset)
    for r in subset:
        _, alone, _, _ = serve(nodrop, "paged", [r])
        if alone[r.rid] != batched[r.rid]:
            fail(f"serve {MOE_ARCH} capacity factor {MOE_NO_DROP_CF}: "
                 f"request {r.rid} alone gave other tokens than batched")
    print(f"serve: {MOE_ARCH}: at capacity factor {MOE_NO_DROP_CF} (nothing "
          f"drops), requests {[r.rid for r in subset]} each re-run alone in "
          f"the same slot geometry give their batched tokens")
    del model, smodel, nodrop, params, served, stage
    torch.cuda.empty_cache()

    # the reduced fp32 MoE with real routing (top-2 of 8) at a capacity
    # factor where assignments drop: the card (B9, B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights and perm tables on both; the loss rtol 1e-5, each
    # gradient leaf within 1e-4 of its scale; a pick that flips between
    # the two (a near-tie in the router) is reported by layer and token
    small = build_model(dataclasses.replace(
        reduce_for_smoke(full), top_k=2, capacity_factor=MOE_TRAIN_CF,
        remat=True))
    tree = numpy_params(small.param_defs(), SEED, true_fan_in=True,
                        cfg=small.cfg)
    data = DataConfig(vocab_size=small.cfg.vocab_size, seq_len=MOE_TRAIN_SEQ,
                      global_batch=4)
    routes = {"cuda": [], "cpu": []}
    route = moe.route

    def spy(p, xf, c):
        out = route(p, xf, c)
        routes[xf.device.type].append((out[1].cpu(), out[5].cpu()))
        return out

    moe.route = spy
    try:
        zero()
        before = xent_kernel.LAUNCHES["xent"]
        loss, grads = steps.value_and_grad(
            small, interop.params_from_jax(tree, small.cfg),
            make_batch(data, 0))
        launched = read()
        counts["xent"] += xent_kernel.LAUNCHES["xent"] - before
        want, want_g = steps.value_and_grad(
            small, interop.params_from_jax(tree, small.cfg, device="cpu"),
            make_batch(data, 0, device="cpu"))
    finally:
        moe.route = route
    if len(routes["cuda"]) != len(routes["cpu"]):
        fail(f"reduced {MOE_ARCH} train step: {len(routes['cuda'])} MoE "
             f"calls on the card, {len(routes['cpu'])} on the cpu")
    dropped = 0
    for i, ((e_card, k_card), (e_cpu, k_cpu)) in enumerate(
            zip(routes["cuda"], routes["cpu"])):
        flips = (e_card.sort(-1).values != e_cpu.sort(-1).values).any(-1)
        if bool(flips.any()):
            t = int(flips.nonzero()[0])
            fail(f"reduced {MOE_ARCH} train step: MoE call {i} (layer "
                 f"{i % small.cfg.n_layers}), token {t}: experts "
                 f"{e_card[t].tolist()} on the card, {e_cpu[t].tolist()} on "
                 f"the cpu (a near-tie in the router)")
        if not torch.equal(k_card, k_cpu):
            fail(f"reduced {MOE_ARCH} train step: MoE call {i}: the kept "
                 f"masks differ between the card and the cpu")
        dropped += int((~k_card).sum())
    if launched < 2 * small.cfg.n_layers + 1:
        fail(f"reduced {MOE_ARCH} train step: {launched} rmsnorm launches")
    if not dropped:
        fail(f"reduced {MOE_ARCH} train step: capacity factor "
             f"{MOE_TRAIN_CF} dropped nothing")
    check_close(f"reduced {MOE_ARCH} train step loss, card vs cpu",
                loss.cpu(), want, 1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        if g is None:           # the perm tables
            continue
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced {MOE_ARCH} train step: gradient of {name} is zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced {MOE_ARCH} train step grad {name}, card "
                          f"vs cpu", g.cpu(), w, 0.0, 1e-4 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {MOE_ARCH} fp32 top-{small.cfg.top_k} of "
          f"{small.cfg.n_experts}, capacity factor {MOE_TRAIN_CF} (remat on) "
          f"S={MOE_TRAIN_SEQ}: loss {float(loss)!r} on the card, "
          f"{float(want)!r} on the cpu; {len(routes['cuda'])} MoE calls with "
          f"the same picks and kept masks on both, {dropped} assignments "
          f"dropped; rmsnorm launches {launched}; every gradient leaf finite, "
          f"nonzero and within 1e-4 of its scale (worst {worst:.3g} of "
          f"scale): ok")
    del grads, want_g
    print(f"moe: the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def multimodal_phase() -> tuple[dict[str, int], list[dict]]:
    """Phase 3h: the vlm family at full pixtral-12b width and the encdec
    family at full whisper-tiny width.  pixtral-12b: the whole model
    initialised on the card, a prefill forward at full depth behind its
    1,024-token image prefix, continuous-batching serving of text through
    its first ``VLM_SERVE_LAYERS`` layers (views of the same stacked
    tensors) paged and dense, one profiled decode tick.  whisper-tiny: its
    fp32 forward on the card against the CPU and its decode against its
    forward, a static batch served through ``launch.serve``'s encdec path
    twice, training through ``Trainer`` (B11 a step, reading the loss's
    logits in place).  Then the reduced vlm and encdec train steps on the
    card against the CPU.  Each counter is zeroed just before a run and read
    just after; returns the launches of each kernel over the phase and
    whisper-tiny's training metrics."""
    import dataclasses
    import gc
    import shutil

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.xent import kernel as xent_kernel
    from repro_torch.launch.serve import (make_requests, serve_static,
                                          static_inputs)
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params, leaves, map_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import make_schedule
    from repro_torch.parallel import steps
    from repro_torch.parallel.steps import make_decode_step
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serving import ContinuousBatcher, Request

    # nothing of an earlier phase stays on the card
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counts = {"rmsnorm": 0, "xent": 0}

    def zero():
        rms_kernel.LAUNCHES["plain"] = 0
        xent_kernel.LAUNCHES["xent"] = 0

    def read():
        counts["rmsnorm"] += rms_kernel.LAUNCHES["plain"]
        counts["xent"] += xent_kernel.LAUNCHES["xent"]
        return rms_kernel.LAUNCHES["plain"], xent_kernel.LAUNCHES["xent"]

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    # ---- pixtral-12b: the whole model, bf16 ----------------------------
    full = get_config(VLM_ARCH)
    model = build_model(full)
    held = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = [t for _, t in leaves(params)]
    n_params = sum(t.numel() for t in weights)
    n_bytes = sum(t.numel() * t.element_size() for t in weights)
    n_defs = sum(math.prod(d.shape) for _, d in leaves(model.param_defs()))
    print(f"init: {VLM_ARCH} bf16 full width, {full.n_layers} layers, "
          f"{n_params} parameters ({n_defs} in its param_defs), {n_bytes} B "
          f"of weights, in {init_s:.1f} s; {held} B allocated before the "
          f"init; peak {torch.cuda.max_memory_allocated()} B "
          f"(torch.cuda.max_memory_allocated) of "
          f"{torch.cuda.get_device_properties(0).total_memory} B")
    if not n_params == n_defs == VLM_PARAMS:
        fail(f"init {VLM_ARCH}: {n_params} parameters, {n_defs} in its "
             f"param_defs, want {VLM_PARAMS}")

    # the prefill forward at full depth behind the image prefix: B9 is ln1
    # and ln2 of every layer and the final norm
    full_step = 2 * full.n_layers + 1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, full.vocab_size, (PREFILL_B, VLM_PREFILL_S),
                           generator=gen, device="cuda")
    img = torch.randn((PREFILL_B, full.n_img_tokens, full.d_model),
                      generator=gen, device="cuda")
    want_shape = (PREFILL_B, VLM_PREFILL_S, full.vocab_size)
    times = []
    for _ in range(2):
        zero()
        with torch.inference_mode():
            start.record()
            logits, _ = model(params, tokens, img)
            end.record()
        end.synchronize()
        launched, _ = read()
        times.append(start.elapsed_time(end))
        if tuple(logits.shape) != want_shape:
            fail(f"prefill {VLM_ARCH}: logits shape {tuple(logits.shape)}, "
                 f"want {want_shape}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"prefill {VLM_ARCH}: non-finite logits")
        if launched != full_step:
            fail(f"prefill {VLM_ARCH}: {launched} rmsnorm launches, want "
                 f"{full_step}")
        del logits
    rows = PREFILL_B * (full.n_img_tokens + VLM_PREFILL_S)
    print(f"prefill: {VLM_ARCH} bf16 full depth B={PREFILL_B}, "
          f"{full.n_img_tokens} image + {VLM_PREFILL_S} text positions "
          f"(rmsnorm on {rows} x {full.d_model} rows): first "
          f"{times[0]:.3f} ms, second {times[1]:.3f} ms, logits "
          f"{want_shape} finite, rmsnorm launches {launched} a forward; "
          f"peak {torch.cuda.max_memory_allocated()} B")
    del tokens, img

    # serving text: the first VLM_SERVE_LAYERS layers, views of the stacked
    # tensors of the full model
    cfg = dataclasses.replace(full, n_layers=VLM_SERVE_LAYERS)
    served = dict(params)
    served["s00_dense"] = map_leaves(lambda a: a[:VLM_SERVE_LAYERS],
                                     params["s00_dense"])
    smodel = build_model(cfg)
    per_step = 2 * cfg.n_layers + 1
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)
    runs, batcher = {}, None
    for kv in ("paged", "dense"):
        b = ContinuousBatcher(smodel, served, slots=SERVE_SLOTS,
                              max_len=SERVE_MAX_LEN, kv_cache=kv,
                              prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        out = b.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                     for r in reqs])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched, _ = read()
        for r in reqs:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {VLM_ARCH} {kv}: request {r.rid} did not "
                     f"complete")
        if launched < per_step * b.micro_steps:
            fail(f"serve {VLM_ARCH} {kv}: {launched} rmsnorm launches for "
                 f"{b.micro_steps} decode steps (< {per_step} a step)")
        tokens_out = sum(len(v) for v in out.values())
        ms = secs / b.micro_steps * 1e3
        runs[kv] = (out, tokens_out / secs, ms)
        page = b.geometry.page_len if b.geometry else None
        print(f"serve: {VLM_ARCH} bf16 {cfg.n_layers} of {full.n_layers} "
              f"layers {kv}: {len(out)} requests, {tokens_out} generated "
              f"tokens in {secs:.3f} s, {tokens_out / secs:.2f} tokens/s, "
              f"{b.ticks} ticks, {b.micro_steps} decode steps ({ms:.2f} ms "
              f"a step), {len(b.preemption_log)} preemptions, page {page}, "
              f"rmsnorm launches {launched} "
              f"({launched / b.micro_steps:.1f} a step)")
        if kv == "paged":
            batcher = b
        del b
    if runs["paged"][0] != runs["dense"][0]:
        bad = [r.rid for r in reqs
               if runs["paged"][0][r.rid] != runs["dense"][0][r.rid]]
        fail(f"serve {VLM_ARCH}: paged tokens differ from dense for "
             f"requests {bad}")
    print(f"serve: {VLM_ARCH}: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests")
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(served, batcher.cache, feed)

    tick()
    torch.cuda.synchronize()
    zero()
    tick()
    torch.cuda.synchronize()
    launched, _ = read()
    if launched < per_step:
        fail(f"decode step {VLM_ARCH}: {launched} rmsnorm launches "
             f"(< {per_step})")
    wall, busy = device_profile(
        f"decode tick {VLM_ARCH} ({cfg.n_layers} layers) {SERVE_SLOTS} slots "
        f"paged max_len {SERVE_MAX_LEN}", tick, top=8)
    print(f"serve: {VLM_ARCH} summary: paged {runs['paged'][1]:.2f} "
          f"tokens/s, {runs['paged'][2]:.2f} ms a decode step; dense "
          f"{runs['dense'][1]:.2f} tokens/s, {runs['dense'][2]:.2f} ms a "
          f"decode step; one decode step launches rmsnorm {launched} times "
          f"(gate >= {per_step}); the card busy {busy / wall:.1%} of a "
          f"profiled decode tick ({busy:.3f} of {wall:.3f} ms)")
    del batcher, runs, feed, tick, model, smodel, params, served
    gc.collect()
    torch.cuda.empty_cache()

    # ---- whisper-tiny ---------------------------------------------------
    wfull = get_config(ENCDEC_ARCH)
    frames_np, prompts_np = static_inputs(wfull, ENCDEC_ROWS, ENCDEC_PROMPT,
                                          SEED)
    # the fp32 model: the card's forward against the CPU's (TF32 off), and
    # the card's decode against its own forward (the reference's 2e-3)
    m32 = build_model(dataclasses.replace(wfull, dtype="float32"))
    cpu_params = m32.init(SEED, device="cpu")
    card_params = map_leaves(lambda t: t.cuda(), cpu_params)
    fr = torch.from_numpy(frames_np[:2])
    toks = torch.from_numpy(prompts_np[:2, :ENCDEC_CHECK])
    with torch.inference_mode():
        want, _ = m32(cpu_params, toks, fr)
        got, _ = m32(card_params, toks.cuda(), fr.cuda())
        fwd_err = check_close(f"{ENCDEC_ARCH} fp32 forward, card vs cpu",
                              got.cpu(), want, 1e-4, 1e-4)
        cache = init_params(0, m32.cache_defs(2, ENCDEC_CHECK),
                            device="cuda")
        cache["cross_k"], cache["cross_v"] = m32.prefill_cross(card_params,
                                                               fr.cuda())
        outs = []
        for t in range(ENCDEC_CHECK):
            lg, cache = m32.decode_step(card_params, cache,
                                        toks[:, t:t + 1].cuda())
            outs.append(lg)
        dec_err = float((torch.cat(outs, 1) - got).abs().max())
    if not dec_err < 2e-3:
        fail(f"{ENCDEC_ARCH} fp32 decode vs forward on the card: max abs "
             f"err {dec_err} (reference tolerance 2e-3)")
    print(f"check: {ENCDEC_ARCH} fp32 full width, {wfull.n_frames} frames, "
          f"{ENCDEC_CHECK} tokens: the card's forward against the cpu's max "
          f"abs err {fwd_err:.3g} (rtol 1e-4 atol 1e-4); the card's decode "
          f"steps against its forward {dec_err:.3g} (< 2e-3): ok")
    del m32, cpu_params, card_params, cache, outs, got, want

    # the bf16 model served as launch.serve serves it: a static batch,
    # twice; its decode against its forward within a bf16 bound
    wmodel = build_model(wfull)
    wparams = wmodel.init(SEED)
    frames = torch.from_numpy(frames_np).cuda()
    prompts = torch.from_numpy(prompts_np).cuda()
    served_out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_static(wmodel, wparams, frames, prompts, ENCDEC_GEN)
        torch.cuda.synchronize()
        served_out.append((out, time.perf_counter() - t0))
    if not torch.equal(served_out[0][0], served_out[1][0]):
        fail(f"serve {ENCDEC_ARCH}: a second run gave other tokens")
    if tuple(served_out[0][0].shape) != (ENCDEC_ROWS, ENCDEC_GEN):
        fail(f"serve {ENCDEC_ARCH}: tokens of shape "
             f"{tuple(served_out[0][0].shape)}")
    with torch.inference_mode():
        start.record()
        ck, cv = wmodel.prefill_cross(wparams, frames)
        end.record()
        end.synchronize()
        enc_ms = start.elapsed_time(end)
        cache = init_params(0, wmodel.cache_defs(
            ENCDEC_ROWS, ENCDEC_PROMPT + ENCDEC_GEN), device="cuda")
        cache["cross_k"], cache["cross_v"] = ck, cv
        decode = make_decode_step(wmodel)
        fwd, _ = wmodel(wparams, prompts[:, :ENCDEC_CHECK], frames)
        outs = []
        for t in range(ENCDEC_CHECK):
            lg, cache = wmodel.decode_step(wparams, cache,
                                           prompts[:, t:t + 1])
            outs.append(lg)
        bf16_err = float((torch.cat(outs, 1) - fwd).abs().max())
        top = float(fwd.abs().max())
    # the logits are a bf16 product cast to fp32, so the two paths differ by
    # whole bf16 ulps of the largest logit (8 bits of mantissa: 2^(e-7) at
    # 2^e <= |x| < 2^(e+1)); a few roundings of the residual stream a layer
    # make a few ulps, a fault in the cross attention or the cache O(1)
    bf16_bound = 8 * 2.0 ** (math.floor(math.log2(top)) - 7)
    if not bf16_err <= bf16_bound:
        fail(f"serve {ENCDEC_ARCH}: bf16 decode vs forward max abs err "
             f"{bf16_err:.3g} above {bf16_bound:.3g} (8 bf16 ulps of the "
             f"largest logit {top:.4g})")
    n_steps = ENCDEC_PROMPT + ENCDEC_GEN - 1
    secs = served_out[1][1]
    n_tok = ENCDEC_ROWS * ENCDEC_GEN
    print(f"serve: {ENCDEC_ARCH} bf16 full width, static batch of "
          f"{ENCDEC_ROWS} rows, {wfull.n_frames} frames, {ENCDEC_PROMPT} "
          f"prompt + {ENCDEC_GEN} new tokens a row: {n_tok} generated tokens "
          f"in {secs:.3f} s (first run {served_out[0][1]:.3f} s), "
          f"{n_tok / secs:.2f} tokens/s, {n_steps} decode steps "
          f"({secs / n_steps * 1e3:.2f} ms a step, the encoder pass "
          f"{enc_ms:.3f} ms included); the same tokens on both runs; bf16 "
          f"decode vs forward over {ENCDEC_CHECK} positions max abs err "
          f"{bf16_err:.3g} (<= {bf16_bound:.3g}, 8 bf16 ulps of the largest "
          f"logit {top:.4g})")

    def tick():
        with torch.inference_mode():
            decode(wparams, cache, prompts[:, :1])

    wall, busy = device_profile(f"decode tick {ENCDEC_ARCH} {ENCDEC_ROWS} "
                                f"rows", tick, top=8)
    print(f"serve: {ENCDEC_ARCH} summary: {n_tok / secs:.2f} tokens/s, "
          f"{secs / n_steps * 1e3:.2f} ms a decode step; the card busy "
          f"{busy / wall:.1%} of a profiled decode tick ({busy:.3f} of "
          f"{wall:.3f} ms)")
    del cache, ck, cv, fwd, outs, served_out, frames, prompts, tick, decode

    # training at full width: bf16 with an fp32 master, remat; B11 once a
    # step over the (tokens, vocab) logits, read where they lie
    shutil.rmtree(MULTIMODAL_DIR, ignore_errors=True)
    data = DataConfig(vocab_size=wfull.vocab_size, seq_len=ENCDEC_TRAIN_SEQ,
                      global_batch=ENCDEC_TRAIN_BATCH,
                      n_frames=wfull.n_frames, d_model=wfull.d_model)
    n_rows = ENCDEC_TRAIN_SEQ * ENCDEC_TRAIN_BATCH
    held_out = make_batch(data, ENCDEC_TRAIN_STEPS)
    with torch.no_grad():
        before = float(wmodel.loss(wparams, held_out))
    del wparams
    run = Trainer(
        wmodel, data, AdamWConfig(),
        make_schedule(get_schedule(ENCDEC_ARCH), peak=TRAIN_PEAK,
                      warmup=TRAIN_WARMUP, total=ENCDEC_TRAIN_STEPS),
        TrainerConfig(n_steps=ENCDEC_TRAIN_STEPS,
                      ckpt_every=ENCDEC_TRAIN_STEPS,
                      ckpt_dir=str(MULTIMODAL_DIR), keep=1, log_every=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    metrics = whisper_metrics = run.train(SEED)
    rms, xent = read()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(ENCDEC_TRAIN_STEPS)):
        fail(f"train {ENCDEC_ARCH}: steps run {[m['step'] for m in metrics]}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"train {ENCDEC_ARCH}: non-finite loss in {losses}")
    if xent != ENCDEC_TRAIN_STEPS:
        fail(f"train {ENCDEC_ARCH}: {xent} xent launches for "
             f"{ENCDEC_TRAIN_STEPS} steps (want one a step)")
    with torch.no_grad():
        after = float(wmodel.loss(run.state["params"], held_out))
    if not after < before:
        fail(f"train {ENCDEC_ARCH}: the loss of held-out batch "
             f"{ENCDEC_TRAIN_STEPS} is {after!r} after training, not below "
             f"{before!r} at the initial weights")
    step_ms = statistics.median(m["step_s"] for m in metrics[1:]) * 1e3
    print(f"train: {ENCDEC_ARCH} bf16 + fp32 master, remat, batch "
          f"{ENCDEC_TRAIN_BATCH} x seq {ENCDEC_TRAIN_SEQ} ({n_rows} tokens) "
          f"against {wfull.n_frames} frames a row: losses {losses}; "
          f"held-out batch {ENCDEC_TRAIN_STEPS}: loss {before!r} at the "
          f"initial weights, {after!r} after training; {step_ms:.1f} ms a "
          f"step (median of steps 1-{ENCDEC_TRAIN_STEPS - 1}), "
          f"{n_rows / step_ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; xent launches {xent} "
          f"({xent // ENCDEC_TRAIN_STEPS} a step) on ({n_rows}, "
          f"{wfull.vocab_size}) fp32 logits, rmsnorm {rms}")
    state = run.state
    batch = make_batch(data, ENCDEC_TRAIN_STEPS)
    # B11 reads the loss's own logits: in the profile's warm-up step and
    # its profiled one, the pointer xent_launch gets is the data_ptr of the
    # logits the model hands the loss, once a step; and a step pads no
    # tensor of the vocab's width
    with xent_pointers() as (handed, received):
        device_profile(f"train step {ENCDEC_ARCH} {n_rows} tokens",
                       lambda: run.step_fn(state, batch), top=8)
    if len(received) != 2 or received != handed:
        fail(f"train {ENCDEC_ARCH}: over two steps xent_launch got logits "
             f"pointers {[hex(p) for p in received]}, the loss was handed "
             f"{[hex(p) for p in handed]} (want the same one, once a step)")
    pads = pad_inputs(lambda: run.step_fn(state, batch))
    vocab_pads = [p for p in pads if p[-1:] == [wfull.vocab_size]]
    if vocab_pads:
        fail(f"train {ENCDEC_ARCH}: the step pads tensors of the vocab's "
             f"width {vocab_pads}")
    print(f"train: {ENCDEC_ARCH} B11 reads the loss's logits in place: "
          f"xent_launch got {[hex(p) for p in received]} over two steps, "
          f"the data_ptr of the ({n_rows}, {wfull.vocab_size}) logits the "
          f"loss was handed each step; a step runs {len(pads)} pads (input "
          f"shapes {sorted(set(map(tuple, pads)))}), none of the vocab's "
          f"width: ok")
    run.ckpt.wait()
    del run, state, batch, held_out, wmodel
    shutil.rmtree(MULTIMODAL_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the reduced fp32 vlm and encdec train steps: the card (B9 and B11
    # under their autograd Functions, remat on) against the CPU (their
    # plain versions), the same numpy weights; the loss rtol 1e-5, each
    # gradient leaf within 1e-4 of its scale, every leaf nonzero
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        small = build_model(dataclasses.replace(
            reduce_for_smoke(get_config(arch)), remat=True))
        c = small.cfg
        tree = numpy_params(small.param_defs(), SEED, true_fan_in=True)
        data = DataConfig(vocab_size=c.vocab_size, seq_len=64, global_batch=4,
                          n_img_tokens=c.n_img_tokens,
                          n_frames=c.n_frames if c.family == "encdec" else 0,
                          d_model=c.d_model)
        zero()
        loss, grads = steps.value_and_grad(
            small, interop.params_from_jax(tree, c), make_batch(data, 0))
        rms, xent = read()
        want, want_g = steps.value_and_grad(
            small, interop.params_from_jax(tree, c, device="cpu"),
            make_batch(data, 0, device="cpu"))
        need = 2 * c.n_layers + 1 if c.family == "vlm" else 0
        if rms < need or xent != 1:
            fail(f"reduced {arch} train step: {rms} rmsnorm (want >= {need}) "
                 f"and {xent} xent launches (want 1)")
        check_close(f"reduced {arch} train step loss, card vs cpu",
                    loss.cpu(), want, 1e-5, 0.0)
        worst = 0.0
        for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
            name = "/".join(path)
            if not bool(g.abs().max() > 0):
                fail(f"reduced {arch} train step: gradient of {name} is zero")
            scale = float(w.abs().max())
            err = check_close(f"reduced {arch} train step grad {name}, card "
                              f"vs cpu", g.cpu(), w, 0.0, 1e-4 * scale)
            worst = max(worst, err / scale)
        extra = (f"{c.n_img_tokens} image embeddings" if c.family == "vlm"
                 else f"{c.n_enc_layers} encoder layers, {c.n_frames} frames")
        print(f"train: reduced {arch} fp32 (remat on, {extra}) S=64: loss "
              f"{float(loss)!r} on the card, {float(want)!r} on the cpu; "
              f"rmsnorm launches {rms}, xent {xent}; every one of "
              f"{len(list(leaves(grads)))} gradient leaves nonzero and within "
              f"1e-4 of its scale (worst {worst:.3g} of scale): ok")
        del grads, want_g
    print(f"multimodal: the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts, whisper_metrics


def check_train_stream(records, metrics, checkpoints) -> None:
    """Phase 3c's gates on its two ``Trainer`` runs' obs stream: one
    ``train_step`` record a step, its loss and gradient norm equal bit for
    bit to ``Trainer.metrics``, and the ``checkpoint`` records exactly
    ``checkpoints`` ((step, action) in order: the first run's saves, the
    round trip's restore, its saves); prints the ``obs:`` line."""
    steps = [(r["step"], r["loss"], r["grad_norm"]) for r in records
             if r["kind"] == "train_step"]
    want = [(m["step"], m["loss"], m["grad_norm"]) for m in metrics]
    if steps != want:
        fail(f"obs: train: train_step records {steps} != Trainer.metrics "
             f"{want}")
    got = [(r["step"], r["action"]) for r in records
           if r["kind"] == "checkpoint"]
    if got != checkpoints:
        fail(f"obs: train: checkpoint records {got} != the saves and the "
             f"restore {checkpoints}")
    print(f"obs: phase 3c train stream: {len(records)} records "
          f"{kind_counts(records)}; {len(steps)} train_step records equal "
          f"to Trainer.metrics bit for bit (loss, grad_norm); checkpoint "
          f"records {got}: ok")


def training_phase() -> tuple[dict[str, int], list[float]]:
    """Phase 3c: training at full Qwen2-0.5B width, with a checkpoint round
    trip.  Each kernel counter is zeroed just before a training run and
    read just after; returns the launches of each kernel over the runs and
    the uninterrupted run's losses."""
    import dataclasses
    import os
    import shutil

    import torch

    from repro_torch import interop, obs
    from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
    from repro_torch.interop import numpy_params
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.xent import kernel as xent_kernel
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.adamw import global_norm as adamw_global_norm
    from repro_torch.optim.schedules import make_schedule
    from repro_torch.parallel import steps
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)

    # the reduced fp32 model: the card (B9/B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights on both.  Loss rtol 1e-5; each gradient leaf rtol 1e-4
    # with an atol of 1e-2 of its scale: the reduced qwen2-0.5b amplifies
    # fp32 reordering (its CPU gradients lie 2.3e-3 of a leaf's scale from
    # a float64 run; the card's differed from the CPU's by 6.3e-3 on an
    # NVIDIA H100 80GB HBM3 at 700 W; tests/test_torch_train.py,
    # tests/test_torch_cuda.py).
    small = build_model(dataclasses.replace(reduce_for_smoke(cfg), remat=True))
    tree = numpy_params(small.param_defs(), SEED)
    data = DataConfig(vocab_size=small.cfg.vocab_size, seq_len=64,
                      global_batch=4)
    loss, grads = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg), make_batch(data, 0))
    want, want_g = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg, device="cpu"),
        make_batch(data, 0, device="cpu"))
    check_close("reduced train step loss, card vs cpu", loss.cpu(), want,
                1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced train step: gradient of {name} is zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced train step grad {name}, card vs cpu",
                          g.cpu(), w, 1e-4, 1e-2 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {TRAIN_ARCH} fp32 (remat on): loss "
          f"{float(loss)!r} on the card, {float(want)!r} on the cpu; every "
          f"one of {len(list(leaves(grads)))} gradient leaves nonzero and "
          f"within rtol 1e-4 / atol 1e-2 of its scale (worst {worst:.3g} "
          f"of scale): ok")
    del grads, want_g

    model = build_model(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    tokens = TRAIN_SEQ * TRAIN_BATCH

    def trainer(directory):
        return Trainer(
            model, data, AdamWConfig(),
            make_schedule(get_schedule(TRAIN_ARCH), peak=TRAIN_PEAK,
                          warmup=TRAIN_WARMUP, total=TRAIN_STEPS),
            TrainerConfig(n_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                          ckpt_dir=str(directory), keep=1, log_every=1))

    # the first backward at full width: every leaf finite, nonzero somewhere
    params = model.init(SEED)
    n_params = sum(t.numel() for _, t in leaves(params))
    _, grads = steps.value_and_grad(model, params, make_batch(data, 0))
    for path, g in leaves(grads):
        if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            fail(f"train: first backward: gradient of {'/'.join(path)} is "
                 f"not finite or is zero")
    print(f"train: {TRAIN_ARCH} bf16, {n_params} parameters: the first "
          f"backward gives every one of {len(list(leaves(grads)))} leaves a "
          f"finite gradient, nonzero somewhere: ok")
    # how far rounding alone moves the step-0 gradient at these weights:
    # the same batch as two microbatches (fp32 accumulation), the same
    # math in another order
    norm = float(adamw_global_norm(grads))
    del grads
    _, grads2, _ = steps.make_grad_fn(model, microbatches=2)(
        params, make_batch(data, 0))
    norm2 = float(adamw_global_norm(grads2))
    print(f"train: step-0 gradient norm {norm!r} in one batch, {norm2!r} "
          f"as two microbatches (relative {abs(norm2 - norm) / norm!r}): "
          f"the spread rounding alone gives the full-width backward")
    # a batch the run never trains on, to hold the trained weights to the
    # initial ones on the same tokens
    held_out = make_batch(data, TRAIN_STEPS)
    with torch.no_grad():
        before = float(model.loss(params, held_out))
    del params, grads2

    # the uninterrupted run; before step 4 its state (the one the step-4
    # checkpoint holds) is copied to the host, off the card's peak memory,
    # and the checkpoint linked aside for the replay (keep 1 deletes it at
    # step 8)
    run = trainer(TRAIN_DIR / "run")
    replay_dir = TRAIN_DIR / "replay"
    saved = {}

    def keep_step(step):
        if step != TRAIN_CKPT_EVERY:
            return
        saved["state"] = map_leaves(lambda t: t.to("cpu", copy=True),
                                    run.state)
        run.ckpt.wait()
        name = f"step_{step:08d}"
        (replay_dir / name).mkdir(parents=True)
        for f in os.listdir(TRAIN_DIR / "run" / name):
            os.link(TRAIN_DIR / "run" / name / f, replay_dir / name / f)

    # both runs stream to one obs file (checked after the round trip)
    stream = obs.JsonlSink(OBS_DIR / "train.jsonl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms_kernel.LAUNCHES["plain"] = 0
    xent_kernel.LAUNCHES["xent"] = 0
    with obs.session(stream):
        metrics = run.train(SEED, fail_injector=keep_step)
    launched = {"rmsnorm": rms_kernel.LAUNCHES["plain"],
                "xent": xent_kernel.LAUNCHES["xent"]}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(TRAIN_STEPS)):
        fail(f"train: steps run {[m['step'] for m in metrics]}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"train: non-finite loss in {losses}")
    with torch.no_grad():
        after = float(model.loss(run.state["params"], held_out))
    if not after < before:
        fail(f"train: the loss of held-out batch {TRAIN_STEPS} is {after!r} "
             f"after training, not below {before!r} at the initial weights")
    if launched["xent"] != TRAIN_STEPS:
        fail(f"train: {launched['xent']} xent launches for {TRAIN_STEPS} "
             f"steps (want one a step)")
    if launched["rmsnorm"] < (2 * cfg.n_layers + 1) * TRAIN_STEPS:
        fail(f"train: {launched['rmsnorm']} rmsnorm launches for "
             f"{TRAIN_STEPS} steps (< {2 * cfg.n_layers + 1} a step)")
    step_ms = statistics.median(m["step_s"] for m in metrics[1:]) * 1e3
    print(f"train: {TRAIN_ARCH} bf16 + fp32 master, remat, {tokens} tokens "
          f"a step (batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): losses "
          f"{losses}, gradient norms {[m['grad_norm'] for m in metrics]}; "
          f"held-out batch {TRAIN_STEPS}: loss {before!r} at the initial "
          f"weights, {after!r} after training")
    print(f"train: {step_ms:.1f} ms a step (median of steps 1-"
          f"{TRAIN_STEPS - 1}), {tokens / step_ms * 1e3:.0f} tokens/s, "
          f"steps {[round(m['step_s'] * 1e3, 1) for m in metrics]} ms, peak "
          f"memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated), launches {launched} "
          f"({launched['rmsnorm'] / TRAIN_STEPS:.0f} rmsnorm a step, remat "
          f"recompute included)")

    saves = [(s["step"], "save") for s in run.saves]
    # one step, profiled
    state = run.state
    batch = make_batch(data, TRAIN_STEPS)
    device_profile(f"train step {TRAIN_ARCH} {tokens} tokens",
                   lambda: run.step_fn(state, batch), top=8)
    del run, state, batch
    torch.cuda.empty_cache()

    # the round trip: a fresh Trainer restores step 4 and replays 4..7
    again = trainer(replay_dir)

    def compare_restored(step):
        if step != TRAIN_CKPT_EVERY:
            return
        for (path, got), (_, want) in zip(leaves(again.state),
                                          leaves(saved["state"])):
            if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
                fail(f"train: restored {'/'.join(path)} differs from the "
                     f"saved state")
        saved.clear()

    rms_kernel.LAUNCHES["plain"] = 0
    xent_kernel.LAUNCHES["xent"] = 0
    with obs.session(stream):
        replayed = again.train(SEED, fail_injector=compare_restored)
    stream.close()
    saves += [(TRAIN_CKPT_EVERY, "restore")] + [(s["step"], "save")
                                                for s in again.saves]
    check_train_stream(read_stream(OBS_DIR / "train.jsonl"),
                       metrics + replayed, saves)
    launched["rmsnorm"] += rms_kernel.LAUNCHES["plain"]
    launched["xent"] += xent_kernel.LAUNCHES["xent"]
    if saved:
        fail("train: the restored state was never compared")
    if [m["step"] for m in replayed] != list(range(TRAIN_CKPT_EVERY,
                                                   TRAIN_STEPS)):
        fail(f"train: replayed steps {[m['step'] for m in replayed]}")
    first = replayed[0]["loss"]
    if first != losses[TRAIN_CKPT_EVERY]:
        fail(f"train: replayed step {TRAIN_CKPT_EVERY} loss {first!r} != "
             f"{losses[TRAIN_CKPT_EVERY]!r}")
    diffs = []
    for m in replayed[1:]:
        want = losses[m["step"]]
        diffs.append(abs(m["loss"] - want) / abs(want))
        if diffs[-1] > REPLAY_RTOL:
            fail(f"train: replayed step {m['step']} loss {m['loss']!r} vs "
                 f"{want!r} beyond rtol {REPLAY_RTOL}")
    print(f"train: restored step {TRAIN_CKPT_EVERY} into a fresh Trainer: "
          f"the state equals the saved one bit for bit; replayed step "
          f"{TRAIN_CKPT_EVERY} loss {first!r} equals the uninterrupted "
          f"run's bit for bit; steps {TRAIN_CKPT_EVERY + 1}-"
          f"{TRAIN_STEPS - 1} relative differences {diffs} (rtol "
          f"{REPLAY_RTOL}): ok")
    del again
    shutil.rmtree(TRAIN_DIR)
    torch.cuda.empty_cache()
    return launched, metrics


def check_partials(what: str, got, want, dtype) -> float:
    """B12's (m, l, ll) against the plain version's: m and ll exact (a max
    and a single logit), l to rtol 1e-5 (fp32) or 2e-2 (bf16); returns the
    max abs error over the three."""
    import torch

    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    errs = [check_close(f"{what} m", got[0], want[0], 0.0, 0.0),
            check_close(f"{what} l", got[1], want[1], rtol, 0.0),
            check_close(f"{what} ll", got[2], want[2], 0.0, 0.0)]
    return max(errs)


def partial_kernel_checks() -> None:
    """B12 at the mesh's shard shapes against its plain version, and the
    shards' partials combined into each row's NLL against B11 on the whole
    row.  These launches compare; they are not the main path's."""
    import torch

    from repro_torch.kernels.xent import kernel as xent_kernel

    t, v = TRAIN_SEQ * TRAIN_BATCH, 151936
    gen = torch.Generator(device="cuda").manual_seed(21)
    whole = 3 * torch.randn((t, v), generator=gen, device="cuda")
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    want = xent_kernel.xent_nll(whole, labels, logical_v=v)
    for dtype in (torch.float32, torch.bfloat16):
        x = whole.to(dtype)
        for n in (2, 4):
            vl = v // n
            parts = []
            for k in range(n):
                shard = x[:, k * vl:(k + 1) * vl].contiguous()
                got = xent_kernel.xent_partials(shard, labels, vl=vl,
                                                off=k * vl, logical_v=v)
                check_partials(f"xent.partial M={n} shard {k} {dtype}", got,
                               xent_kernel.plain_partials(
                                   shard, labels, vl=vl, off=k * vl,
                                   logical_v=v), dtype)
                parts.append(got)
                del shard
            mg = torch.stack([p[0] for p in parts]).amax(0)
            lsum = sum(p[1] * torch.exp(p[0] - mg) for p in parts)
            nll = (torch.log(torch.clamp(lsum, min=1e-30)) + mg
                   - sum(p[2] for p in parts))
            ref = want if dtype == torch.float32 else xent_kernel.xent_nll(
                x, labels, logical_v=v)
            err = check_close(f"xent.partial M={n} {dtype} combined vs B11",
                              nll, ref, 1e-5, 0.0)
            print(f"check: xent.partial ({t}, {vl}) x {n} shards {dtype}: "
                  f"(m, ll) exact, l within rtol "
                  f"{1e-5 if dtype == torch.float32 else 2e-2}; combined "
                  f"NLL vs B11 on the whole row max abs err {err:.3g} (rtol "
                  f"1e-5): ok")
        del x
    del whole
    rt, width, vl, off, lv = XENT_PARTIAL_RAGGED
    x = (3 * torch.randn((rt, width), generator=gen, device="cuda")).to(
        torch.bfloat16)
    lab = torch.randint(0, lv, (rt,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lab[0] = off + vl           # the next shard's column, in local padding
    err = check_partials("xent.partial ragged bf16",
                         xent_kernel.xent_partials(x, lab, vl=vl, off=off,
                                                   logical_v=lv),
                         xent_kernel.plain_partials(x, lab, vl=vl, off=off,
                                                    logical_v=lv),
                         torch.bfloat16)
    print(f"check: xent.partial ragged {XENT_PARTIAL_RAGGED} bf16 (local "
          f"padding past vl, logical_v inside the shard, a label aliasing "
          f"the padding): max abs err {err:.3g}: ok")
    torch.cuda.empty_cache()


def mesh_backward_checks() -> None:
    """The vocab-parallel loss and backward on the card, over gloo with
    the collectives staged through pinned host buffers: ``api.launch
    ("xent")`` and ``xent_grad`` on a (2, 2) mesh at ``MESH_XENT``; the
    reduced fp32 model padded for the model axis (``MESH_CHECK_VOCAB``);
    and the other families' reduced fp32 models (``MESH_FAMILIES``), each
    under its launchers' rules (``rules.launcher_rules``: tensor-parallel
    over the model axis, the hybrid and ssm norms split; grok-1-314b's
    experts under ``expert_tp``); and the reduced qwen3-14b, qwen3-moe and
    grok-1-314b under FSDP's rules (``FSDP_CHECKS``, ``make_rules(fsdp=True,
    expert_tp=cfg.expert_tp)``: every "embed" dim cut over "data" as well):
    each model's step-0 loss, global gradient norm and every gradient leaf,
    then two AdamW steps, against the one-device port on the card from the
    same numpy inputs.  Tolerances as ``tests/test_torch_spmd.py`` holds
    the mesh to the reference: the loss rtol 1e-5, the cross-entropy
    gradient rtol 1e-5 / atol 1e-9, the norm rtol 5e-3, each model
    gradient leaf rtol 1e-4 with an atol of 1e-2 of its scale, the loss
    after the first update rtol 2e-3; the unsharded leaves bit-equal on
    every rank; each family's job launches B12 and not B11, B9 where its
    model has it, and the hybrid and ssm jobs the split passes of B10 (and
    of B9 for the sLSTM) and no one-pass B10.  Each rank's block is held against the
    same block cut from the one-device result.  These launches compare;
    they are not the main path's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import api, interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.xent import ops as xent_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import make_schedule
    from repro_torch.parallel import rules as rules_lib
    from repro_torch.parallel import specs, steps

    d, m = MESH_CHECK
    sizes = {"data": d, "model": m}
    schedule = ("cosine", MESH_CHECK_LR, 0, 10)

    job_rules = {}

    def train_job(name, cfg, tree, data):
        host = interop.params_from_jax(tree, cfg, device="cpu")
        state = map_leaves(interop.to_numpy, {
            "params": host,
            "opt": adamw.init_state(host, adamw.AdamWConfig())})
        return ("train", dict(cfg=cfg, state=state, data_cfg=data,
                              steps_run=2, schedule=schedule,
                              rules=job_rules.get(name)))

    cfg, _ = dataclasses.replace(
        reduce_for_smoke(get_config(TRAIN_ARCH)),
        vocab_size=MESH_CHECK_VOCAB).padded_for_mesh(m)
    models = {TRAIN_ARCH: (cfg, numpy_params(build_model(cfg).param_defs(),
                                             SEED),
                           DataConfig(vocab_size=cfg.vocab_logical,
                                      seq_len=64, global_batch=4))}
    for fam, (arch, changes) in (*MESH_FAMILIES.items(),
                                 *FSDP_CHECKS.items()):
        c = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **changes)
        if fam in FSDP_CHECKS:
            job_rules[fam] = rules_lib.make_rules(fsdp=True,
                                                  expert_tp=c.expert_tp)
        models[fam] = (c, numpy_params(build_model(c).param_defs(), SEED,
                                       true_fan_in=True, cfg=c),
                       DataConfig(vocab_size=c.vocab_size,
                                  seq_len=MESH_FAMILY_SEQ, global_batch=4,
                                  n_img_tokens=c.n_img_tokens,
                                  n_frames=(c.n_frames if c.family ==
                                            "encdec" else 0),
                                  d_model=c.d_model))
    # serving on the same mesh (ROADMAP A11.5): each reduced family under
    # rules.decode_rules, FSDP's reduced qwen3-14b under FSDP's rules, the
    # reduced Qwen2-0.5B again under the flash-decoding override
    serving = {}
    for fam, (arch, changes) in (*SERVE_FAMILIES.items(),
                                 ("flash", (TRAIN_ARCH, {}))):
        c = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **changes)
        serving[fam] = serve_inputs(c, numpy_params(
            build_model(c).param_defs(), SEED, true_fan_in=True, cfg=c))
        if fam.startswith("fsdp"):
            serving[fam][1]["rules"] = rules_lib.make_rules(
                fsdp=True, expert_tp=c.expert_tp)
        if fam == "flash":
            serving[fam][1].update(
                rules=rules_lib.make_rules(overrides=FLASH_CHECK_RULES),
                kv_caches=("paged", "dense"), max_len=FLASH_CHECK_MAX_LEN)
    # the masked loss (ROADMAP A11.5): the padded reduced Qwen2-0.5B
    mcfg, mtree, mdata = models[TRAIN_ARCH]
    masks = {"seeded": (np.random.default_rng(SEED).random(
        (mdata.global_batch, mdata.seq_len)) < MASK_CHECK_KEEP).astype(
        np.float32), "ones": np.ones((mdata.global_batch, mdata.seq_len),
                                     np.float32),
        "zeros": np.zeros((mdata.global_batch, mdata.seq_len), np.float32)}
    masked = [("seeded_grads", dict(cfg=mcfg, seed=SEED, data_cfg=mdata,
                                    tree=mtree, mask=mask))
              for mask in masks.values()]
    rng = np.random.default_rng(SEED)
    t, v, lv = MESH_XENT
    x = (3 * rng.standard_normal((t, v))).astype(np.float32)
    labels = rng.integers(0, lv, size=t).astype(np.int32)
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(
        mesh_checks.run, MESH_CHECK, device="cuda",
        args=([("xent", dict(logits=x, labels=labels, logical_v=lv))]
              + [train_job(name, *models[name]) for name in models]
              + [job for job, _ in serving.values()] + masked,))
    secs = time.perf_counter() - t0
    served = [hold_serve(fam, [ranked[1 + len(models) + i] for ranked in
                               ranks], *serving[fam][1:])
              for i, fam in enumerate(serving)]
    at = 1 + len(models) + len(serving)
    masked_line = hold_masked(
        {k: [ranked[at + i] for ranked in ranks]
         for i, k in enumerate(masks)}, masks, mcfg, mtree, mdata,
        [ranked[1]["loss0"] for ranked in ranks])

    xc, lc = torch.from_numpy(x).cuda(), torch.from_numpy(labels).cuda()
    want_loss = api.launch("xent", xc, lc, logical_v=lv)
    want_grad = xent_ops.xent_grad(xc, lc, 1.0, logical_v=lv)
    for r, ranked in enumerate(ranks):
        xo = ranked[0]
        where = f"spmd: mesh {MESH_CHECK} rank {r}"
        if xo["launches"]["xent.partial"] < 1 or xo["launches"]["xent"]:
            fail(f"{where}: xent launches {xo['launches']} (want B12, not "
                 f"B11)")
        check_close(f"{where} xent loss", torch.tensor(xo["loss"]),
                    want_loss.cpu(), 1e-5, 0.0)
        check_close(f"{where} xent_grad block", xo["grad"],
                    specs.shard_leaf(want_grad, xo["spec"], sizes,
                                     rank=r).cpu(), 1e-5, 1e-9)
    del want_grad, xc

    def hold(name, got, cfg, tree, data) -> str:
        """Every rank's ``train`` result against the one-device port on
        the card; the check line's text."""
        model = build_model(cfg)
        params = interop.params_from_jax(tree, cfg)
        loss, grads = steps.value_and_grad(model, params,
                                           make_batch(data, 0))
        gnorm = adamw.global_norm(grads)
        step_fn = steps.make_train_step(
            model, adamw.AdamWConfig(),
            make_schedule(schedule[0], peak=schedule[1], warmup=schedule[2],
                          total=schedule[3]))
        st = {"params": params,
              "opt": adamw.init_state(params, adamw.AdamWConfig())}
        losses = []
        for i in range(2):
            st, metrics = step_fn(st, make_batch(data, i))
            losses.append(metrics["loss"])
        worst, n_leaves = 0.0, 0
        for r, tr in enumerate(got):
            where = f"spmd: mesh {MESH_CHECK} rank {r} {name}"
            check_close(f"{where} model loss", torch.tensor(tr["loss0"]),
                        loss.cpu(), 1e-5, 0.0)
            check_close(f"{where} gradient norm", torch.tensor(tr["gnorm0"]),
                        gnorm.cpu(), 5e-3, 0.0)
            n_leaves = 0
            for path, g in leaves(grads):
                if g is None:
                    continue
                n_leaves += 1
                block = specs.shard_leaf(g, pick(tr["specs"]["params"],
                                                 path), sizes, rank=r).cpu()
                scale = float(g.abs().max())
                err = check_close(f"{where} gradient {'/'.join(path)}",
                                  pick(tr["grads0"], path), block, 1e-4,
                                  1e-2 * scale)
                worst = max(worst, err / max(scale, 1e-30))
            for i, (a, b) in enumerate(zip(tr["losses"], losses)):
                check_close(f"{where} loss of step {i}", torch.tensor(a),
                            b.cpu(), 1e-5 if i == 0 else 2e-3, 0.0)
            if tr["digests"] != got[0]["digests"]:
                fail(f"{where}: unsharded leaves differ from rank 0's")
            emb = tuple(tr["state"]["params"]["embed"].shape)
            want_emb = (cfg.vocab_size // m,
                        cfg.d_model // (d if name in job_rules else 1))
            if emb != want_emb:
                fail(f"{where}: embed block {emb}, want {want_emb}")
            launched = tr["launches"]
            need_rms = cfg.norm == "rmsnorm"
            # the recurrent blocks' norms, split on the model axis: B10's
            # passes (Mamba2, mLSTM), B9's (sLSTM), no one-pass B10
            split = ({"rmsnorm.gated.sumsq", "rmsnorm.gated.apply"}
                     if cfg.family in ("hybrid", "ssm") else set())
            if cfg.family == "ssm":
                split |= {"rmsnorm.plain.sumsq", "rmsnorm.plain.apply"}
            if (launched["xent.partial"] < 1 or launched["xent"]
                    or (need_rms and launched["rmsnorm.plain"] < 1)
                    or any(launched[k] < 1 for k in split)
                    or launched["rmsnorm.gated"]):
                fail(f"{where}: launches {launched} (want B12 and no B11"
                     + (", B9" if need_rms else "")
                     + (f", {sorted(split)}, no one-pass B10" if split
                        else "") + ")")
        return (f"{name} ({cfg.family}{', FSDP' if name in job_rules else ''}"
                f", embed block "
                f"{tuple(got[0]['state']['params']['embed'].shape)}) loss "
                f"{got[0]['loss0']!r} vs "
                f"{float(loss)!r}, norm {got[0]['gnorm0']!r} vs "
                f"{float(gnorm)!r}, {n_leaves} leaves (worst "
                f"{worst:.3g} of scale), losses {got[0]['losses']} vs "
                f"{[float(v) for v in losses]}, launches a rank "
                f"{got[0]['launches']}")

    lines = [hold(name, [ranked[1 + i] for ranked in ranks], *models[name])
             for i, name in enumerate(models)]
    print(f"check: vocab-parallel backward on a {MESH_CHECK} mesh of "
          f"{d * m} ranks on the card (gloo, pinned host buffers): xent "
          f"{MESH_XENT} loss and xent_grad blocks within rtol 1e-5 of the "
          f"one-device run, B12 on every rank; reduced {TRAIN_ARCH} fp32 "
          f"with vocab {cfg.vocab_logical} padded to {cfg.vocab_size} and "
          f"the reduced fp32 {', '.join(MESH_FAMILIES)} models under their "
          f"launchers' rules (tensor-parallel, the hybrid and ssm norms "
          f"split) and the {', '.join(FSDP_CHECKS)} models under FSDP's "
          f"(\"embed\" over \"data\" too), each "
          f"model's loss within rtol 1e-5, gradient norm within rtol 5e-3, "
          f"every gradient leaf within rtol 1e-4 / atol 1e-2 of its scale, "
          f"the loss after an update within rtol 2e-3 of the one-device "
          f"port, unsharded leaves bit-equal on every rank; {secs:.1f} s "
          f"for the spawn: ok")
    for line in lines:
        print(f"check: mesh {MESH_CHECK}: {line}")
    print(f"check: serving on a {MESH_CHECK} mesh of {d * m} ranks on the "
          f"card under rules.decode_rules (FSDP's rules for "
          f"{', '.join(f for f in SERVE_FAMILIES if f.startswith('fsdp'))}"
          f"): each reduced fp32 family's replayed decode logits within "
          f"rtol 1e-5 / atol 1e-5 of their scale of the one-device port on "
          f"the card, the ranks agree (paged), the streams equal one "
          f"device's up to any decision "
          f"whose top-2 gap is below that bound: ok")
    for line in served:
        print(f"check: mesh {MESH_CHECK} serve: {line}")
    print(f"check: mesh {MESH_CHECK} masked loss: {masked_line}")
    torch.cuda.empty_cache()


def hold_masked(got: dict, masks: dict, cfg, tree, data,
                unmasked: list) -> str:
    """The masked loss on the (2, 2) check's mesh (``mesh_checks.
    seeded_grads`` with a mask, a rank's rows of it as of the tokens)
    against the one-device port's masked loss on the card from the same
    weights and batch, at the backward check's gates: the loss rtol 1e-5,
    each gradient leaf rtol 1e-4 / atol 1e-2 of its scale (rank blocks
    against the same blocks cut from one device's); the all-ones mask's
    loss within rtol 1e-5 of the unmasked loss of the same mesh
    (``unmasked``, each rank's train job's step-0 loss), the all-zeros
    mask's loss 0 and every gradient 0.  The check line's text."""
    import torch

    from repro_torch import interop
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves
    from repro_torch.parallel import specs, steps

    d, m = MESH_CHECK
    sizes = {"data": d, "model": m}
    model = build_model(cfg)
    params = interop.params_from_jax(tree, cfg)
    batch = make_batch(data, 0)
    out = []
    for kind, mask in masks.items():
        b = dict(batch, mask=torch.from_numpy(mask).cuda())
        loss, grads = steps.value_and_grad(model, params, b)
        for r, tr in enumerate(got[kind]):
            where = f"spmd: mesh {MESH_CHECK} rank {r} masked loss ({kind})"
            check_close(f"{where} loss", torch.tensor(tr["loss0"]),
                        loss.cpu(), 1e-5, 0.0)
            for path, g in leaves(grads):
                if g is None:
                    continue
                block = specs.shard_leaf(g, pick(tr["specs"], path), sizes,
                                         rank=r).cpu()
                check_close(f"{where} gradient {'/'.join(path)}",
                            pick(tr["grads0"], path), block, 1e-4,
                            1e-2 * float(g.abs().max()))
                if kind == "zeros" and bool(pick(tr["grads0"], path).any()):
                    fail(f"{where}: a nonzero gradient of {'/'.join(path)}")
            if kind == "ones":
                check_close(f"{where} against the unmasked loss",
                            torch.tensor(tr["loss0"]),
                            torch.tensor(unmasked[r]), 1e-5, 0.0)
            if kind == "zeros" and tr["loss0"] != 0.0:
                fail(f"{where}: loss {tr['loss0']} under an all-zeros mask")
        out.append(f"{kind} {got[kind][0]['loss0']!r} vs {float(loss)!r}")
    return (f"{cfg.name} (vocab {cfg.vocab_logical} padded to "
            f"{cfg.vocab_size}) under {', '.join(out)} (mesh vs one "
            f"device), every leaf within the check's gates, the all-ones "
            f"mask at the unmasked loss, the all-zeros mask 0 with every "
            f"gradient 0: ok")


def serve_inputs(cfg, tree) -> tuple:
    """A ``mesh_checks.serve`` job of the reduced ``cfg`` with the numpy
    weights ``tree`` (``SERVE_CHECK`` requests, or an encoder-decoder's
    static batch, paged and dense, and a teacher-forced replay of seeded
    streams), and what ``hold_serve`` holds it with."""
    import numpy as np

    from repro_torch.serving import Request

    n, slots, max_len, chunk, steps, gen = SERVE_CHECK
    rng = np.random.default_rng(SEED)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size,
                                    size=3 + 2 * i).tolist(), 4 + i)
            for i in range(n)]
    streams = rng.integers(1, cfg.vocab_size, (n, steps)).astype(np.int32)
    frames = (rng.standard_normal((n, cfg.n_frames, cfg.d_model))
              .astype(np.float32) if cfg.family == "encdec" else None)
    kw = dict(cfg=cfg, tree=tree, replay=streams, frames=frames)
    if cfg.family == "encdec":
        kw.update(gen=gen)
    else:
        kw.update(reqs=reqs, slots=slots, max_len=max_len,
                  prefill_chunk=chunk, kv_caches=("paged",))
    return ("serve", kw), kw


def hold_serve(name: str, got: list[dict], kw: dict) -> str:
    """Every rank's ``mesh_checks.serve`` result against the one-device
    port on the card from the same inputs (``serve_inputs``); the check
    line's text."""
    import torch

    from repro_torch import interop
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import build_model

    cfg = kw["cfg"]
    model = build_model(cfg)
    streams = torch.from_numpy(kw["replay"]).cuda()
    dev = streams.device
    params = interop.params_from_jax(kw["tree"], cfg, device=dev)
    frames = (None if kw["frames"] is None
              else torch.from_numpy(kw["frames"]).cuda())
    want = serve_lib.teacher_forced_logits(model, params, streams,
                                           frames=frames).cpu()
    scale = float(want.abs().max())
    bound = 1e-5 * scale
    for r, rank in enumerate(got):
        where = f"serve check {name} rank {r}"
        check_close(f"{where} replayed logits", rank["replay"], want, 1e-5,
                    bound)
    if cfg.family == "encdec":
        static = serve_lib.serve_static(model, params, frames, streams,
                                        kw["gen"]).cpu()
        for r, rank in enumerate(got):
            if not torch.equal(rank["runs"]["static"]["out"], static):
                fail(f"serve check {name} rank {r}: static tokens differ "
                     f"from one device's")
        return (f"{name} ({cfg.family}) replay within {bound:.3g}, the "
                f"static batch's {tuple(static.shape)} tokens equal one "
                f"device's")
    one = serve_lib.serve_requests(
        model, params, kw["reqs"], kv_cache="paged", slots=kw["slots"],
        max_len=kw["max_len"], prefill_chunk=kw["prefill_chunk"],
        device=dev)["completed"]
    agree = 0
    for r, rank in enumerate(got):
        if (rank["runs"]["paged"]["completed"]
                != got[0]["runs"]["paged"]["completed"]):
            fail(f"serve check {name} rank {r}: tokens differ from rank 0's")
        if ("dense" in rank["runs"] and rank["runs"]["dense"]["completed"]
                != rank["runs"]["paged"]["completed"]):
            fail(f"serve check {name} rank {r}: paged tokens differ from "
                 f"dense")
    for req in kw["reqs"]:
        mine, theirs = got[0]["runs"]["paged"]["completed"][req.rid], \
            one[req.rid]
        if mine == theirs:
            agree += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b)
        seq = torch.tensor([req.prompt + theirs[:j]], dtype=torch.int32,
                           device=dev)
        logits = serve_lib.teacher_forced_logits(model, params,
                                                 seq)[-1, 0]
        top = torch.topk(logits, 2).values
        if float(top[0] - top[1]) >= bound:
            fail(f"serve check {name}: request {req.rid} differs from one "
                 f"device's at token {j}, where one device's top-2 gap "
                 f"{float(top[0] - top[1]):.3g} exceeds {bound:.3g}")
    run = got[0]["runs"]["paged"]
    return (f"{name} ({cfg.family}) replay within {bound:.3g}, the ranks "
            f"agree, {agree} of {len(kw['reqs'])} streams "
            f"equal one device's (any other first differs at a near-tie), "
            f"{run['micro_steps']} decode steps, "
            f"{run['comm']['calls'] / max(run['micro_steps'], 1):.1f} "
            f"collectives a step, rank 0's launches {run['launches']}")


def pick(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def full_width_backward_check(arch: str = TRAIN_ARCH,
                              layers: int = TRAIN_LAYERS,
                              batch: int = TRAIN_BATCH,
                              seq: int = TRAIN_SEQ) -> None:
    """The vocab-parallel backward at full width, fatal: Qwen2-0.5B in fp32
    (every width of the config, ``TRAIN_LAYERS`` of its layers, remat on,
    the weights ``model.init``
    draws from ``SEED``: the port's init, at the true attention fan-ins,
    ROADMAP §C) on one seeded batch of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens -- or ``arch`` cut to ``layers`` on ``batch`` x ``seq`` tokens,
    as phase 3j holds xlstm-1.3b --, on one device and on a (1, 2) mesh of
    two ranks on the card
    (``launch.mesh_checks.seeded_grads``): the loss, the global gradient
    norm and every gradient leaf, each rank's block against the same block
    cut from the one-device gradient.  The mesh runs under the launchers'
    rules: tensor-parallel, 7 of the 14 heads, 1 of the 2 KV heads and
    2,432 of the 4,864 MLP columns a rank.

    fp32, because the point is the algorithm, and it fits: 2 GB of weights
    and 2 GB of gradients a process.  The tolerances: the mesh computes the
    head's two products over the two vocab halves, combines the log-sum-exp
    across the ranks and sums the head's dx over them, and each layer's
    attention and MLP outputs as two partial products over half the heads
    or columns summed across the ranks (their input's dx too), so its
    activations, logits and dx differ from one device's by fp32 rounding
    (unit 6e-8) over sums of up to 151,936 terms taken in another order;
    at the true fan-ins the backward carries that through 24 layers
    without growth (on the CPU the reduced tensor-parallel model matches
    one device to 2e-6 of each leaf's scale, tests/test_torch_tp.py, and
    two frameworks that order every sum differently gave full-width norms
    5.8e-5 apart, ROADMAP §C).  Held: the loss rtol 1e-5, the norm rtol
    1e-4, each leaf atol 1e-4 of its largest magnitude.  A dropped or
    doubled sum over the ranks moves a leaf by the order of its scale.
    xlstm-1.3b is held to the same gates: its bf16 launch's step 0 sits
    near ``TP_LOSS_RTOL`` from one device's, and in fp32 (unit 2^16 times
    smaller) rounding the mLSTM amplifies stays near 1e-6, where a fault
    in its gate sums or a rank's head slice would not.
    These launches check; they are not the main path's."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel import specs, steps

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, d_model=cfg.d_model)
    loss, grads = steps.value_and_grad(model, model.init(SEED),
                                       make_batch(data, 0))
    norm = float(global_norm(grads))
    grads = map_leaves(lambda g: g.cpu(), grads)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(mesh_checks.run, (1, 2), device="cuda", args=(
        [("seeded_grads", dict(cfg=cfg, seed=SEED, data_cfg=data))],))
    secs = time.perf_counter() - t0
    sizes = {"data": 1, "model": 2}
    worst, n_leaves = 0.0, 0
    for r, (res,) in enumerate(ranks):
        where = f"full-width backward, mesh (1, 2) rank {r}"
        check_close(f"{where} loss", torch.tensor(res["loss0"]), loss.cpu(),
                    FULL_LOSS_RTOL, 0.0)
        check_close(f"{where} gradient norm", torch.tensor(res["gnorm0"]),
                    torch.tensor(norm), FULL_NORM_RTOL, 0.0)
        n_leaves = 0
        for path, g in leaves(grads):
            name = "/".join(path)
            scale = float(g.abs().max())
            if not scale > 0:
                fail(f"{where}: the one-device gradient of {name} is zero")
            block = specs.shard_leaf(g, pick(res["specs"], path), sizes,
                                     rank=r)
            err = check_close(f"{where} gradient {name}",
                              pick(res["grads0"], path), block, 0.0,
                              FULL_LEAF_ATOL * scale)
            worst = max(worst, err / scale)
            n_leaves += 1
    rel = abs(ranks[0][0]["gnorm0"] - norm) / norm
    print(f"check: full-width {arch} fp32 backward ({cfg.n_layers} layers, "
          f"seed {SEED}, {batch * seq} tokens), one device against a (1, 2) "
          f"mesh of two ranks on the card: loss {ranks[0][0]['loss0']!r} vs "
          f"{float(loss)!r}, step-0 gradient norm {ranks[0][0]['gnorm0']!r} "
          f"vs {norm!r} (relative {rel:.3g}; rtol {FULL_NORM_RTOL}), every "
          f"one of {n_leaves} leaves within atol {FULL_LEAF_ATOL} of its "
          f"scale (worst {worst:.3g} of scale): ok; {secs:.1f} s for the "
          f"spawn")
    del grads, ranks
    torch.cuda.empty_cache()


def require_default_compute_mode(label: str) -> None:
    """Two ranks on one card need its Default compute mode."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{label}: compute mode {mode}")
    if mode.splitlines()[0].strip() != "Default":
        fail(f"{label}: two ranks on one card need the Default compute mode, "
             f"not {mode!r}")


def halo_phase() -> tuple[dict[str, int], dict]:
    """Phase 3i: the Jacobi and LBM halo-exchange shard bodies on a (2, 1)
    mesh of two ranks of the one card (gloo, the halos staged through
    pinned host buffers), in one spawn, at the main path's sizes: each
    rank holds half of the 16384 x 16384 fp32 grid and of the N = 256 and
    250 lattices (``launch.mesh_checks.halo_card``).  Each rank zeroes its
    kernel counters just before its drive and reads them just after.
    Fatal unless, on every rank, the mesh's ``jacobi_sweeps`` and
    ``lbm_run`` equal one device's by ``torch.equal`` (both layouts), the
    overlapped Jacobi body equals the blocking one, B7 and B8 give every
    site the same bits, the overlap report finds both shifts of each body
    overlappable and none of the blocking body's, the bytes ``Mesh.comm``
    counted equal ``predicted_comm_bytes``, and B6, B7 and B8 launched.
    Returns the launches summed over the ranks and rank 0's results (the
    exposed-comm line is printed once the copy's rate is measured)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks

    require_default_compute_mode("halo")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    jobs = [("halo_card", dict(grid=GRID, sweeps=SWEEPS, lbm_sizes=LBM_SIZES,
                               steps=LBM_STEPS, omega=OMEGA, seed=SEED)),
            ("validate_comm", dict(kernels=sorted(HALO_COMM_CASES),
                                  exposed=True, cases=HALO_COMM_CASES))]
    out = mesh_lib.spawn(mesh_checks.run, HALO_MESH, device="cuda",
                         args=(jobs,))
    ranks = [r[0] for r in out]
    measure_comm_check([r[1] for r in out])

    def check_report(what, rep, overlappable):
        want = 2 if overlappable else 0
        if len(rep.collectives) != 2 or rep.n_overlappable != want or \
                any(c.primitive != "ppermute" for c in rep.collectives):
            fail(f"halo: {what}: overlap report {rep} (want 2 shifts, "
                 f"{want} overlappable)")

    for r in ranks:
        what = f"rank {r['rank']}"
        j = r["jacobi"]
        if not (j["equal_one_device"] and j["equal_blocking"]):
            fail(f"halo: {what}: jacobi mesh = one device "
                 f"{j['equal_one_device']}, overlapped = blocking "
                 f"{j['equal_blocking']}")
        check_report(f"{what} jacobi", j["report"], True)
        check_report(f"{what} jacobi blocking", j["blocking_report"], False)
        cases = [("jacobi", j)] + [(f"lbm {k}", v) for k, v in
                                   r["lbm"].items() if isinstance(v, dict)]
        for name, c in cases:
            if c["comm_bytes"] != c["predicted_comm_bytes"]:
                fail(f"halo: {what} {name}: comm bytes {c['comm_bytes']} != "
                     f"predicted {c['predicted_comm_bytes']}")
        for name, c in cases[1:]:
            if not c["equal_one_device"]:
                fail(f"halo: {what} {name}: the mesh's lbm_run differs from "
                     f"one device's")
            check_report(f"{what} {name}", c["report"], True)
        for n in LBM_SIZES:
            if not r["lbm"][f"b7_equals_b8 N={n}"]:
                fail(f"halo: {what}: B7 and B8 differ on a site at N={n}")
        missing = [k for k, v in r["launches"].items() if v == 0]
        if missing:
            fail(f"halo: {what}: {missing} never launched on the mesh path "
                 f"({r['launches']})")
    r0 = ranks[0]
    j = r0["jacobi"]
    per_sweep = j["halo_calls"] // 2
    print(f"halo: jacobi {GRID}x{GRID} fp32 x{SWEEPS} on a {HALO_MESH} mesh "
          f"of two ranks on one card ({r0['transport']}), "
          f"{GRID // 2} rows a rank: equal to one device and to the blocking "
          f"body bit for bit, both shifts overlappable (blocking: 0), comm "
          f"{j['comm_bytes']} B a sweep = predicted; rank 0: overlapped "
          f"{j['ms']:.4f} ms a sweep, blocking {j['blocking_ms']:.4f} ms, one "
          f"device {j['one_device_ms']:.4f} ms (rank 0 alone), interior "
          f"kernel {j['interior_ms']:.4f} ms; halo {j['halo_bytes']} B and "
          f"{j['halo_seconds'] * 1e3:.3f} ms on the host's clock over "
          f"{per_sweep} sweeps; bare shifts {j['link'][0]} B in "
          f"{j['link'][1] * 1e3:.3f} ms")
    for key, c in r0["lbm"].items():
        if key.startswith("link"):
            print(f"halo: lbm {key}: bare shifts {c[0]} B in "
                  f"{c[1] * 1e3:.3f} ms")
        if not isinstance(c, dict):
            continue
        print(f"halo: lbm {key} fp32 x{LBM_STEPS}: equal to one device bit "
              f"for bit, both slabs overlappable, comm {c['comm_bytes']} B a "
              f"step = predicted; rank 0: overlapped {c['ms']:.4f} ms a step, "
              f"one device {c['one_device_ms']:.4f} ms, interior (propagate + "
              f"collide) {c['interior_ms']:.4f} ms, its collision "
              f"{c['collide_ms']:.4f} ms; halo {c['halo_bytes']} B and "
              f"{c['halo_seconds'] * 1e3:.3f} ms on the host's clock")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    print(f"halo: launches a rank {[r['launches'] for r in ranks]}, B7 = B8 "
          f"per site at N = {LBM_SIZES}; peak memory "
          + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} GiB"
                      for r in ranks)
          + f"; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, r0


def halo_exposure(r0: dict, copy_bytes_per_s: float) -> None:
    """The halo's predicted exposed bytes, at the B1 copy's measured rate
    and the rate of bare shifts of the same payload, beside the measured
    exposed time (the overlapped step less its interior)."""
    from repro_torch import api

    j = r0["jacobi"]
    mesh = dict(zip(("data", "model"), HALO_MESH))
    rows = [("jacobi", (GRID // HALO_MESH[0], GRID), j, j["link"])]
    for n in LBM_SIZES:
        for layout in ("soa", "ivjk"):
            rows.append((f"lbm.{layout}", (19, n // HALO_MESH[0], n, n),
                         r0["lbm"][f"{layout} N={n}"],
                         r0["lbm"][f"link N={n}"]))
    for kernel, shape, c, (nbytes, secs) in rows:
        link = nbytes / secs
        with api.plan_context(mesh=mesh):
            plan = api.plan_for(kernel, shape, "float32", local=True)
        exposed = plan.predicted_exposed_comm_bytes(
            hbm_bytes_per_s=copy_bytes_per_s, link_bytes_per_s=link)
        print(f"halo: exposed {kernel} {shape}: predicted "
              f"{exposed} of {plan.predicted_comm_bytes} B "
              f"({exposed / link * 1e3:.4f} ms at the link's "
              f"{link / 1e9:.4f} GB/s, memory at the copy's "
              f"{copy_bytes_per_s / 1e9:.1f} GB/s); measured overlapped "
              f"less interior {c['ms'] - c['interior_ms']:.4f} ms")


def check_launch_ranks(ranks: list[dict], where: str, steps: int,
                       kernel: str, other: str) -> list[float]:
    """The gates on the ranks of one ``launch.train`` run: each ran steps 0
    to ``steps`` - 1 with finite losses equal to rank 0's, launched
    ``kernel`` once a step and ``other`` never, and holds rank 0's
    unsharded leaves bit for bit.  Returns rank 0's losses."""
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    for r in ranks:
        mine = [m["loss"] for m in r["metrics"]]
        if [m["step"] for m in r["metrics"]] != list(range(steps)):
            fail(f"{where}: rank {r['rank']} ran steps "
                 f"{[m['step'] for m in r['metrics']]}")
        if not all(math.isfinite(v) for v in mine):
            fail(f"{where}: rank {r['rank']}: non-finite loss in {mine}")
        if mine != losses:
            fail(f"{where}: rank {r['rank']} losses {mine} differ from rank "
                 f"0's {losses}")
        if r["launches"][kernel] != steps or r["launches"][other] != 0:
            fail(f"{where}: rank {r['rank']} launches {r['launches']} (want "
                 f"{kernel} {steps}, one a step, and {other} 0)")
        digests, first = r["digests"], ranks[0]["digests"]
        diff = sorted(k for k in digests.keys() | first.keys()
                      if digests.get(k) != first.get(k))
        if diff:
            fail(f"{where}: rank {r['rank']}'s unsharded leaves {diff} "
                 f"differ from rank 0's")
    return losses


def tp_cut(ranks: list[dict], cfg, where: str, stage: str) -> str:
    """The gate on a tensor-parallel (1, 2) launch: every rank's blocks of
    ``stage``'s attention and MLP and of the embedding hold its share of
    the heads, KV heads, MLP columns and vocab rows of ``cfg`` (KV heads
    that do not divide stay whole).  Returns the shares as text."""
    m = 2
    kv = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else cfg.n_kv_heads
    want = {f"{stage}/attn/wq": cfg.n_heads // m,
            f"{stage}/attn/wk": kv,
            f"{stage}/mlp/wi": cfg.d_ff // m,
            "embed": cfg.vocab_size // m}
    dim = {f"{stage}/attn/wq": 2, f"{stage}/attn/wk": 2,
           f"{stage}/mlp/wi": 2, "embed": 0}
    for r in ranks:
        got = {k: r["state_shapes"][f"params/{k}"][d] for k, d in dim.items()}
        if got != want:
            fail(f"{where}: rank {r['rank']}'s blocks {got} are not its "
                 f"shares {want} of {cfg.name}")
    return (f"a rank holds {want[f'{stage}/attn/wq']} of {cfg.n_heads} "
            f"heads, {kv} of {cfg.n_kv_heads} KV heads, "
            f"{want[f'{stage}/mlp/wi']} of {cfg.d_ff} MLP columns, "
            f"{want['embed']} of {cfg.vocab_size} vocab rows")


def print_profile(label: str, prof: dict) -> None:
    """The ``profile:`` line of a launcher's profiled train step."""
    print(f"profile: {label}: {prof['wall_ms']:.3f} ms, device kernels "
          f"{prof['busy_ms']:.3f} ms (busy "
          f"{prof['busy_ms'] / prof['wall_ms']:.1%}) in {prof['launches']} "
          f"launches, collectives {prof['comm']['calls']} calls, "
          f"{prof['comm']['bytes']} bytes, "
          f"{prof['comm']['seconds'] * 1e3:.1f} ms on the host's clock "
          f"({prof['seconds']:.1f} s to profile it); "
          + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in prof["top"]))


def check_mesh_stream(records, ranks: list[dict]) -> None:
    """Phase 3d's gates on a ``launch.train --mesh --obs-jsonl`` run's
    stream: one ``train_step`` record a step with rank 0's losses, every
    record rank 0's, no other rank's bus listening, and every local plan of
    the profiled norm cell an override from ``--plan-profile``; prints the
    ``obs:`` line."""
    got = [(r["step"], r["loss"]) for r in records
           if r["kind"] == "train_step"]
    want = [(m["step"], m["loss"]) for m in ranks[0]["metrics"]]
    if got != want:
        fail(f"obs: spmd: train_step records {got} != rank 0's metrics "
             f"{want}")
    if ranks[0]["obs"]["records"] != len(records):
        fail(f"obs: spmd: the file holds {len(records)} records, rank 0 "
             f"wrote {ranks[0]['obs']['records']}")
    others = {r["rank"]: r["obs"] for r in ranks[1:]}
    if any(o["enabled"] or o["records"] for o in others.values()):
        fail(f"obs: spmd: ranks other than 0 streamed: {others}")
    from repro_torch.configs import get_config

    source = f"profile:{SPMD_PROFILE}"
    cell = [TRAIN_SEQ * TRAIN_BATCH, get_config(TRAIN_ARCH).d_model]
    pinned = [r for r in records if r["kind"] == "plan"
              and r["kernel"] == "rmsnorm" and r["local"]
              and list(r["shape"]) == cell]
    if not pinned or any(r["cache"] != "override" or r["source"] != source
                         for r in pinned):
        fail(f"obs: spmd: rank 0's local rmsnorm plans "
             f"{sorted({(r['cache'], r['source']) for r in pinned})} "
             f"(want every one an override from {source})")
    print(f"obs: phase 3d mesh stream (rank 0 of {len(ranks)}): "
          f"{len(records)} records {kind_counts(records)}; train_step "
          f"records = rank 0's metrics ({len(got)} steps); other ranks' "
          f"buses {others}; {len(pinned)} local rmsnorm plans, each an "
          f"override from --plan-profile: ok")


def spmd_phase(train_metrics: list[dict]) -> dict[str, int]:
    """Phase 3d: the vocab-parallel loss and backward checked on the card,
    then vocab-parallel training of Qwen2-0.5B at full width on a (1, 2)
    mesh of two ranks on the one card, through the launcher, held against
    the one-device run's ``train_metrics``, and a checkpoint replay.  Each
    rank zeroes its kernel counters just before its run and reads them just
    after; returns the launches summed over the ranks of the first run.  The
    first run streams to ``--obs-jsonl``, which rank 0 alone writes."""
    import os
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launcher

    require_default_compute_mode("spmd")
    t_phase = time.perf_counter()
    partial_kernel_checks()
    mesh_backward_checks()
    full_width_backward_check()
    shutil.rmtree(SPMD_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    # both launches replay the measure phase's profile of the ranks' norm
    # cell (--plan-profile, ROADMAP A7.4)
    argv = ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS),
            "--mesh", SPMD_MESH, "--baseline",
            "--steps", str(SPMD_STEPS), "--seq-len", str(TRAIN_SEQ),
            "--global-batch", str(TRAIN_BATCH), "--ckpt-every",
            str(SPMD_CKPT_EVERY), "--seed", str(SEED),
            "--plan-profile", str(SPMD_PROFILE)]
    t0 = time.perf_counter()
    ranks = train_launcher.main(argv + ["--ckpt-dir", str(SPMD_DIR / "run"),
                                        "--profile", "--obs-jsonl",
                                        str(OBS_DIR / "spmd.jsonl")])
    secs = time.perf_counter() - t0
    tokens = TRAIN_SEQ * TRAIN_BATCH
    losses = check_launch_ranks(ranks, "spmd", SPMD_STEPS, "xent.partial",
                                "xent")
    check_mesh_stream(read_stream(OBS_DIR / "spmd.jsonl"), ranks)
    cut = tp_cut(ranks, get_config(TRAIN_ARCH), "spmd", "s00_dense")
    one = [m["loss"] for m in train_metrics]
    rel = [abs(losses[i] - one[i]) / abs(one[i]) for i in range(2)]
    if not max(rel) <= TP_LOSS_RTOL:
        fail(f"spmd: losses {losses[:2]} vs the one-device run's {one[:2]}:"
             f" relative {rel} > {TP_LOSS_RTOL}")
    step_ms = statistics.median(m["step_s"] for m in
                                ranks[0]["metrics"][1:]) * 1e3
    prof = ranks[0]["profile"]
    print(f"spmd: {TRAIN_ARCH} bf16 + fp32 master, remat, mesh "
          f"{SPMD_MESH} (data 1, model 2) on one card, tensor-parallel "
          f"({cut}), backend "
          f"{ranks[0]['backend']}, collective transport "
          f"{ranks[0]['transport']}: losses {losses}; the first two equal "
          f"the one-device run's {one[:2]} to {rel} (rtol {TP_LOSS_RTOL}; "
          f"step "
          f"0's rate is 0, so both are forwards of the initial weights); "
          f"gradient norms {[m['grad_norm'] for m in ranks[0]['metrics']]} "
          f"vs the one-device run's "
          f"{[m['grad_norm'] for m in train_metrics[:SPMD_STEPS]]} "
          f"(reported, not gated: bf16 rounding moves them; the fp32 "
          f"full-width gate above holds the mesh's backward to one "
          f"device's)")
    comm = ranks[0]["comm"]
    print(f"spmd: {step_ms:.1f} ms a step (median of steps 1-"
          f"{SPMD_STEPS - 1}, rank 0), {tokens / step_ms * 1e3:.0f} tokens/s, "
          f"steps {[round(m['step_s'] * 1e3, 1) for m in ranks[0]['metrics']]}"
          f" ms; peak memory "
          + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} GiB"
                      for r in ranks)
          + f"; launches a rank {ranks[0]['launches']}; collectives on "
          f"rank 0 {comm['calls']} calls, {comm['bytes']} bytes, "
          f"{comm['seconds'] * 1e3:.1f} ms on the host's clock over the run "
          f"(staging and checkpoint gathers included); "
          f"{len(ranks[0]['digests'])} unsharded leaves bit-equal on both "
          f"ranks; {secs:.1f} s for the launch (spawn, init, "
          f"{SPMD_STEPS} steps, checkpoints, the profiled step)")
    print_profile(f"spmd train step rank 0 of {SPMD_MESH}", prof)

    # the round trip: a second launch restores step 2 and replays it
    name = f"step_{SPMD_CKPT_EVERY:08d}"
    (SPMD_DIR / "replay" / name).mkdir(parents=True)
    for f in os.listdir(SPMD_DIR / "run" / name):
        os.link(SPMD_DIR / "run" / name / f, SPMD_DIR / "replay" / name / f)
    shutil.rmtree(SPMD_DIR / "run")
    replayed = train_launcher.main(argv + ["--ckpt-dir",
                                           str(SPMD_DIR / "replay")])
    got = [m["loss"] for m in replayed[0]["metrics"]]
    if [m["step"] for m in replayed[0]["metrics"]] != list(
            range(SPMD_CKPT_EVERY, SPMD_STEPS)):
        fail(f"spmd: replayed steps "
             f"{[m['step'] for m in replayed[0]['metrics']]}")
    if got[0] != losses[SPMD_CKPT_EVERY]:
        fail(f"spmd: replayed step {SPMD_CKPT_EVERY} loss {got[0]!r} != "
             f"{losses[SPMD_CKPT_EVERY]!r}")
    print(f"spmd: restored step {SPMD_CKPT_EVERY} (gathered into the "
          f"one-device layout by the mesh run) into a new mesh run: replayed "
          f"step {SPMD_CKPT_EVERY} loss {got[0]!r} equals the first run's bit "
          f"for bit; later steps {got[1:]} vs {losses[SPMD_CKPT_EVERY + 1:]}: "
          f"ok")
    shutil.rmtree(SPMD_DIR)
    shutil.rmtree(MEASURE_DIR)
    print(f"spmd: the phase took {time.perf_counter() - t_phase:.1f} s (B12 "
          f"checks, two launches of the mesh, their checkpoints)")
    return {"xent.partial": sum(r["launches"]["xent.partial"] for r in ranks)}


def whisper_mesh_phase(one_device: list[dict]) -> dict[str, int]:
    """Phase 3d's second part, run after phase 3h because it is held
    against 3h's one-device run: whisper-tiny at full width trained by
    ``launch.train`` on a (2, 1) mesh of two ranks on the card
    (``--baseline``: a rank's 4 of the 8 rows, their frames, B11 on its
    (1792, 51865) logits) and on a (1, 2) mesh (the vocab padded by
    ``padded_for_mesh(2)``, B12 on each shard), ``WHISPER_MESH_STEPS``
    steps each and one more profiled on rank 0.  Gates: every rank ran
    every step with finite losses equal to the other rank's; each rank's
    counters, zeroed just before its run and read just after, show B11
    once a step and no B12 on (2, 1), the reverse on (1, 2); the losses of
    steps 0 and 1 (forwards of the initial weights) within
    ``WHISPER_MESH_RTOL`` of phase 3h's one-device steps 0 and 1 on (2, 1)
    and within ``TP_LOSS_RTOL`` of one-device forwards of the padded
    config's seeded weights on the same batches on (1, 2), whose layers
    are tensor-parallel (3 of the 6 heads and half the MLP a rank, gated
    by ``tp_cut``); the unsharded leaves bit-equal on both ranks.
    Returns the launches summed over the ranks of both runs."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    full = get_config(ENCDEC_ARCH)
    padded, changes = full.padded_for_mesh(2)
    data = DataConfig(vocab_size=full.vocab_size, seq_len=ENCDEC_TRAIN_SEQ,
                      global_batch=ENCDEC_TRAIN_BATCH,
                      n_frames=full.n_frames, d_model=full.d_model)
    model = build_model(padded)
    params = model.init(SEED)
    with torch.no_grad():
        padded_losses = [float(model.loss(params, make_batch(data, step)))
                         for step in range(2)]
    del model, params
    torch.cuda.empty_cache()
    shutil.rmtree(WHISPER_MESH_DIR, ignore_errors=True)
    argv = ["--arch", ENCDEC_ARCH, "--steps", str(WHISPER_MESH_STEPS),
            "--seq-len", str(ENCDEC_TRAIN_SEQ), "--global-batch",
            str(ENCDEC_TRAIN_BATCH), "--ckpt-every",
            str(WHISPER_MESH_STEPS + 1), "--seed", str(SEED), "--profile"]
    tokens = ENCDEC_TRAIN_SEQ * ENCDEC_TRAIN_BATCH
    counts = {"xent": 0, "xent.partial": 0}
    runs = (("2x1", ["--baseline"], "xent", "xent.partial",
             [m["loss"] for m in one_device[:2]], WHISPER_MESH_RTOL,
             f"phase 3h's one-device steps 0-1 (vocab {full.vocab_size})"),
            ("1x2", [], "xent.partial", "xent", padded_losses, TP_LOSS_RTOL,
             f"one-device forwards of the padded config's seeded weights "
             f"(vocab {full.vocab_size} padded to {padded.vocab_size})"))
    for mesh, extra, kernel, other, ref, rtol, ref_text in runs:
        where = f"spmd: {ENCDEC_ARCH} mesh {mesh}"
        t0 = time.perf_counter()
        ranks = train_launcher.main(argv + extra + [
            "--mesh", mesh, "--ckpt-dir", str(WHISPER_MESH_DIR / mesh)])
        secs = time.perf_counter() - t0
        losses = check_launch_ranks(ranks, where, WHISPER_MESH_STEPS,
                                    kernel, other)
        counts[kernel] += sum(r["launches"][kernel] for r in ranks)
        cut = (", tensor-parallel (" + tp_cut(ranks, padded, where, "dec")
               + ")" if mesh == "1x2" else "")
        rel = [abs(losses[i] - ref[i]) / abs(ref[i]) for i in range(2)]
        if not max(rel) <= rtol:
            fail(f"{where}: steps 0-1 losses {losses[:2]} vs {ref}, "
                 f"{ref_text}: relative {rel} > {rtol:.3g}")
        step_ms = statistics.median(m["step_s"] for m in
                                    ranks[0]["metrics"][1:]) * 1e3
        prof, comm = ranks[0]["profile"], ranks[0]["comm"]
        print(f"{where} (data {mesh[0]}, model {mesh[2]}) on one card, bf16 "
              f"+ fp32 master, remat, batch {ENCDEC_TRAIN_BATCH} x seq "
              f"{ENCDEC_TRAIN_SEQ} against {full.n_frames} frames a row"
              + (f", layout policy {changes}" if not extra else
                 ", --baseline") + cut + f": losses {losses}, equal on both "
              f"ranks; steps 0-1 {losses[:2]} vs {ref}, {ref_text}: "
              f"relative {rel} (gate {rtol:.3g}); launches a rank "
              f"{ranks[0]['launches']}; {step_ms:.1f} ms a step (median of "
              f"steps 1-{WHISPER_MESH_STEPS - 1}, rank 0), "
              f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
              + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} "
                          f"GiB" for r in ranks)
              + f"; collectives on rank 0 {comm['calls']} calls, "
              f"{comm['bytes']} bytes, {comm['seconds'] * 1e3:.1f} ms on "
              f"the host's clock; {len(ranks[0]['digests'])} unsharded "
              f"leaves bit-equal on both ranks; {secs:.1f} s for the launch")
        print_profile(f"{ENCDEC_ARCH} train step rank 0 of {mesh}", prof)
    shutil.rmtree(WHISPER_MESH_DIR, ignore_errors=True)
    print(f"spmd: {ENCDEC_ARCH} on the two meshes took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def recurrent_cut(ranks: list[dict], cfg, where: str) -> str:
    """The gate on a tensor-parallel (1, 2) launch of the hybrid or ssm
    family: every rank's blocks hold its share of the recurrent heads and
    columns (zamba2's Mamba2 heads and ``d_inner``, and its shared block's
    attention heads and MLP columns; xlstm's mLSTM heads and ``d_inner``
    and its sLSTM heads and columns) and of the vocab rows.  Returns the
    shares as text."""
    m, d = 2, cfg.d_model
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        h = di // cfg.ssm_head_dim
        want = {"s00_mamba/mamba/wdt": (2, h // m, h),
                "s00_mamba/mamba/wz": (2, di // m, di),
                "shared_attn/attn/wq": (1, cfg.n_heads // m, cfg.n_heads),
                "shared_attn/mlp/wi": (1, cfg.d_ff // m, cfg.d_ff)}
        names = ("SSM heads", "d_inner columns", "shared-block heads",
                 "shared-block MLP columns")
    else:
        h = cfg.n_heads
        want = {"s00_mlstm/mlstm/wq": (1, h // m, h),
                "s00_mlstm/mlstm/wup_x": (2, 2 * d // m, 2 * d),
                "s01_slstm/slstm/r": (2, h // m, h),
                "s01_slstm/slstm/wx": (3, d // m, d)}
        names = ("mLSTM heads", "mLSTM d_inner columns", "sLSTM heads",
                 "sLSTM columns")
    want["embed"] = (0, cfg.vocab_size // m, cfg.vocab_size)
    for r in ranks:
        got = {k: r["state_shapes"][f"params/{k}"][dim]
               for k, (dim, _, _) in want.items()}
        if got != {k: n for k, (_, n, _) in want.items()}:
            fail(f"{where}: rank {r['rank']}'s blocks {got} are not its "
                 f"shares {want} of {cfg.name}")
    return ", ".join(f"{n} of {total} {name}" for (_, n, total), name in
                     zip(want.values(), names + ("vocab rows",)))


def recurrent_tp_phase() -> dict[str, int]:
    """Phase 3j: the hybrid and ssm families tensor-parallel at full width
    through the launcher, ``launch.train --mesh 1x2 --baseline`` on two
    ranks of the one card, bf16 with an fp32 master and remat, no
    checkpoints: zamba2-1.2b at ``RECURRENT_TP[...]`` layers (six Mamba2
    layers and the shared block) and xlstm-1.3b at eight (seven mLSTM, one
    sLSTM), ``RECURRENT_TP_STEPS`` steps of ``RECURRENT_TP_BATCH`` x
    ``RECURRENT_TP_SEQ`` tokens (across the SSD's and the mLSTM's
    256-token chunks) and one more profiled on rank 0.  Gates: every loss
    finite and equal on both ranks, B12 once a step and no B11; step 0's
    loss within ``TP_LOSS_RTOL`` of a one-device bf16 loss of the same
    seed's weights on the same batch, computed here first; each rank's
    blocks its share of the recurrent heads and columns
    (``recurrent_cut``); each rank's counters, zeroed just before its run
    and read just after, show the split B10 (zamba2, the mLSTM) or B9 (the
    sLSTM) stats and apply passes once a layer a forward (remat's
    recomputation a forward too) and no one-pass B10; the unsharded
    leaves bit-equal on both ranks.  Then xlstm-1.3b's cut again in fp32,
    one device against the (1, 2) mesh (``full_width_backward_check``):
    the witness that its bf16 step-0 gap is rounding.  Returns the
    launches summed over the ranks."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    tokens = RECURRENT_TP_SEQ * RECURRENT_TP_BATCH
    counts = {k: 0 for k in ("xent.partial", "rmsnorm.sumsq",
                             "rmsnorm.apply", "rmsnorm.gated.sumsq",
                             "rmsnorm.gated.apply")}
    for arch, layers in RECURRENT_TP.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        data = DataConfig(vocab_size=cfg.vocab_size,
                          seq_len=RECURRENT_TP_SEQ,
                          global_batch=RECURRENT_TP_BATCH,
                          d_model=cfg.d_model)
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init(SEED)
        batch = make_batch(data, 0)
        with torch.no_grad():
            one = float(model.loss(params, batch))
            # the same loss row by row: the model's own rounding spread at
            # other GEMM shapes, the yardstick of the mesh's (not gated)
            by_row = statistics.mean(
                float(model.loss(params, {k: v[i:i + 1]
                                          for k, v in batch.items()}))
                for i in range(RECURRENT_TP_BATCH))
        spread = abs(by_row - one) / abs(one)
        del model, params, batch
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - t0
        where = f"spmd: {arch} mesh 1x2"
        ckpt = RECURRENT_TP_DIR / arch
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.perf_counter()
        ranks = train_launcher.main([
            "--arch", arch, "--layers", str(layers), "--mesh", "1x2",
            "--baseline", "--steps", str(RECURRENT_TP_STEPS), "--seq-len",
            str(RECURRENT_TP_SEQ), "--global-batch", str(RECURRENT_TP_BATCH),
            "--ckpt-every", str(RECURRENT_TP_STEPS + 1), "--seed", str(SEED),
            "--ckpt-dir", str(ckpt)]
            # xlstm's profiled step is not taken, for phase 3k's seconds:
            # post-processing its 116,267 launches took about 30 s
            + (["--profile"] if arch == HYBRID_ARCH else []))
        secs = time.perf_counter() - t0
        shutil.rmtree(ckpt, ignore_errors=True)
        losses = check_launch_ranks(ranks, where, RECURRENT_TP_STEPS,
                                    "xent.partial", "xent")
        cut = recurrent_cut(ranks, cfg, where)
        rel = abs(losses[0] - one) / abs(one)
        if not rel <= TP_LOSS_RTOL:
            fail(f"{where}: step 0 loss {losses[0]!r} vs one device's "
                 f"{one!r}: relative {rel} > {TP_LOSS_RTOL}")
        forwards = RECURRENT_TP_STEPS * (2 if cfg.remat else 1)
        stages = dict(cfg.stages())
        want = {"gated": forwards * stages.get(
                    "mamba", stages.get("mlstm", 0)),
                "plain": forwards * stages.get("slstm", 0)}
        for r in ranks:
            got = r["launches"]
            split = {v: (got[f"rmsnorm.{v}.sumsq"], got[f"rmsnorm.{v}.apply"])
                     for v in want}
            if (any(split[v] != (n, n) for v, n in want.items())
                    or got["rmsnorm.gated"]):
                fail(f"{where}: rank {r['rank']} launches {got} (want the "
                     f"split passes {want} times, once a layer a forward, "
                     f"and no one-pass B10)")
        for v, name in (("plain", "rmsnorm"), ("gated", "rmsnorm.gated")):
            for p in ("sumsq", "apply"):
                counts[f"{name}.{p}"] += sum(
                    r["launches"][f"rmsnorm.{v}.{p}"] for r in ranks)
        counts["xent.partial"] += sum(r["launches"]["xent.partial"]
                                      for r in ranks)
        step_ms = statistics.median(m["step_s"] for m in
                                    ranks[0]["metrics"][1:]) * 1e3
        step_list = [round(m["step_s"] * 1e3, 1) for m in ranks[0]["metrics"]]
        prof, comm = ranks[0].get("profile"), ranks[0]["comm"]
        print(f"{where} (data 1, model 2) on one card, bf16 + fp32 master, "
              f"remat, {cfg.n_layers} layers {cfg.stages()}, batch "
              f"{RECURRENT_TP_BATCH} x seq {RECURRENT_TP_SEQ}, "
              f"tensor-parallel ({cut}): losses {losses}, equal on both "
              f"ranks; step 0 {losses[0]!r} vs one device's {one!r} "
              f"(relative {rel:.3g}, gate {TP_LOSS_RTOL}; one device's "
              f"own loss row by row {by_row!r}, relative {spread:.3g}); "
              f"launches a rank {ranks[0]['launches']}; {step_ms:.1f} ms a "
              f"step (median of steps 1-{RECURRENT_TP_STEPS - 1}, rank 0), "
              f"steps {step_list} ms, {tokens / step_ms * 1e3:.0f} tokens/s, "
              f"peak memory "
              + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} "
                          f"GiB" for r in ranks)
              + f"; collectives on rank 0 {comm['calls']} calls, "
              f"{comm['bytes']} bytes, {comm['seconds'] * 1e3:.1f} ms on "
              f"the host's clock over the run; "
              f"{len(ranks[0]['digests'])} unsharded leaves bit-equal on "
              f"both ranks; {secs:.1f} s for the launch, {one_s:.1f} s for "
              f"the one-device loss")
        if prof is not None:
            print_profile(f"{arch} train step rank 0 of 1x2", prof)
    shutil.rmtree(RECURRENT_TP_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    full_width_backward_check(XLSTM_ARCH, RECURRENT_TP[XLSTM_ARCH],
                              RECURRENT_TP_BATCH, RECURRENT_TP_SEQ)
    print(f"check: the fp32 xlstm-1.3b witness took "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"spmd: the hybrid and ssm launches took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def fsdp_phase() -> dict[str, int]:
    """Phase 3k: FSDP (ROADMAP A11.5).  qwen3-14b at full width, its depth
    cut to ``FSDP_LAYERS``, through ``launch.train --mesh 2x1`` on two
    ranks of the one card under its launchers' rules (``fsdp`` on), bf16
    with an fp32 master copy, remat on, ``FSDP_STEPS`` steps of
    ``FSDP_BATCH`` x ``FSDP_SEQ`` tokens and one more profiled on rank 0,
    the final save written by rank 0.  Gates: each rank's blocks of the
    parameters, the moments and the master copy hold half of every
    "embed" dim (the vocab whole); every loss finite and equal on both
    ranks; every step's loss within ``TP_LOSS_RTOL`` and every step's
    gradient norm within ``FSDP_NORM_RTOL`` of one-device bf16 train steps
    of the same seed's state and schedule on the same batches, run here
    once the ranks have exited, and step 1's update, which the final
    checkpoint's master copy holds, within ``FSDP_UPDATE_RTOL`` of one
    device's; the unsharded leaves (the norms' and the qk-norms' scales,
    the step) bit-equal on both ranks; B11 once a rank a
    step and no B12 (each rank's counters, zeroed just before its run and
    read just after); each rank's peak device memory below the replicated
    train state's bytes.  Returns the launches summed over the ranks."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.steps import init_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(FSDP_ARCH), n_layers=FSDP_LAYERS)
    if not cfg.fsdp:
        fail(f"fsdp: {FSDP_ARCH}'s config does not set fsdp")
    where = f"spmd: {FSDP_ARCH} mesh 2x1 FSDP"
    defs = build_model(cfg).param_defs()
    n_params = sum(math.prod(dfn.shape) for _, dfn in leaves(defs))
    # bf16 weights, and the fp32 master copy and two moments AdamW keeps
    replicated = n_params * (2 + 4 + 4 + 4)
    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    FSDP_DIR.mkdir(parents=True)
    free_before = shutil.disk_usage(FSDP_DIR).free
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    argv = ["--arch", FSDP_ARCH, "--mesh", "2x1", "--layers",
            str(FSDP_LAYERS), "--steps", str(FSDP_STEPS), "--seq-len",
            str(FSDP_SEQ), "--global-batch", str(FSDP_BATCH), "--ckpt-every",
            str(FSDP_STEPS + 1), "--seed", str(SEED), "--ckpt-dir",
            str(FSDP_DIR), "--profile"]
    ranks = train_launcher.main(argv)
    secs = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in FSDP_DIR.rglob("*")
                  if f.is_file())
    free_after = shutil.disk_usage(FSDP_DIR).free
    # the saved master copy of FSDP_UPDATE_LEAVES (the one-device layout)
    import numpy as np

    with np.load(FSDP_DIR / f"step_{FSDP_STEPS:08d}" / "shard_0.npz") as z:
        saved = {k: z[f"opt/master/{k}"] for k in FSDP_UPDATE_LEAVES}
    shutil.rmtree(FSDP_DIR)
    losses = check_launch_ranks(ranks, where, FSDP_STEPS, "xent",
                                "xent.partial")
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    hd = cfg.hd
    want = {"embed": (v, d // 2), "lm_head": (d // 2, v),
            "s00_dense/attn/wq": (FSDP_LAYERS, d // 2, cfg.n_heads, hd),
            "s00_dense/attn/wk": (FSDP_LAYERS, d // 2, cfg.n_kv_heads, hd),
            "s00_dense/attn/wo": (FSDP_LAYERS, cfg.n_heads, hd, d // 2),
            "s00_dense/mlp/wi": (FSDP_LAYERS, d // 2, f),
            "s00_dense/mlp/wg": (FSDP_LAYERS, d // 2, f),
            "s00_dense/mlp/wo": (FSDP_LAYERS, f, d // 2),
            "s00_dense/ln1/scale": (FSDP_LAYERS, d),
            "final_norm/scale": (d,)}
    for r in ranks:
        for part in ("params", "opt/m", "opt/v", "opt/master"):
            got = {k: r["state_shapes"][f"{part}/{k}"] for k in want}
            if got != want:
                fail(f"{where}: rank {r['rank']}'s {part} blocks {got}, "
                     f"want {want}")
        if not r["peak_bytes"] < replicated:
            fail(f"{where}: rank {r['rank']}'s peak device memory "
                 f"{r['peak_bytes']} B is not below the replicated train "
                 f"state's {replicated} B: the state is not sharded")

    # one device: the same seed's FSDP_LAYERS-layer state and the launcher's
    # schedule, the same steps, donated (one 26 GB state beside the step's
    # gradients)
    t0 = time.perf_counter()
    model = build_model(cfg)
    opt_cfg = AdamWConfig()
    state = init_train_state(model, opt_cfg, SEED)
    step_fn = make_train_step(model, opt_cfg,
                              train_launcher.schedule(
                                  train_launcher.parse_args(argv)),
                              donate=True)
    data = DataConfig(vocab_size=v, seq_len=FSDP_SEQ, global_batch=FSDP_BATCH,
                      d_model=d)
    master = {k: pick(state["opt"]["master"], k.split("/"))
              for k in FSDP_UPDATE_LEAVES}
    initial = {k: t.clone() for k, t in master.items()}
    one, one_norms = [], []
    for i in range(FSDP_STEPS):
        state, metrics = step_fn(state, make_batch(data, i))
        one.append(float(metrics["loss"]))
        one_norms.append(float(metrics["grad_norm"]))
    update = {}
    for k, w0 in initial.items():
        mine = master[k] - w0
        theirs = torch.from_numpy(saved[k]).to(w0.device) - w0
        size = float(torch.linalg.vector_norm(mine))
        update[k] = (float(torch.linalg.vector_norm(theirs - mine)) / size
                     if size > 0 else math.inf, size)
    del model, state, metrics, master, initial, saved
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, one)]
    if not max(rel) <= TP_LOSS_RTOL:
        fail(f"{where}: losses {losses} vs one device's {one}: relative "
             f"{rel} > {TP_LOSS_RTOL}")
    norms = [m["grad_norm"] for m in ranks[0]["metrics"]]
    norm_rel = [abs(a - b) / abs(b) for a, b in zip(norms, one_norms)]
    if not max(norm_rel) <= FSDP_NORM_RTOL:
        fail(f"{where}: gradient norms {norms} vs one device's {one_norms}: "
             f"relative {norm_rel} > {FSDP_NORM_RTOL}")
    if not max(r for r, _ in update.values()) <= FSDP_UPDATE_RTOL:
        fail(f"{where}: the saved master copy's update (relative difference"
             f", one device's norm) {update} is not one device's within "
             f"{FSDP_UPDATE_RTOL}")
    step_ms = statistics.median(m["step_s"] for m in
                                ranks[0]["metrics"][1:]) * 1e3
    tokens = FSDP_SEQ * FSDP_BATCH
    prof, comm = ranks[0]["profile"], ranks[0]["comm"]
    save = ranks[0]["saves"][-1]
    print(f"{where} (data 2, model 1) on one card, bf16 + fp32 master, "
          f"remat, {FSDP_LAYERS} of 40 layers, batch {FSDP_BATCH} x seq "
          f"{FSDP_SEQ}, backend {ranks[0]['backend']}, collective transport "
          f"{ranks[0]['transport']}, a reduce-scatter as "
          f"{ranks[0]['reduce_scatter_transport']}: a rank holds "
          f"{want['embed']} of the embedding, {want['lm_head']} of the "
          f"head, {want['s00_dense/attn/wq']} of wq, "
          f"{want['s00_dense/mlp/wi']} of wi and wg, "
          f"{want['s00_dense/mlp/wo']} of wo, and so of the moments and the "
          f"master copy; losses {losses}, equal on both ranks; vs one "
          f"device's train steps {one}: relative "
          f"{[f'{x:.3g}' for x in rel]} (gate {TP_LOSS_RTOL}); gradient "
          f"norms {norms} vs {one_norms}: relative "
          f"{[f'{x:.3g}' for x in norm_rel]} (gate {FSDP_NORM_RTOL:.3g}); "
          f"the saved master copy's update after {FSDP_STEPS} steps vs one "
          f"device's, relative difference (norm of one device's): "
          + ", ".join(f"{k} {r:.3g} ({n:.3g})" for k, (r, n) in update.items())
          + f" (gate {FSDP_UPDATE_RTOL}); launches a rank "
          f"{ranks[0]['launches']}; {len(ranks[0]['digests'])} unsharded "
          f"leaves bit-equal on both ranks")
    print(f"spmd: {FSDP_ARCH} FSDP {step_ms:.1f} ms a step (median of steps "
          f"1-{FSDP_STEPS - 1}, rank 0), {tokens / step_ms * 1e3:.0f} "
          f"tokens/s, steps "
          f"{[round(m['step_s'] * 1e3, 1) for m in ranks[0]['metrics']]} ms, "
          f"busy {prof['busy_ms'] / prof['wall_ms']:.1%} of the profiled "
          f"step; peak memory "
          + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 1e9:.2f} GB"
                      for r in ranks)
          + f" (a rank's FSDP state {replicated / 2 / 1e9:.2f} GB, the "
          f"replicated state {replicated / 1e9:.2f} GB, gate); collectives "
          f"a step (the profiled one) {prof['comm']['calls']} calls, "
          f"{prof['comm']['bytes'] / 1e9:.3f} GB, "
          f"{prof['comm']['seconds']:.1f} s on the host's clock; over the "
          f"run {comm['calls']} calls, {comm['bytes'] / 1e9:.3f} GB, "
          f"{comm['seconds']:.1f} s (the final save's gathers included); "
          f"the final save {save['seconds']:.1f} s, {written / 1e9:.2f} GB "
          f"written by rank 0, disk free {free_before / 1e9:.1f} GB before, "
          f"{free_after / 1e9:.1f} GB with it (deleted); {secs:.1f} s for "
          f"the launch, {one_s:.1f} s for the one-device steps")
    print_profile(f"{FSDP_ARCH} FSDP train step rank 0 of 2x1", prof)
    print(f"spmd: phase 3k took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ("xent", "rmsnorm")}


def measure_phase() -> None:
    """The measure phase (ROADMAP A7.2-A7.5), each step fatal:
    (a) ``measure.validate`` times every registry kernel's body at its plan
    on the main path's cells (``CARD_CASES``) inside a ``JsonlSink``
    session (the stream ``obs_report`` reads), fatal unless all fifteen
    are within their envelopes; (b) ``measure.sweep`` times each geometry
    of ``SWEEP_CELLS``, writes the profile, loads it back strictly and
    launches each cell under ``PlanContext.from_profile``, fatal unless the
    outputs equal the analytic plan's bit for bit and every cell's
    ``PlanEvent`` says ``cache="override"`` from ``profile:<path>``; then
    the profile of phase 3d's rank-local norm cell (``SPMD_PROFILE``,
    swept as one rank's shard of ``SPMD_MESH``, loaded back strictly)."""
    import torch

    from repro_torch import api, obs
    from repro_torch.api.context import use_context
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import parse_shape
    from repro_torch.measure import profile as profile_lib
    from repro_torch.measure import sweep as sweep_lib
    from repro_torch.measure import validate as validate_lib

    t_phase = time.perf_counter()
    shutil.rmtree(MEASURE_DIR, ignore_errors=True)
    label = validate_lib.device_label("cuda")

    # (a) validate over the card's cells, streamed
    with obs.session(obs.JsonlSink(OBS_DIR / "measure.jsonl")):
        records = validate_lib.validate_kernels(device="cuda")
    for r in records:
        print(f"measure: {validate_lib.hbm_line(r)}")
    bad = [r["kernel"] for r in records if r["status"] != "ok"]
    if sorted(r["kernel"] for r in records) != api.list_kernels() or bad:
        fail(f"measure: validate: {len(records)} records of "
             f"{len(api.list_kernels())} registry kernels, out of their "
             f"envelopes: {bad}")
    t_validate = time.perf_counter() - t_phase

    # (b) the sweep, its profile, and the profile replayed
    results = sweep_lib.sweep_cells(SWEEP_CELLS, device="cuda")
    path = str(MEASURE_DIR / "profile.json")
    profile_lib.save_profile(path, [r.entry() for r in results],
                             backend=label)
    ring = obs.RingBufferSink()
    with obs.session(ring):
        ctx = api.PlanContext.from_profile(path)          # strict
    for (kernel, shape, dtype), r in zip(SWEEP_CELLS, results):
        args, scalars = validate_lib.args_for(kernel, shape, dtype,
                                              device="cuda", seed=SEED)
        want = api.launch(kernel, *args, **scalars)
        with obs.session(ring), use_context(ctx):
            got = api.launch(kernel, *args, **scalars)
        if not torch.equal(got, want):
            fail(f"measure: {kernel} {shape} {dtype} under the profile "
                 f"differs from the analytic plan's output")
        seen = [e for e in ring.events("plan") if e.kernel == kernel
                and e.shape == r.shape]
        if not seen or any(e.cache != "override"
                           or e.source != f"profile:{path}" for e in seen):
            fail(f"measure: {kernel} {r.shape}: plan records "
                 f"{[(e.cache, e.source) for e in seen]} (want override "
                 f"from profile:{path})")
        geoms = ", ".join(f"block {c.plan.block_shape} "
                          f"{c.measured['ms']:.4f} ms"
                          for c in r.candidates)
        print(f"measure: sweep {kernel} {shape} {dtype}: {geoms}; best "
              f"block {r.best.plan.block_shape} "
              f"({'swept' if r.changed else 'the analytic'}); under "
              f"from_profile equal to the analytic plan's output bit for "
              f"bit, {len(seen)} plan record(s) cache=override from the "
              f"profile: ok")
    del args, want, got

    cfg = get_config(TRAIN_ARCH)
    mesh = dict(zip(("data", "model"), parse_shape(SPMD_MESH)))
    cell = ("rmsnorm", (TRAIN_SEQ * TRAIN_BATCH, cfg.d_model), cfg.adtype)
    r = sweep_lib.sweep_cell(*cell, ctx=api.current_context().evolve(
        mesh=mesh), device="cuda", local=True)
    profile_lib.save_profile(str(SPMD_PROFILE), [r.entry()], backend=label)
    pinned = profile_lib.load_profile(str(SPMD_PROFILE))
    print(f"measure: phase 3d's profile: {r.kernel} {r.shape} {r.dtype} as "
          f"one rank's shard of {mesh}: {len(r.candidates)} geometries, "
          f"best block {r.best.plan.block_shape} "
          f"({r.best.measured['ms']:.4f} ms), {len(pinned)} cell loaded "
          f"back strictly; validate {t_validate:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def measure_comm_check(ranks: list[list[dict]]) -> None:
    """Phase 3i's comm census (``measure.validate.validate_comm`` with the
    exposed check, ``HALO_COMM_CASES``), fatal unless every rank's records
    are ok; rank 0's stream into the measure phase's obs stream."""
    from repro_torch import obs
    from repro_torch.measure import validate as validate_lib

    bad = [(i, r["kernel"], r["check"]) for i, recs in enumerate(ranks)
           for r in recs if r["status"] != "ok"]
    if bad:
        fail(f"measure: comm census out of its envelope: {bad}")
    with obs.session(obs.JsonlSink(OBS_DIR / "measure.jsonl", append=True)):
        for r in ranks[0]:
            obs.emit(validate_lib.event_of(r))
    for r in ranks[0]:
        if r["check"] == "comm":
            print(f"measure: comm {r['kernel']} {tuple(r['shape'])} on "
                  f"{r['mesh']}, a rank's {tuple(r['local_shape'])}: wire "
                  f"{r['measured']['wire_bytes']:.0f} B against predicted "
                  f"{r['predicted']['comm_bytes']} B, ratio {r['ratio']}: ok")
        else:
            m = r["measured"]
            print(f"measure: exposed {r['kernel']}: "
                  f"{sum(c['overlappable'] for c in m['collectives'])}/"
                  f"{len(m['collectives'])} overlappable, exposed "
                  f"{m['exposed_wire_bytes']:.0f} B against predicted "
                  f"{r['predicted']['exposed_comm_bytes']} B at rank 0's "
                  f"rates {[f'{x / 1e9:.3f} GB/s' for x in m['rates']]}, "
                  f"ratio {r['ratio']}: ok")


def phase1_obs() -> None:
    """Phase 1's obs stream: ``scripts/torch_obs_smoke.py``'s sequence on
    the card (two ``api.launch("stream.scale")``, B2, and one ``plan_for``
    under a ``JsonlSink`` session), fatal unless the stream holds at least 3
    plan records with a miss and a hit and a launch with no session makes
    no sink call."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_obs_smoke import obs_smoke

    try:
        records = obs_smoke(OBS_DIR / "phase1.jsonl", "cuda")
    except RuntimeError as e:
        fail(str(e))
    caches = [r["cache"] for r in records if r["kind"] == "plan"]
    print(f"obs: phase 1: {len(records)} records {kind_counts(records)}, "
          f"plan caches {caches}; a launch with no session made no sink "
          f"call: ok")


def obs_report() -> None:
    """``python -m repro_torch.obs.report --fail-on-validation`` over the
    streams of phases 1, 3b, 3c, 3d and measure (its ``ValidationEvent``s,
    3i's comm census among them); fatal unless it exits 0.  Prints its
    summary, then deletes the streams."""
    import os

    paths = [str(OBS_DIR / f"{name}.jsonl")
             for name in ("phase1", "serve", "train", "spmd", "measure")]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report",
         "--fail-on-validation", *paths],
        capture_output=True, text=True, timeout=300, env=env)
    for line in out.stdout.splitlines():
        print(f"obs report: {line}")
    if out.returncode != 0:
        fail(f"obs report: exit {out.returncode}: {out.stderr.strip()}")
    print("obs report: python -m repro_torch.obs.report --fail-on-validation "
          "over the phase 1, 3b, 3c, 3d and measure streams exited 0: ok")
    shutil.rmtree(OBS_DIR)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.jacobi import kernel as jacobi_kernel
    from repro_torch.kernels.jacobi import ops as jacobi_ops
    from repro_torch.kernels.jacobi import ref as jacobi_ref
    from repro_torch.kernels.lbm import kernel as lbm_kernel
    from repro_torch.kernels.lbm import ops as lbm_ops
    from repro_torch.kernels.lbm import ref as lbm_ref
    from repro_torch.kernels.stream import kernel as stream_kernel
    from repro_torch.kernels.stream import ops as stream_ops
    from repro_torch.kernels.triad import kernel as triad_kernel
    from repro_torch.kernels.triad import ops as triad_ops
    from repro_torch.core.layout import hopper_limits
    from repro_torch.core.segmented import SegmentedArray
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.util import at_storage_offset, to_tiles
    from repro_torch.kernels.xent import kernel as xent_kernel

    # Full fp32 in the library yardstick's convolution (cuDNN would take
    # TF32 by default) and in any matmul.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. environment ---------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    try:
        bw, fp32_rate = datasheet(kind)
    except LookupError as e:
        fail(str(e))
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {kind}, nvidia-smi: {smi}")
    limits = hopper_limits()
    print(f"data sheet: {bw / 1e12} TB/s device memory, "
          f"{fp32_rate / 1e12} TFLOP/s fp32 (non-tensor); planner limits: "
          f"{limits.smem_per_cta} B shared memory per CTA, "
          f"{limits.sm_count} SMs")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    print(f"build: {sorted(built) or 'cached'} for sm_90a in {secs:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    print(f"build: ptxas registers and spill-store bytes per source: "
          + str({k: {"registers": [e["registers"] for e in v],
                     "spill_bytes": sum(e["spill_bytes"] for e in v)}
                 for k, v in _build.PTXAS.items()}))
    # the two kernels redesigned for Hopper: each instantiation's registers,
    # static shared memory and spills
    for source in ("stream", "rmsnorm"):
        for e in _build.PTXAS.get(source, []):
            print(f"build: {source}: {e['kernel'][:120]}: {e['registers']} "
                  f"registers, {e['smem']} B static shared memory, "
                  f"{e['spill_bytes']} B spill stores")

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    # the obs bus on the card: scripts/torch_obs_smoke.py's sequence
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    timed("1 obs", phase1_obs)

    # ---- 3. the main path ----------------------------------------------
    counters = {
        "stream.copy": (stream_kernel.LAUNCHES, "copy"),
        "stream.scale": (stream_kernel.LAUNCHES, "scale"),
        "stream.add": (stream_kernel.LAUNCHES, "add"),
        "stream.triad": (stream_kernel.LAUNCHES, "triad"),
        "triad": (triad_kernel.LAUNCHES, "triad"),
        "jacobi": (jacobi_kernel.LAUNCHES, "jacobi"),
        "lbm.soa": (lbm_kernel.LAUNCHES, "soa"),
        "lbm.ivjk": (lbm_kernel.LAUNCHES, "ivjk"),
    }
    for table, key in counters.values():
        table[key] = 0

    def run_stream_ops(n, dtype, seed):
        a, b, c = stream_ops.random_vectors(n, 3, dtype, seed=seed)
        cases = {
            "stream.copy": ((a,), {}),
            "stream.scale": ((a,), {"s": SCALAR}),
            "stream.add": ((a, b), {}),
            "stream.triad": ((a, b), {"s": SCALAR}),
            "triad": ((a, b, c), {}),
        }
        for name, (args, kw) in cases.items():
            out = api.launch(name, *args, **kw)
            check_close(f"{name} n={n} {dtype}", out, api.ref(name, *args, **kw),
                        *tol(dtype))
            plain = (triad_kernel.plain(*args) if name == "triad" else
                     stream_kernel.plain(name.removeprefix("stream."), args,
                                         kw.get("s")))
            check_close(f"{name} n={n} {dtype} vs its plain version", out,
                        plain, 0.0, 0.0)
            del out, plain
        torch.cuda.synchronize()
        print(f"main: stream copy/scale/add/triad + triad n={n} {dtype}: "
              f"within tolerance of the oracle, bit-exact against the plain "
              f"versions: ok")

    run_stream_ops(N, torch.float32, 0)
    run_stream_ops(N, torch.bfloat16, 1)
    run_stream_ops(N_RAGGED, torch.float32, 2)

    b, c, d = stream_ops.random_vectors(N, 3, torch.float32, seed=3)
    want = api.ref("triad", b, c, d)
    for p in PHASES:
        phases = (p, 2 * p, 3 * p)
        out = triad_ops.vector_triad_phased(b, c, d, phases=phases)
        check_close(f"vector_triad_phased {phases}", out, want, 0.0, 0.0)
    del out, want
    print(f"main: vector_triad_phased n={N} fp32 at phases (p, 2p, 3p), "
          f"p = {PHASES.start}..{PHASES.stop - 1}: bit-exact: ok")

    grid = jacobi_ops.init_grid(GRID, GRID, torch.float32, seed=4)
    check_close("jacobi one sweep", api.launch("jacobi", grid),
                jacobi_ref.jacobi_step(grid), *tol(torch.float32))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    swept = jacobi_ops.jacobi_sweeps(grid, SWEEPS)
    end.record()
    end.synchronize()
    sweeps_ms = start.elapsed_time(end)
    mlups = jacobi_ops.mlups(GRID, GRID, sweeps_ms / 1e3, SWEEPS)
    check_close(f"jacobi_sweeps x{SWEEPS}", swept,
                jacobi_ref.jacobi_sweeps(grid, SWEEPS), *tol(torch.float32))
    del swept
    print(f"main: jacobi_sweeps {GRID}x{GRID} fp32 x{SWEEPS}: "
          f"{sweeps_ms:.3f} ms, {mlups:.1f} MLUP/s (incl. the copy-in): ok")

    def lattice(n, dtype, seed):
        """The equilibrium shear flow with a +-2.5 % seeded perturbation,
        made on the card."""
        f = lbm_ops.init_equilibrium(n)
        gen = torch.Generator(device=f.device).manual_seed(seed)
        noise = torch.rand(f.shape, generator=gen, device=f.device)
        return (f * (1 + 0.05 * (noise - 0.5))).to(dtype)

    step_ms = {}
    for n in LBM_SIZES:
        f = lattice(n, torch.float32, n)
        want = f
        for _ in range(LBM_STEPS):
            want = lbm_ref.lbm_step(want, OMEGA)
        for layout in ("soa", "ivjk"):
            lbm_ops.lbm_run(f, OMEGA, 1, layout=layout)   # warm-up
            torch.cuda.synchronize()
            start.record()
            got = lbm_ops.lbm_run(f, OMEGA, LBM_STEPS, layout=layout)
            end.record()
            end.synchronize()
            step_ms[layout, n] = start.elapsed_time(end) / LBM_STEPS
            # multi-step tolerance of tests/test_kernels.py
            check_close(f"lbm_run {layout} N={n} x{LBM_STEPS}", got, want,
                        2e-4, 1e-6)
            print(f"main: lbm_run {layout} N={n} fp32 x{LBM_STEPS}: "
                  f"{step_ms[layout, n]:.3f} ms a step, "
                  f"{n ** 3 / step_ms[layout, n] / 1e3:.1f} MLUP/s "
                  f"(propagation and layout copies included): ok")
            del got
        del f, want

    sb, sc, sd = stream_ops.random_vectors(N, 3, torch.float32, seed=8)
    segs = [SegmentedArray.from_flat(v, SEGMENTS, align=128, shift=16)
            for v in (torch.zeros_like(sb), sb, sc, sd)]
    check_close("vector_triad_segmented vs flat triad",
                triad_ops.vector_triad_segmented(*segs).to_flat(),
                api.launch("triad", sb, sc, sd), 0.0, 0.0)
    print(f"main: vector_triad_segmented n={N} fp32, {SEGMENTS} segments, "
          f"phases {segs[0].phases}: equal to the flat triad: ok")

    timed("measure", measure_phase)
    serve_launches, serve_one = timed("3b", serving_phase)
    serve_mesh_launches = timed("3l", serve_mesh_phase, serve_one)
    del serve_one
    flash_launches = timed("3m", serve_flash_phase)
    train_launches, train_metrics = timed("3c", training_phase)
    spmd_launches = timed("3d", spmd_phase, train_metrics)
    recurrent_launches = timed("3j", recurrent_tp_phase)
    fsdp_launches = timed("3k", fsdp_phase)
    hybrid_launches = timed("3e", hybrid_phase)
    xlstm_launches = timed("3f", xlstm_phase)
    moe_launches = timed("3g", moe_phase)
    multimodal_launches, whisper_metrics = timed("3h", multimodal_phase)
    whisper_mesh_launches = timed("3d whisper", whisper_mesh_phase,
                                  whisper_metrics)
    del grid            # the ranks hold the grids of phase 3i
    halo_launches, halo_results = timed("3i", halo_phase)
    timed("obs report", obs_report)
    print(f"main: seconds a phase {phase_s}")
    grid = jacobi_ops.init_grid(GRID, GRID, torch.float32, seed=4)
    launches = {name: table[key] for name, (table, key) in counters.items()}
    launches.update(serve_launches)
    launches["rmsnorm"] += train_launches["rmsnorm"]
    launches["xent"] = train_launches["xent"]
    launches.update(spmd_launches)
    for phase in (hybrid_launches, xlstm_launches, moe_launches,
                  multimodal_launches, whisper_mesh_launches,
                  recurrent_launches, fsdp_launches, halo_launches,
                  serve_mesh_launches, flash_launches):
        for name, count in phase.items():
            launches[name] = launches.get(name, 0) + count
    print(f"main: launches {launches}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # ---- 4. kernels against their plain versions ------------------------
    def tiles(name, n, dtype, count, seed):
        plan = api.plan_for(name, (n,), dtype)
        xs = stream_ops.random_vectors(n, count, dtype, seed=seed)
        return plan, [to_tiles(x, plan)[0] for x in xs]

    # STREAM and both triads compute in fp32 with explicitly rounded
    # multiplies and adds (no FMA contraction) and round once to the
    # dtype, as their plain versions do: bit-exact at fp32 and bf16.
    # Jacobi rounds at most once: bit-exact.
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "" if dtype == torch.float32 else ".bf16"
        for name, op, count, s in [
            ("stream.copy", "copy", 1, None),
            ("stream.scale", "scale", 1, SCALAR),
            ("stream.add", "add", 2, None),
            ("stream.triad", "triad", 2, SCALAR),
        ]:
            plan, xs = tiles(name, N, dtype, count, 5)
            wrapper = getattr(stream_kernel, f"{op}2d")
            args = (*xs, s) if s is not None else tuple(xs)
            cases[name + suffix] = dict(
                kernel=lambda w=wrapper, a=args, p=plan: w(*a, brows=p.block_rows),
                plain=lambda o=op, x=xs, s=s: stream_kernel.plain(o, x, s),
                exact=True, dtype=dtype, bytes=plan.predicted_hbm_bytes,
                ops={"copy": 0, "scale": 1, "add": 1, "triad": 2}[op] * N,
                library={"copy": lambda x=xs: torch.clone(x[0]),
                         "scale": lambda x=xs: torch.mul(x[0], SCALAR),
                         "add": lambda x=xs: torch.add(x[0], x[1]),
                         "triad": lambda x=xs: torch.add(x[0], x[1], alpha=SCALAR),
                         }[op])
        plan, xs = tiles("triad", N, dtype, 3, 6)
        cases["triad" + suffix] = dict(
            kernel=lambda x=xs, p=plan: triad_kernel.triad2d(*x, brows=p.block_rows),
            plain=lambda x=xs: triad_kernel.plain(*x),
            exact=True, dtype=dtype, bytes=plan.predicted_hbm_bytes, ops=2 * N,
            library=lambda x=xs: torch.addcmul(*x))

    def lbm_case(n, dtype, layout):
        """The collision at the main path's shape: the propagated lattice
        laid out by the plan (the input a step hands the kernel)."""
        f = lattice(n, dtype, n + 1)
        plan = api.plan_for(f"lbm.{layout}", f.shape, dtype)
        flat, s = lbm_ops._flatten_pad(lbm_ref.propagate(f), plan)
        if layout == "soa":
            x = flat
        else:
            lanes = plan.padded_shape[2]
            x = flat.view(19, -1, lanes).transpose(0, 1).contiguous()

        def run():
            if layout == "soa":
                return lbm_kernel.collide_soa(x, OMEGA, bs=plan.block_cols)
            return lbm_kernel.collide_ivjk(x, OMEGA, bsb=plan.block_rows)

        def logical(y):
            axis = lbm_kernel.V_AXIS[layout]
            return y.movedim(axis, 0).reshape(19, -1)[:, :s]

        sites = x.numel() // 19
        return dict(
            kernel=lambda: logical(run()),
            plain=lambda: logical(lbm_kernel.plain(x, OMEGA, layout)),
            exact=True, dtype=dtype, bytes=plan.predicted_hbm_bytes,
            ops=lbm_kernel.OPS_PER_SITE * sites, library=None,
            # timed without the logical-site slice
            run=run, plain_run=lambda: lbm_kernel.plain(x, OMEGA, layout))

    for layout in ("soa", "ivjk"):
        cases[f"lbm.{layout}"] = lbm_case(LBM_SIZES[0], torch.float32, layout)
        cases[f"lbm.{layout}.bf16"] = lbm_case(LBM_BF16_N, torch.bfloat16,
                                               layout)
    def rms_case(shape, dtype, gated, seed):
        """A norm at a main-path shape, through the wrapper as
        ``api.launch`` calls it (the scale in x's dtype)."""
        rows, d = shape
        name = "rmsnorm.gated" if gated else "rmsnorm"
        plan = api.plan_for(name, shape, dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x, z = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        s = (torch.randn(d, generator=gen, device="cuda") + 1).to(dtype)

        def run():
            if gated:
                return rms_kernel.gated_rmsnorm2d(x, z, s, d_logical=d,
                                                  brows=plan.block_rows)
            return rms_kernel.rmsnorm2d(x, s, d_logical=d,
                                        brows=plan.block_rows)

        def plain():
            return rms_kernel.plain(x, s, d, 1e-6, z if gated else None)

        def library():
            return F.rms_norm(x, (d,), weight=s, eps=1e-6)

        # bytes: x (and z) read once, y written once, the scale read once
        # (the planner's count); squares, sums and two scalings an element,
        # and for the gate a sigmoid (exp, add, divide) and two products more
        return dict(kernel=run, plain=plain, exact=False, dtype=dtype,
                    bytes=plan.predicted_hbm_bytes,
                    ops=(9 if gated else 4) * rows * d,
                    library=None if gated else library)

    # B9 at the decode shape (the JSON row: most launches) and the prefill
    # shape; B10 at (2048, 4096).  bf16 is the serving dtype.
    for dtype in (torch.bfloat16, torch.float32):
        suffix = "" if dtype == torch.bfloat16 else ".fp32"
        cases["rmsnorm" + suffix] = rms_case((SERVE_SLOTS, 2560), dtype,
                                             False, 10)
        cases["rmsnorm.prefill" + suffix] = rms_case(
            (PREFILL_B * PREFILL_S, 2560), dtype, False, 11)
        cases["rmsnorm.gated" + suffix] = rms_case(GATED_SHAPE, dtype, True,
                                                   12)
    # zamba2-1.2b's rows (phase 3e), bf16: B9 at its decode (8, 2048) and
    # prefill (2048, 2048) shapes, B10 at its decode (8, 4096) shape (its
    # prefill shape is GATED_SHAPE)
    cases["rmsnorm.zamba2"] = rms_case((SERVE_SLOTS, 2048), torch.bfloat16,
                                       False, 17)
    cases["rmsnorm.prefill.zamba2"] = rms_case(
        (PREFILL_B * PREFILL_S, 2048), torch.bfloat16, False, 18)
    cases["rmsnorm.gated.zamba2"] = rms_case((SERVE_SLOTS, 4096),
                                             torch.bfloat16, True, 19)
    # xlstm-1.3b's sLSTM output norm (phase 3f): B9 on fp32 rows of its
    # d_model with the scale in fp32, at the decode (8, 2048) and prefill
    # (2048, 2048) shapes; its bf16 rows and B10's are zamba2's shapes above
    cases["rmsnorm.xlstm.fp32"] = rms_case((SERVE_SLOTS, 2048),
                                           torch.float32, False, 20)
    cases["rmsnorm.prefill.xlstm.fp32"] = rms_case(
        (PREFILL_B * PREFILL_S, 2048), torch.float32, False, 21)
    # qwen3-moe-30b-a3b's ln1 and ln2 (phase 3g), bf16: B9 at its decode
    # (8, 2048) and prefill (2048, 2048) shapes (zamba2's shapes, other
    # inputs)
    cases["rmsnorm.moe"] = rms_case((SERVE_SLOTS, 2048), torch.bfloat16,
                                    False, 22)
    cases["rmsnorm.prefill.moe"] = rms_case((PREFILL_B * PREFILL_S, 2048),
                                            torch.bfloat16, False, 23)
    # pixtral-12b's ln1, ln2 and final norm (phase 3h), bf16: B9 at its
    # decode (8, 5120) and its prefix prefill's (4 x 1536, 5120) shapes
    cases["rmsnorm.pixtral"] = rms_case((SERVE_SLOTS, 5120), torch.bfloat16,
                                        False, 24)
    # phase 3l's rows (serving on a (2, 2) mesh): a rank's 4 of the 8
    # slots at Qwen3-4B's d_model, bf16
    cases["rmsnorm.mesh"] = rms_case((SERVE_SLOTS // 2, 2560),
                                     torch.bfloat16, False, 38)
    # phase 3m's rows (flash decoding on a (1, 4) mesh): every slot on
    # each rank at Qwen2-0.5B's d_model, bf16
    cases["rmsnorm.flash"] = rms_case((SERVE_SLOTS, 896), torch.bfloat16,
                                      False, 39)
    cases["rmsnorm.prefill.pixtral"] = rms_case(
        (PREFILL_B * (1024 + VLM_PREFILL_S), 5120), torch.bfloat16, False,
        25)
    def split_case(shape, dtype, sdtype, gated, seed, parts=2):
        """The split norm's stats and apply passes on a tensor-parallel
        rank's block of ``shape`` (one of ``parts`` ranks' column blocks
        of a row), through the wrappers as ``api.launch`` calls them, the
        apply pass with the whole row's width and the statistic of a whole
        row (the block's, times ``parts``)."""
        rows, d = shape
        name = "rmsnorm.gated" if gated else "rmsnorm"
        plan = api.plan_for(f"{name}.sumsq", shape, dtype)
        aplan = api.plan_for(f"{name}.apply", shape, dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x, z = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        s = (torch.randn(d, generator=gen, device="cuda") + 1).to(sdtype)
        zz = z if gated else None
        ss = parts * rms_kernel.plain_sumsq(x, d, zz)
        d_total = parts * d

        def stats():
            if gated:
                return rms_kernel.gated_sumsq2d(x, z, d_logical=d,
                                                brows=plan.block_rows)
            return rms_kernel.sumsq2d(x, d_logical=d, brows=plan.block_rows)

        def apply():
            if gated:
                return rms_kernel.gated_apply2d(x, z, s, ss, d_logical=d,
                                                d_total=d_total,
                                                brows=aplan.block_rows)
            return rms_kernel.apply2d(x, s, ss, d_logical=d, d_total=d_total,
                                      brows=aplan.block_rows)

        # the gated bf16 statistic: the kernel's fast silu may round a gate
        # to the neighbouring bf16 value where the plain version's exact
        # sigmoid does not, moving that square by 2^-7 of it (1.2e-5 of a
        # row's sum at the largest, tests/test_torch_cuda.py); 1e-4 is
        # eight times that and below one element's share of a 2048-wide
        # row's sum (about 5e-4), so a dropped or doubled element fails
        stats_tol = (1e-4 if gated and dtype == torch.bfloat16 else 1e-5,
                     1e-6)
        # bytes, the planner's: stats, x (and z) read once, the fp32
        # statistic written once; apply, x (and z) read again, the scale and
        # the statistic read, y written.  Squares and sums an element (and
        # the gate's five operations); two scalings an element (and the
        # gate's)
        return {
            f"{name}.sumsq": dict(
                kernel=stats, plain=lambda: rms_kernel.plain_sumsq(x, d, zz),
                exact=False, dtype=dtype, tol=stats_tol,
                bytes=plan.predicted_hbm_bytes,
                ops=(7 if gated else 2) * rows * d,
                # an fp32 row's sum of squares is one call; nothing gates
                library=(lambda: torch.linalg.vecdot(x, x, dim=-1))
                if not gated and dtype == torch.float32 else None),
            f"{name}.apply": dict(
                kernel=apply, plain=lambda: rms_kernel.plain(
                    x, s, d, 1e-6, zz, ss=ss, d_total=d_total),
                exact=False, dtype=dtype, bytes=aplan.predicted_hbm_bytes,
                ops=(7 if gated else 2) * rows * d, library=None)}

    # the split passes at the (1, 2) ranks' blocks of phase 3j: a zamba2
    # rank's (2048, 2048) bf16 half of a (2048, 4096) Mamba2 row (the JSON
    # rows of B10's passes), an mLSTM rank's the same, and an sLSTM rank's
    # (2048, 1024) fp32 half of a row of 2048 with the scale in fp32 (B9's);
    # the one-pass norms of the whole rows are rmsnorm.gated and
    # rmsnorm.prefill.xlstm.fp32
    rank_rows = PREFILL_B * PREFILL_S
    cases.update(split_case((rank_rows, 2048), torch.bfloat16,
                            torch.bfloat16, True, 33))
    cases.update({f"{k}.mlstm": v for k, v in split_case(
        (rank_rows, 2048), torch.bfloat16, torch.bfloat16, True,
        34).items()})
    cases.update(split_case((rank_rows, 1024), torch.float32, torch.float32,
                            False, 35))
    # the split passes at a (1, 2) rank's decode rows (serving on a mesh,
    # ROADMAP A11.5): a zamba2 rank's bf16 (8, 2048) half of a Mamba2 row
    # and an sLSTM rank's fp32 (8, 1024); launch-bound, as decode rows are
    cases.update({f"{k}.decode": v for k, v in split_case(
        (SERVE_SLOTS, 2048), torch.bfloat16, torch.bfloat16, True,
        36).items()})
    cases.update({f"{k}.decode": v for k, v in split_case(
        (SERVE_SLOTS, 1024), torch.float32, torch.float32, False,
        37).items()})

    def xent_case(t, v, logical_v, dtype, seed, offset=0):
        """B11 at a main-path shape, through the wrapper as ``_launch_xent``
        calls it: per-token NLL of (t, v) logits (3 x N(0, 1)) over the
        first ``logical_v`` columns, labels in [0, logical_v), read where
        they lie (at any width, and at storage offset ``offset``)."""
        plan = api.plan_for("xent", (t, v), dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = at_storage_offset((3 * torch.randn(
            (t, v), generator=gen, device="cuda")).to(dtype), offset)
        labels = torch.randint(0, logical_v, (t,), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels64 = labels.to(torch.int64)

        def run():
            return xent_kernel.xent_nll(x, labels, logical_v=logical_v,
                                        brows=plan.block_rows)

        # bytes: the logits read once, the labels read and the NLL written
        # once (the planner's count); a max, a subtract, an exp and an add
        # an element
        return dict(kernel=run,
                    plain=lambda: xent_kernel.plain(x, labels, logical_v),
                    exact=False, dtype=dtype, tol=(1e-5, 1e-5),
                    bytes=plan.predicted_hbm_bytes, ops=4 * t * v,
                    library=(lambda: F.cross_entropy(x, labels64))
                    if logical_v == v else None)

    # B11 at the training step's (4096, 151936) fp32 logits, and bf16 logits
    # of a padded vocab (logical_v < width)
    cases["xent"] = xent_case(TRAIN_SEQ * TRAIN_BATCH, 151936, 151936,
                              torch.float32, 13)
    cases["xent.ragged.bf16"] = xent_case(*XENT_RAGGED, torch.bfloat16, 14)
    # B11 at whisper-tiny's training shape (phase 3h) on the caller's
    # unpadded logits, rows of no whole number of 16-B vectors, in fp32 (its
    # loss) and bf16; at minicpm-2b's vocab; and on a view at storage
    # offset 1
    n_whisper = ENCDEC_TRAIN_SEQ * ENCDEC_TRAIN_BATCH
    cases["xent.whisper"] = xent_case(n_whisper, 51865, 51865, torch.float32,
                                      26)
    cases["xent.whisper.bf16"] = xent_case(n_whisper, 51865, 51865,
                                           torch.bfloat16, 27)
    cases["xent.minicpm"] = xent_case(*XENT_MINICPM, torch.float32, 28)
    cases["xent.offset"] = xent_case(n_whisper, 51865, 51865, torch.float32,
                                     29, offset=1)

    def xent_partial_case(t, width, vl, off, lv, dtype, seed, offset=0):
        """B12 at a vocab shard of the mesh path, through the wrapper as
        ``_spmd_xent`` calls it: (m, l, ll) of (t, width) logits (3 x N(0,
        1)) at global offset ``off``, labels anywhere in [0, lv), read
        where they lie (at storage offset ``offset``)."""
        plan = api.plan_for("xent", (t, vl), dtype, local=True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = at_storage_offset((3 * torch.randn(
            (t, width), generator=gen, device="cuda")).to(dtype), offset)
        labels = torch.randint(0, lv, (t,), generator=gen, device="cuda",
                               dtype=torch.int32)

        def run():
            return xent_kernel.xent_partials(x, labels, vl=vl, off=off,
                                             logical_v=lv,
                                             brows=plan.block_rows)

        # the shard's logits read once, the labels read and three fp32
        # partials written once (counted here: the "xent" plan prices the
        # one-pass NLL's output); a max, a subtract, an exp and an add an
        # element
        return dict(kernel=run,
                    plain=lambda: xent_kernel.plain_partials(
                        x, labels, vl=vl, off=off, logical_v=lv),
                    check=lambda got, want: check_partials(
                        f"xent.partial ({t}, {width}) off {off}", got, want,
                        dtype),
                    exact=False, dtype=dtype,
                    bytes=t * width * dtype.itemsize + 4 * t + 12 * t,
                    ops=4 * t * width, library=None,
                    nearest=lambda: torch.logsumexp(x.float(), -1))

    # B12 at the mesh's (4096, 75968) fp32 shard, the second of two (the
    # JSON row), and a ragged bf16 shard
    vshard = 151936 // 2
    cases["xent.partial"] = xent_partial_case(
        TRAIN_SEQ * TRAIN_BATCH, vshard, vshard, vshard, 151936,
        torch.float32, 15)
    cases["xent.partial.ragged.bf16"] = xent_partial_case(
        *XENT_PARTIAL_RAGGED, torch.bfloat16, 16)
    cases["xent.partial.offset"] = xent_partial_case(
        TRAIN_SEQ * TRAIN_BATCH, vshard, vshard, vshard, 151936,
        torch.float32, 30, offset=1)
    # whisper-tiny's mesh shapes (phase 3d): B11 on a (2, 1) rank's 4 of
    # the 8 rows, and B12 on a (1, 2) rank's second half of the padded
    # vocab, the logical vocab ending inside it
    from repro_torch.configs import get_config

    cases["xent.whisper.rows"] = xent_case(n_whisper // 2, 51865, 51865,
                                           torch.float32, 31)
    wshard = get_config(ENCDEC_ARCH).padded_for_mesh(2)[0].vocab_size // 2
    cases["xent.partial.whisper"] = xent_partial_case(
        n_whisper, wshard, wshard, wshard, 51865, torch.float32, 32)
    jplan = api.plan_for("jacobi", (GRID - 2, GRID), torch.float32)
    jsrc = jacobi_ops.pitched(grid, jplan)
    jdst = torch.empty_like(jsrc)
    weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                           [0.0, 0.25, 0.0]], device=grid.device)[None, None]
    # the F.conv2d yardsticks run in fp32 (``conv=True``: the time line
    # prints cuDNN's TF32 setting), the arithmetic B6 does
    cases["jacobi"] = dict(
        kernel=lambda: jacobi_kernel.sweep(jsrc, jdst, n_cols=GRID,
                                           block=jplan.block_shape),
        plain=lambda: jacobi_kernel.plain(jsrc, torch.empty_like(jsrc), GRID),
        exact=True, dtype=torch.float32, bytes=jplan.predicted_hbm_bytes,
        ops=4 * (GRID - 2) * (GRID - 2),
        library=lambda: F.conv2d(grid[None, None], weight), conv=True)
    # B6 on a 3-row slab of the grid, in its own plan's tiles, and the
    # boundary launches of phase 3i's shard bodies: B6's row entry on three
    # rows where they lie (the mesh's boundary row), B7 on a rank's two
    # boundary planes at N = 256; no plan has these launches' shapes, so
    # their bytes are counted here
    slab = jacobi_ops.pitched(grid[GRID // 2 - 1:GRID // 2 + 2], jplan)
    sblock = api.plan_for("jacobi", (1, GRID), torch.float32).block_shape
    cases["jacobi.slab"] = dict(
        kernel=lambda: jacobi_kernel.sweep(slab, torch.empty_like(slab),
                                           n_cols=GRID, block=sblock),
        plain=lambda: jacobi_kernel.plain(slab, torch.empty_like(slab), GRID),
        exact=True, dtype=torch.float32, bytes=2 * 3 * GRID * 4,
        ops=4 * (GRID - 2), library=lambda: F.conv2d(slab[None, None], weight),
        conv=True)
    halo = grid[GRID // 2 - 1].clone()
    row_out = torch.empty_like(slab[1])
    cases["jacobi.row"] = dict(
        kernel=lambda: jacobi_kernel.sweep_row(halo, slab[1], slab[2], row_out,
                                               n_cols=GRID),
        plain=lambda: jacobi_kernel.plain_row(halo, slab[1], slab[2],
                                              torch.empty_like(row_out), GRID),
        exact=True, dtype=torch.float32, bytes=4 * GRID * 4,
        ops=4 * (GRID - 2), library=lambda: F.conv2d(slab[None, None], weight),
        conv=True)
    planes = lattice(LBM_SIZES[0], torch.float32, 7)[:, :2].reshape(
        19, -1).contiguous()
    cases["lbm.soa.slab"] = dict(
        kernel=lambda: lbm_kernel.collide_soa(planes, OMEGA),
        plain=lambda: lbm_kernel.plain(planes, OMEGA, "soa"),
        exact=True, dtype=torch.float32, bytes=2 * planes.numel() * 4,
        ops=lbm_kernel.OPS_PER_SITE * planes.shape[1], library=None)

    errors = {}
    for name, case in cases.items():
        got = case["kernel"]()
        want = case["plain"]()
        # the LBM gate is tests/test_kernels.py's one-step tolerance
        # (fp32 rtol 2e-5 / atol 1e-7, bf16 2e-2); bit-exact is expected
        gate = ((2e-2, 2e-2) if case["dtype"] == torch.bfloat16 else
                (2e-5, 1e-7)) if name.startswith("lbm") else (0.0, 0.0)
        rtol, atol = case.get("tol") or (
            gate if case["exact"] else tol(case["dtype"]))
        if "check" in case:
            errors[name] = case["check"](got, want)
            gate_text = (f"m and ll exact, l rtol "
                         f"{1e-5 if case['dtype'] == torch.float32 else 2e-2}")
        else:
            errors[name] = check_close(f"{name} kernel vs plain", got, want,
                                       rtol, atol)
            gate_text = f"rtol {rtol} atol {atol}"
        print(f"check: {name} kernel vs plain: max abs err {errors[name]:.3g} "
              f"(tolerance {gate_text})")
        del got, want
    torch.cuda.synchronize()

    # ---- 5. times -------------------------------------------------------
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    time_ms(cases["triad"]["kernel"], samples=20)   # warm-up, discarded
    times = {}
    for name, case in cases.items():
        bound_bytes = case["bytes"] / bw * 1e3
        bound_ops = case["ops"] / fp32_rate * 1e3
        library = case["library"]
        kernel = case.get("run", case["kernel"])
        # in turns, kernel and library each timed before and after the
        # other: a drift of the card's clocks falls on both alike
        k1 = time_ms(kernel)
        l1 = None if library is None else time_ms(library)
        plain_ms = time_ms(case.get("plain_run", case["plain"]))
        l2 = None if library is None else time_ms(library)
        k2 = time_ms(kernel)
        times[name] = {
            "ms": (k1 + k2) / 2,
            "plain_ms": plain_ms,
            "library_ms": None if library is None else (l1 + l2) / 2,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }
        t = times[name]
        base = name.removesuffix(".decode").removesuffix(".zamba2")
        base = base.removesuffix(".mlstm").removesuffix(".bf16")
        base = base.removesuffix(".fp32").removesuffix(".slab")
        base = base.replace(".prefill", "")
        if base.startswith("xent.partial"):
            base = "xent.partial"
        if "nearest" in case:
            lib = (f"none; nearest {time_ms(case['nearest']):.4f} ms "
                   f"({NEAREST[base]})")
        else:
            lib = (f"{t['library_ms']:.4f} ms" if library is not None else
                   f"none ({NO_LIBRARY[base]})")
            if case.get("conv"):
                lib += (f" (cudnn.allow_tf32="
                        f"{torch.backends.cudnn.allow_tf32})")
        ratio = (f"kernel/library {t['ms'] / t['library_ms']:.3f}"
                 if library is not None else "kernel/library -")
        print(f"time: {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4g} ms ({t['bound_by']}), "
              f"{ratio}, {t['bound_ms'] / t['ms']:.1%} of bound, "
              f"{case['bytes'] / t['ms'] / 1e6:.1f} GB/s effective")

    torch.backends.cudnn.allow_tf32 = tf32

    # the host's cost of one call: what a decode step pays 73 times
    for name in ("rmsnorm", "rmsnorm.prefill", "rmsnorm.gated"):
        lib = cases[name]["library"]
        extra = (f", {host_ms(lib, 100):.4f} ms for the library call"
                 if lib else "")
        print(f"host: {name} bf16: {host_ms(cases[name]['kernel'], 100):.4f} "
              f"ms to enqueue one wrapper call{extra}")

    halo_exposure(halo_results, cases["stream.copy"]["bytes"]
                  / (times["stream.copy"]["ms"] * 1e-3))

    print(f"time: jacobi kernel "
          f"{jacobi_ops.mlups(GRID, GRID, times['jacobi']['ms'] / 1e3):.1f} "
          f"MLUP/s per sweep of {GRID}x{GRID} fp32")

    vplan = api.plan_for("triad", (N,), torch.float32)
    for p in PHASES:
        phased = [triad_ops.phased_tiles(x, k * p, vplan)
                  for k, x in zip((1, 2, 3), (b, c, d))]
        ms = time_ms(lambda t=phased: triad_kernel.triad2d(
            *t, brows=vplan.block_rows))
        gbs = triad_ops.triad_bytes(N, 4, rfo=False) / ms / 1e6
        print(f"phase: triad phases ({p}, {2 * p}, {3 * p}) elements: "
              f"{ms:.4f} ms, {gbs:.1f} GB/s effective")
        del phased

    # paper Fig. 7: the collision alone beside the whole step
    for n in LBM_SIZES:
        for layout in ("soa", "ivjk"):
            case = (cases[f"lbm.{layout}"] if n == LBM_SIZES[0]
                    else lbm_case(n, torch.float32, layout))
            ms = (times[f"lbm.{layout}"]["ms"] if n == LBM_SIZES[0]
                  else time_ms(case["run"]))
            print(f"fig7: {layout} N={n} fp32: collide {ms:.4f} ms "
                  f"({n ** 3 / ms / 1e3:.1f} MLUP/s, "
                  f"{case['bytes'] / ms / 1e6:.1f} GB/s), whole step "
                  f"{step_ms[layout, n]:.4f} ms "
                  f"({n ** 3 / step_ms[layout, n] / 1e3:.1f} MLUP/s)")
            del case

    # paper Fig. 5: the segmented triad over the flat one
    flat_ms = time_ms(lambda: api.launch("triad", sb, sc, sd))
    seg_ms = time_ms(lambda: triad_ops.vector_triad_segmented(*segs))
    print(f"fig5: triad n={N} fp32: flat {flat_ms:.4f} ms, {SEGMENTS} "
          f"segments {seg_ms:.4f} ms, segmented/flat {seg_ms / flat_ms:.4f}; "
          f"host enqueue a call: flat "
          f"{host_ms(lambda: api.launch('triad', sb, sc, sd)):.4f} ms, "
          f"segmented "
          f"{host_ms(lambda: triad_ops.vector_triad_segmented(*segs)):.4f} ms")

    # where the time of an LBM step and of the segmented triad goes
    f = lattice(LBM_SIZES[0], torch.float32, 1)
    for layout in ("soa", "ivjk"):
        device_profile(f"lbm_run {layout} N={LBM_SIZES[0]} x2",
                       lambda lay=layout: lbm_ops.lbm_run(f, OMEGA, 2,
                                                          layout=lay))
    del f
    device_profile(f"vector_triad_segmented n={N}",
                   lambda: triad_ops.vector_triad_segmented(*segs))

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name], **times[name],
        })

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
