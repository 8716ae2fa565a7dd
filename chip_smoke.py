#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  build          nvcc-builds every kernel under src/repro_torch/kernels/csrc
  kernels        lists the ported kernels
  flash_attention
                 the kernel against its plain version on the card, per case:
                 max error, kernel / plain / SDPA ms, and the least time the
                 card could take (bytes or operations, whichever bounds),
                 the kernel's path (wgmma, split_kv or simt; each case
                 asserts the path it must take), its splits and the CUDA
                 kernels one call makes (torch.profiler over 5 calls,
                 asserted against the path's).  Cases: the serve prefill
                 (B 4, S 128), S 512, ragged S 100, Sq 16 over Sk 144, a
                 window of 128, f32, hd 128, the train forward per worker
                 (B 2, 3 and 6, S 128), decode at the serve's positions 131
                 and 159
                 and over a 4096-slot cache, the f32 parity decode, bf16
                 inputs off 16-byte alignment, decode over 48 keys (one
                 split), Sq 4 over Sk 200 (two 16-row tiles) and decode at
                 hd 128
  flash_len      the kernel with its key count on the device (the graph
                 decode's call) over a padded cache whose every slot is
                 random: serve's position 131 in 160 and in 4096 slots
                 (15 of 16 splits empty), Hymba's windowed layer at 1279
                 of 1296 and the f32 parity decode, each against the
                 plain version masked by the length and against the
                 plain version over the sliced cache at TOL and
                 FLASH_REL_TOL; told 64 keys fewer it must fail that bar;
                 a graph captured at one length and replayed at another;
                 kernel / plain / SDPA ms beside the bound
  mlstm_chunk    the kernel against its plain version (the chunked
                 linear_recurrence) and the sequential oracle on the card,
                 for y and for a decode step taken from the returned state:
                 xlstm-350m's serve shape (B 4, S 128, H 4, hd 512, bf16),
                 ragged S 100, S 300, S 1, f32, hd 16/32/64 and extreme
                 gates; then hymba-1.5b's Mamba heads (unnormalized, scale
                 1, q/k 16 wide as views broadcast over 25 heads, v 128
                 wide) at its serve shape (B 4, S 1280, bf16), f32 and S
                 300, against the plain version and a position-by-position
                 recurrence_step oracle; each case asserts its path (wgmma
                 or simt) and the
                 CUDA kernels a call makes (5 profiled calls); kernel /
                 plain ms, the bound (bytes, or operations in the Pallas
                 kernel's chunks over the tensor cores' rates) and the
                 f32-FMA floor of the same count
  capture_audit  repro_torch.analysis.capture_audit: the controller's and
                 the server bucket's graph bodies, both train steps (run
                 under sync debug mode "error"), the obs ring push and the
                 decode step of six families at depth 2 captured
                 thread-locally with no sync and updated in place
  serve          full-width qwen2-0.5b (bf16, seeded init) through
                 ServeEngine.generate: 4 prompts x 128 tokens, 32 greedy new
                 tokens, decoded by one CUDA graph replay a token (every
                 serve phase; graph_decode): prefill's 24 flash launches
                 from Python, 32 replays of 24 flash calls each off the
                 graph's dump, no more synchronizing calls in a request
                 of 32 tokens than in one of 2 (one graph serves both)
                 and none in the replays, a replay bit-equal to the eager
                 step, each attention call of that step at TOL and
                 FLASH_REL_TOL against the plain version, its logits no
                 further from a witness step (plain attention, f32
                 statistics) than WITNESS_MARGIN x the parent's host-int
                 step's
  serve_profile  the device's busy share of a short request (torch.profiler)
  serve_parity   the same seeded weights in f32, served on the CPU (plain
                 path) and on the card (kernel): logits and ids must agree,
                 greedy and at temperature 0.8 (the sampled graph)
  masked_grad_agg
                 the kernel against its plain version: W in {2, 8, 158} x
                 N in {1, 1000, 2^20}, f32 and bf16, 0/1, fractional and
                 all-zero masks, W at the kernel's worker limit (and one
                 more, which must raise), plus the full-width
                 (8, 494,032,768) f32 buffer; kernel / plain / library
                 ((mask @ g) / c) / bound ms.  Every grid case also in the
                 sum mode (mean=False: the masked sum, undivided), and the
                 (8, 494,032,768) buffer in it: kernel / plain / library
                 (mask @ g) / bound ms (the mean's bytes); then the sum over
                 an (8, N) buffer laid out shard-major (a ShardPlan at 2, 4
                 and 8 shards, zero1 off and on) against the natural-order
                 sum, permuted, bit for bit
  fused_adam     the kernel against reference_adam at steps 1 and 100, wd 0
                 and 0.01, bf16 and f32 p (f32 m/v), on every distinct layer
                 shape plus ragged and unaligned leaves; then one checked
                 step over the 290 full-width leaves (bf16 p), timed:
                 kernel / plain / library (torch AdamW fused=True) / bound ms;
                 then one launch over each rank's slices at 2, 4 and 8
                 shards against the slices of the full update, bit for bit
  train          full-width qwen2-0.5b cutoff SGD (bf16, seeded init):
                 SyntheticTokens(seq 128, batch 16), 8 workers,
                 FirstKController(8, backup=2), ClusterSim(8, 2 nodes, seed
                 7), adamw(cosine_schedule(3e-4, 2, 20), fused=True), 3
                 psum steps then 1 weights step; asserts the launch counts
                 of every step and finite losses, and counts the optimizer's
                 leaf-table uploads per step
  train_profile  the device's busy share of one more psum step
  train_dp       train's setup, seeds and mask schedule through the
                 data-parallel path: an NCCL process group of world size 1
                 (the collectives run), a ("data",) mesh, a pure-dp layout
                 (launch.mesh, dist.sharding), W 8 on the one rank; the 4
                 psum steps (masked_grad_agg's sum mode, one all-reduce of
                 the (N + 1,) f32 sum, the division), then the weights step
                 (one all-reduce of the bf16 gradient); launch and
                 collective counts every step (the cutoff broadcast from
                 rank 0); the parameters after each path bit-equal to
                 train's; the decision's broadcast under sync debug mode
                 "error" on rank 0; the all-reduces' and the broadcast's ms
                 beside the step's, and the weights gradient's all-reduce
                 made one leaf at a time (the design the flat buffer
                 replaced)
  train_zero3    train's setup, seeds and mask schedule through ZeRO-3:
                 NCCL at world size 1, a (1, 1) ("data", "model") mesh in
                 train_fsdp, W 8; zero1 off, then on: the 4 psum steps (a
                 gather a block a forward and again in the backward's
                 recompute, one masked_grad_agg sum-mode launch over the
                 shard-major buffer, the reduce-scatter, one fused_adam
                 launch over the shards), then the weights step; launches
                 and collectives every step, the gathered parameters
                 bit-equal to train's; the collectives alone at the step's
                 sizes, ms beside the step's
  train_sp       sequence parallelism (train_sp): first the flash kernel,
                 forward and backward through FlashAttention, against its
                 plain version at the shapes a T-card mesh sends it (bf16;
                 causal Sq S/T over Sk (s+1) S/T for S 128 at T 2 and 4,
                 every s; one halo shape, Sk 2 S_loc under a window; the
                 whisper encoder's Sq 1536/T over 1536 keys, not causal);
                 then train's setup, seeds and mask schedule at NCCL world
                 size 1 on a (1, 1) ("data", "model") mesh in train_sp, W 8:
                 the 4 psum steps and the weights step with the dense CE,
                 launches and collectives every step, the gathered
                 parameters bit-equal to train's; then one psum and one
                 weights step from a fresh state with ce_impl "ring"
                 against the same with "dense": the loss within 1e-4 and
                 the aggregated f32 gradient within 1e-3
                 (tests/sharded/ring_ce_check.py's bars)
  train_parity   the same psum step at full width and 2 layers, f32, W = 4,
                 2 steps, on the CPU (plain versions) and on the card
                 (kernels): loss, aggregated gradient, m, v and p
  dmm_twin       the jax.random twin on the card against the CPU at the
                 controller's shapes: split, fold_in, uniform and
                 categorical bits equal, normals within rtol 1e-6
  dmm_fit        RuntimeModel(158, lag 20), the same init on the CPU and
                 the card, 60 ELBO steps at batch 8 on paper_cluster_158:
                 the loss trajectories agree within 2e-3 of their scale
  dmm_parity     CutoffController(k_samples=32, seed=0, device backend) on
                 the card against the numpy backend over 100
                 paper_cluster_158(seed=7) steps: identical cutoffs, window
                 rows within 2e-3, >= 50 censored steps, > 1 cutoff, one
                 graph a mode and one replay a decision
  dmm_timing     n = 8 and 158, K = 64: device µs of one decision (graph
                 replay), wall µs of observe and of predict_cutoff, the
                 CUDA kernels of one replay, the graphs captured
  train_dmm      the train phase's full-width psum setup driven by
                 CutoffController(k_samples=48) on a DMM fitted on the card
                 (ClusterSim(8, 2 nodes, seed 0), 200 steps): 5 steps, each
                 asserting the launch counts, a finite loss and one graph
                 replay a decision; prints c, the clock (and the first-k
                 clock of train), wall ms, predict_cutoff µs and the
                 decision's device µs; then 6 more steps alternating
                 first-k and the DMM, wall ms each (train_dmm_ab)
  obs            telemetry (repro_torch.obs) on the paths above, each held
                 against its bare twin: train_dmm's setup and model for 6
                 steps drained every 3, bare, with an ObsRun writing its
                 streams and with a synchronous peek at every decision:
                 losses and cutoffs equal, every decision scored from its
                 own samples (pred_iter equal to the peek's), the
                 synchronizing calls between drains (sync debug mode
                 "warn") equal, the launches asserted; PSServer J = 3 (K
                 16, train_dmm's model) on against off, then the host µs
                 of ps.flush and ps.dispatch (its wait and launch) at J =
                 1, 3, 8 (K 64), idle and beside looped controllers; the
                 supervised storm on against off and supervisor.tick's
                 µs; a short full-width request served on against off;
                 step wall bare against obs (supervised's small config and
                 full width), ring push, drain and span µs; the streams
                 rendered by python -m repro_torch.obs (and --chrome)
  train_policies the same full-width psum setup under the other straggler
                 policies, reusing train_dmm's fitted model: stale reuse
                 (StaleReuseController over the DMM, decay 0.5, 5 steps
                 with 2 masked_grad_agg launches each) checkpointed at
                 step 2 (seconds and bytes of the save and the restore;
                 ~6 GB in the temporary directory, checked free first);
                 a fresh trainer resumed from it bit-equal to the
                 uninterrupted run over 2 steps; decay 0 bit-equal to
                 discard from the same checkpoint; Elfving (a cut after
                 its warm-up); anytime (n_micro 2, grad_accum 2, a
                 fractional contribution); int8 error-feedback
                 compression (the residual within half a quantization
                 step); launches asserted every step, peak memory
  elastic_capture
                 RuntimeModel(8, lag 10) fitted on the card on
                 paper_cluster_158(0, 8).run(120), 150 steps; then a
                 width-8 refit of 60 steps through _spawn_refit (on a
                 thread and a stream of its own) while the main thread
                 builds a CutoffController and makes 5 decisions (graph
                 captures, then replays): no capture error, the cutoffs of
                 the same decisions with no fit running, the loss
                 trajectory of the same fit alone (within 2e-3 of its
                 scale; bit-equality reported); both walls
  train_elastic  the full-width psum setup (batch 24: divisible by 8 and
                 6) through an 8 -> 6 -> 8 churn under ElasticController
                 (k_samples 32, refit_steps 60, refit_fresh 3,
                 fallback_warmup 2, refit_async) on that model:
                 ChurnSim(paper_cluster_158(1, 8)) kills workers 6 and 7 at
                 step 6 and restores them after a gap sized from the
                 refit's measured wall; each step asserts the launches at
                 its width (flash L x W), a finite loss and 1 <= c <= n
                 and prints n, c, mode, whether a refit was in flight and
                 wall ms; at each width the fallback decides, then the
                 refitted DMM, before the next event; a checkpoint at step
                 12 (width 6, ~4.94 GB under TMPDIR, checked free first)
                 restored by a fresh trainer built at width 8: width 6,
                 members 0..5, the window warm; 2 steps; masked_grad_agg
                 timed on the trainer's own (6, N) buffer; refit seconds,
                 memory by width, the first step after each resize, the
                 median step with and without a refit in flight
  ps_parity      the multi-tenant server (repro_torch.ps.PSServer): J = 3
                 jobs of widths 16/10/6 (DMMs fitted on the card, K 16) in
                 one bucket over 100 paper_cluster_158 ticks: identical
                 cutoffs from the card's server, three looped device
                 CutoffControllers and the server on the CPU, flush() == 1
                 every tick, >= 50 censored observations, windows within
                 1e-4 (the reference's server bar), 2 graphs captured and
                 101 replays; then J = 1 at n = 158 against the card's own
                 controller (identical cutoffs, windows within 1e-4)
  ps_timing      J in {1, 3, 8} at n = 8 and the ragged 16/10/6 bucket (K
                 64, lag 20): device µs and CUDA kernels of one replay of
                 the bucket's observe+decide graph beside J looped
                 controllers' (device µs summed, kernels J x one's); host
                 µs of a tick's flush and predict_cutoff fetches beside
                 the looped controllers' observe + predict
  cnn_parity     the paper's CNN (models.cnn), loss and gradient at batch
                 512 in f32, mean and cutoff-weighted, card against CPU
                 (the CPU's max-pools routed as the card's; the windows
                 that flipped must be near-ties)
  cnn_fig4       the reference's Fig. 4 setting: a RuntimeModel(32, lag
                 20) fitted on the card on a 300-row ClusterSim(32, 4
                 nodes) trace for 300 steps; then full sync,
                 CutoffController(k_samples 48) and Elfving each drive
                 150 steps of launch.cnn.run_cnn_cutoff (batch 512,
                 momentum 0.05/0.9, ClusterSim seed 21): the validation
                 curve every 10 steps on 2,000 images, the final loss, the
                 simulated clock, the median wall ms of a step, the DMM's
                 decision device µs; no controller is required to win
  supervised     launch.supervised.run_supervised on the card (36 steps, 6
                 workers, default_plan's crash, hang, flaky restart and
                 slowdown): match, 2 detections within 5 ticks, 1 failed
                 restart, no evictions, widths {5, 6}; every launch a
                 flash_attention one (2 layers x 36 steps x 2 trainers);
                 losses within train_parity's 1e-4 of the same run on the
                 CPU; the host µs of Supervisor.tick
  supervised_proc_drill
                 one SIGKILL of a ProcWorkerPool subprocess worker, its
                 ticks following heartbeats: dead at crash + 5, restarted
                 2 ticks later
  train_multi_job
                 three full-width qwen2-0.5b jobs of 6 workers through
                 launch.multi_job (build_multi_job over
                 PartitionedSim(paper_cluster_158(1, 18), partition_ids(18,
                 3)), batch 24, seq 128, psum, fused AdamW, each job's
                 RuntimeModel(6, lag 10) fitted on the card, PSServer with
                 refit_async, refit_steps 60, refit_fresh 3; run_ticks
                 under round robin): a ChurnEvent kills job1's workers 6
                 and 7 at tick 8, the restore is appended once job1 has
                 decided through its width-4 DMM for 2 ticks (tick 18 at
                 the earliest), the run ends 2 ticks after it is back on
                 its width-6 DMM (26 ticks at least); every step asserts
                 its launches (flash L x W, masked_grad_agg 1, fused_adam
                 1), every tick at most 2 decision launches and captures
                 only where the stack changed; job1's modes run dmm,
                 fallback, dmm at W 4, fallback, dmm at W 6, jobs 0 and 2
                 stay on the DMM; the shared step keeps a (6, N) and a
                 (4, N) buffer at width 4 (masked_grad_agg timed on job1's
                 own) and frees the (4, N) one after; wall per tick and
                 per step with and without a refit in flight, spawn to
                 install of each refit, memory by period
  serve_xlstm    full-width xlstm-350m (bf16, seeded init) through
                 ServeEngine.generate: 4 prompts x 128 tokens, 32 greedy new
                 tokens; asserts 21 mlstm_chunk launches (the mLSTM
                 prefills) and no flash_attention launch
  serve_xlstm_profile
                 the device's busy share of a short xLSTM request
  serve_xlstm_parity
                 the same weights in f32 at full width and 8 layers (one
                 7 mLSTM + 1 sLSTM period), served on the CPU (plain path)
                 and on the card (kernel): logits and ids must agree
  mlstm_grad     MLSTMChunk (the kernel forward, the plain recurrence's
                 backward) against autograd of the plain path on the card,
                 bf16 q/k/v and f32 gates, at train_xlstm's per-worker
                 shape (B 2, S 128, H 4, hd 512) and S 300, and at
                 train_hymba's (B 2, S 128, H 25, 16/128, unnormalized, q/k
                 broadcast: the C and B rows' head sums too): y and the
                 five gradients; forward and backward device ms beside the
                 backward's bound
  sp_mlstm       the kernel at a train_sp rank's shapes with the prefix
                 carried: train_xlstm's (wgmma) and train_hymba's (CUDA
                 cores, q/k broadcast) per-worker shapes cut into 2 and 4
                 ranks' columns; each rank's own final state by a
                 states-only launch, its y and final state from the
                 combine of the ranks' before it, held against the whole
                 sequence's plain call (y) and the plain call from the same
                 state (the state, and the gradients of q, k, v, g, i and
                 of the entering state for a loss that reads y and the
                 state); kernel from a state / states-only / plain ms
                 beside their bounds
  train_xlstm    full-width xlstm-350m (bf16; depth 8: seven mLSTM
                 blocks and the sLSTM) trained under train_dmm's DMM
                 controller (CutoffController(rm, 48), ClusterSim(8, 2
                 nodes, seed 7)): seq 128 x batch 16, W 8, fused AdamW, 2
                 psum steps, each asserting 7 x 8 mlstm_chunk, 1
                 masked_grad_agg and 1 fused_adam launches and a finite
                 loss, then a weights step (7 mlstm_chunk, 1 fused_adam)
  train_sp_xlstm train_xlstm's setup and steps under train_sp at NCCL world
                 size 1 on a (1, 1) mesh (every gather of the sLSTM's input
                 and reduce-scatter still runs): launches asserted each
                 step (each block's forward runs again in its backward's
                 recompute), the parameters bit-equal to train_xlstm's
                 after its psum steps and after its weights step
  train_xlstm_parity
                 xlstm-350m at full width, depth 2 (one mLSTM, one sLSTM
                 block), f32, W 4: train_parity's comparisons, CPU against
                 the card
  serve_moe      full-depth deepseek-moe-16b (28 layers, 16,375,728,128
                 parameters, bf16, drawn on the card) through
                 ServeEngine.generate: 4 x 128 prompts, 32 greedy new
                 tokens; asserts 28 x 33 flash launches and ids in range;
                 prefill ms, ms per token, tokens/s, peak memory, the share
                 of routed slots dropped at capacity in a prefill
  serve_moe_profile
                 the device's busy share of a short MoE request
  serve_moe_parity
                 deepseek-moe-16b at full width and depth 2, f32: prefill
                 logits and greedy ids, CPU against the card
  train_moe      deepseek-moe-16b at depth 2 (layer 0 dense, layer 1 MoE;
                 1,091,315,712 parameters, bf16) under train_dmm's DMM
                 controller: seq 128 x batch 16, W 8, psum, fused AdamW; 2
                 steps, then a replay from the same state that must match
                 them bit for bit (losses, cutoffs, aux, parameters) and
                 goes on to 4 steps, each asserting its launches (flash 2
                 x 8, masked_grad_agg 1, fused_adam 1), a finite loss and
                 aux; c, aux, wall ms, peak memory, the dropped share; the
                 device's busy share of one more step; then
                 masked_grad_agg and fused_adam at this N on the trainer's
                 own buffer and state, beside their bounds
  train_moe_parity
                 the same depth-2 model in f32, W 2, seq 32 x batch 4, 2
                 steps: train_parity's comparisons and the aux, CPU against
                 the card; the host's resident bytes
  serve_hymba    full-depth hymba-1.5b (32 layers, 1,642,503,200
                 parameters, bf16, drawn on the card) through
                 ServeEngine.generate: 4 x 1280-token prompts (past the
                 1024-token window of its 29 windowed layers), 32 greedy
                 new tokens; asserts 32 x 33 flash and 32 mlstm_chunk
                 launches and ids in range; prefill ms, ms per token,
                 tokens/s, peak memory
  serve_hymba_profile
                 the device's busy share of a short Hymba request
  serve_hymba_parity
                 hymba-1.5b at full width and depth 2 (a global and a
                 windowed layer), f32, 2 x 1100-token prompts: prefill
                 logits within 1e-4 and equal greedy ids, CPU against the
                 card
  train_hymba    hymba-1.5b at depth 4 (294,917,100 parameters, bf16)
                 under train_dmm's DMM controller: seq 128 x batch 16, W
                 8, psum, fused AdamW; 2 steps and a weights step (the
                 references of train_sp_hymba), then a replay of the 2
                 from the same state that must match them bit for bit
                 (losses,
                 cutoffs, parameters) and goes on to 3 steps, each
                 asserting its launches (flash and mlstm_chunk 4 x 8,
                 masked_grad_agg 1, fused_adam 1) and a finite loss; wall
                 ms, peak memory; the device's busy share of one more
                 step; both kernels timed on the trainer's own buffer
                 and state (kernel, plain, library)
  train_sp_hymba train_hymba's setup, its 2 psum steps and the weights step
                 under train_sp at world size 1, as train_sp_xlstm:
                 launches asserted, the parameters bit-equal to
                 train_hymba's
  train_hymba_parity
                 the depth-2 model in f32, W 2, seq 32 x batch 4, 2 steps:
                 train_parity's comparisons at MoE's bars (the second
                 step's gradient and m at 5e-4), CPU against the card

  serve_whisper  full-width, full-depth whisper-base (6 encoder + 6
                 decoder blocks, 114,813,952 parameters, bf16, drawn on
                 the card) through ServeEngine.generate: 4 x 32-token
                 prompts over seeded frames (4, 1536, 512), 16 greedy new
                 tokens; asserts 18 flash launches a prefill (6 encoder
                 non-causal, 6 causal, 6 cross) and 12 a decode step (6
                 self, 6 cross over the cached frames), ids in range, no
                 synchronizing call in the decode loop; prefill ms, ms
                 per token, tokens/s, peak memory
  serve_whisper_parity
                 the same at full depth in f32, 2 prompts: prefill logits
                 and every self and cross cache within 1e-4, equal ids
                 (greedy and at temperature 0.8), CPU against the card
  train_whisper  full depth, bf16, under train_dmm's DMM controller: seq
                 128 x batch 16 with seeded frames (MediaTokens), W 8,
                 psum, fused AdamW; 2 steps, a replay bit-equal to them
                 going on to 3, each asserting 8 x 18 flash, 1
                 masked_grad_agg and 1 fused_adam launches; the busy
                 share of one more step; both kernels timed on the
                 trainer's own buffer and state
  train_whisper_parity
                 full depth, f32, W 2, seq 32 x batch 2, 2 steps:
                 train_hymba_parity's bars, the key biases (gradient 0 by
                 construction) at 1e-6 absolute
  serve_qwen2vl  full-depth qwen2-vl-7b (28 layers, 7,615,616,512
                 parameters, bf16, drawn on the card): a prefill of 4 x
                 256 tokens whose positions 32..95 take seeded patch
                 embeddings, with M-RoPE streams h/w walking the 8 x 8
                 grid (t 0..255): finite logits the patches moved; then
                 ServeEngine.generate on a text prompt, 16 greedy new
                 tokens: 28 x 17 flash launches; prefill ms, ms per
                 token, tokens/s, peak memory
  serve_qwen2vl_parity
                 depth 2, f32, 2 x 128 tokens with the image run: prefill
                 logits and caches within 1e-4, equal ids, CPU against
                 the card
  train_qwen2vl  depth 2 (1,556,113,920 parameters, bf16), W 4 under a
                 4-worker DMM fitted on the card; batches with patches,
                 the image mask and (3, B, S) positions through the
                 per-worker split; 2 + 3 steps as train_whisper (2 x 4
                 flash, 1, 1 a step); both kernels timed at this N
  train_qwen2vl_parity
                 depth 2, f32, W 2: train_hymba_parity's bars

The qwen2-0.5b phases after train_dmm run at full width and a cut depth
(``CUT_DEPTH``: obs, train_policies and train_multi_job 4 layers,
train_elastic 12), for the script's time.

Then the wall seconds of every phase, a ``{"kernels": [...]}`` summary
line, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,       # dense tensor-core bf16
            "float32": 67e12}         # f32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
# the flash error over the case's largest |output| as well: at Sk 1536 a
# typical |output| (~0.03) sits under TOL's 3e-2, while a kernel that
# skips one 64-key tile is off by ~0.3 of the largest (checked each run)
FLASH_REL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_TILE = 64
# tests/test_kernels.py: masked agg 1e-5 (f32) and 1e-2 (bf16), atol=rtol
AGG_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# tests/test_kernels.py fused adam: (atol, rtol) for m and v, atol for p
ADAM_TOL = {"m": (1e-5, 1e-5), "v": (1e-6, 1e-5),
            "p": {"float32": 1e-5, "bfloat16": 2e-3}}
PARITY_LOGIT_ATOL = 1e-3   # f32, 24 layers, sums in another order per device
# the sampled parity requests (examples/serve_decode.py's temperature)
SAMPLE_T, SAMPLE_SEED = 0.8, 1
SEED = 0



@dataclasses.dataclass(frozen=True)
class FlashCase:
    name: str
    B: int
    Sq: int
    Sk: int
    H: int
    KV: int
    hd: int
    dtype: str
    path: str          # the kernel path the case must take
    causal: bool = True
    window: int = 0
    cache: int = 0     # decode: k/v are the first Sk slots of a longer cache
    offset: int = 0    # q, k, v start this many elements past an allocation


FLASH_CASES = [
    FlashCase("prefill_s128", 4, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("prefill_s512", 4, 512, 512, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("ragged_s100", 4, 100, 100, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("sq16_sk144", 4, 16, 144, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("decode_pos131", 4, 1, 132, 14, 2, 64, "bfloat16", "split_kv",
              cache=160),
    FlashCase("window128_s512", 4, 512, 512, 14, 2, 64, "bfloat16", "wgmma",
              window=128),
    FlashCase("f32_s256", 2, 256, 256, 14, 2, 64, "float32", "simt"),
    FlashCase("hd128_s256", 2, 256, 256, 8, 2, 128, "bfloat16", "wgmma"),
    FlashCase("train_b2_s128", 2, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("train_b3_s128", 3, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    # a train_multi_job worker at width 4 (batch 24 / 4)
    FlashCase("train_b6_s128", 6, 128, 128, 14, 2, 64, "bfloat16", "wgmma"),
    FlashCase("decode_sk4096", 4, 1, 4096, 14, 2, 64, "bfloat16", "split_kv",
              cache=4096),
    FlashCase("decode_pos159", 4, 1, 160, 14, 2, 64, "bfloat16", "split_kv",
              cache=160),
    # serve_parity's decode (one prompt, a 72-slot f32 cache)
    FlashCase("f32_decode_sk71", 1, 1, 71, 14, 2, 64, "float32", "simt",
              cache=72),
    # one element past the allocation: pointers off 16 bytes
    FlashCase("unaligned_s96", 2, 96, 96, 14, 2, 64, "bfloat16", "simt",
              offset=1),
    # fewer keys than two splits' floor: one split writes the output
    FlashCase("decode_sk48", 4, 1, 48, 14, 2, 64, "bfloat16", "split_kv",
              cache=160),
    # 28 packed rows: two 16-row tiles of the split kernel
    FlashCase("sq4_sk200", 4, 4, 200, 14, 2, 64, "bfloat16", "split_kv"),
    FlashCase("decode_hd128", 2, 1, 300, 8, 2, 128, "bfloat16", "split_kv",
              cache=512),
    # launch.supervised's trainer: bench_tiny_config at head_dim 64, f32,
    # the weights aggregation's global batch 60 at seq 8 (a query block
    # shorter than one tile; 2 heads over 1 KV head)
    FlashCase("supervised_b60_s8", 60, 8, 8, 2, 1, 64, "float32", "simt"),
    # phase 5 of examples/torch_fault_tolerance_demo.py: the reduced
    # qwen2-0.5b at head_dim 64, f32, global batch 56 at seq 32
    FlashCase("demo_b56_s32", 56, 32, 32, 4, 2, 64, "float32", "simt"),
    # whisper-base (8 heads of 64, no GQA): the encoder's non-causal
    # self-attention over 1536 frames (serve_whisper's B 4), a ragged
    # non-causal 100, cross-attention of the serve prompt (Sq 32, split)
    # and of a train worker (B 2, Sq 128) over the frames, cross decode,
    # and serve_whisper_parity's f32 cross prefill
    FlashCase("whisper_enc_s1536", 4, 1536, 1536, 8, 8, 64, "bfloat16",
              "wgmma", causal=False),
    FlashCase("noncausal_s100", 4, 100, 100, 8, 8, 64, "bfloat16", "wgmma",
              causal=False),
    FlashCase("cross_sq32_sk1536", 4, 32, 1536, 8, 8, 64, "bfloat16",
              "split_kv", causal=False),
    FlashCase("cross_train_sq128_sk1536", 2, 128, 1536, 8, 8, 64,
              "bfloat16", "wgmma", causal=False),
    FlashCase("cross_decode_sk1536", 4, 1, 1536, 8, 8, 64, "bfloat16",
              "split_kv", causal=False),
    FlashCase("f32_cross_sq32_sk1536", 2, 32, 1536, 8, 8, 64, "float32",
              "simt", causal=False),
    # qwen2-vl-7b: 28 query heads over 4 KV heads (G 7) at hd 128, the
    # serve prompt (S 256) and a decode step in a 512-slot cache (7 rows
    # a KV head on the split path)
    FlashCase("g7_hd128_s256", 4, 256, 256, 28, 4, 128, "bfloat16", "wgmma"),
    FlashCase("g7_decode_hd128", 4, 1, 300, 28, 4, 128, "bfloat16",
              "split_kv", cache=512),
]
# (name, B, S, H, hd, dtype, gates, path the case must take): xlstm-350m's
# mLSTM has 4 heads of 512
MLSTM_CASES = [
    ("serve_s128", 4, 128, 4, 512, "bfloat16", "normal", "wgmma"),
    ("ragged_s100", 4, 100, 4, 512, "bfloat16", "normal", "wgmma"),
    ("s300", 2, 300, 4, 512, "bfloat16", "normal", "wgmma"),
    ("s1", 4, 1, 4, 512, "bfloat16", "normal", "wgmma"),
    ("f32_s128", 4, 128, 4, 512, "float32", "normal", "simt"),
    ("hd16_s77", 2, 77, 4, 16, "float32", "normal", "simt"),
    ("hd32_s128", 4, 128, 4, 32, "bfloat16", "normal", "simt"),
    ("hd64_s130", 2, 130, 4, 64, "bfloat16", "normal", "wgmma"),
    ("extreme_gates", 4, 128, 4, 512, "bfloat16", "extreme", "wgmma"),
]
MLSTM_HEADLINE = "serve_s128"
# (name, B, S, H, dq, dv, dtype, path the case must take): hymba-1.5b's
# Mamba heads, the unnormalized form at scale 1 (HYMBA_FORM), q/k 16 wide
# as views broadcast over the 25 heads, v 128 wide.  A list of its own:
# tests/test_torch_mlstm_plan.py reads MLSTM_CASES' rows as they are.
MLSTM_HYMBA_CASES = [
    ("hymba_serve_s1280", 4, 1280, 25, 16, 128, "bfloat16", "simt"),
    ("hymba_f32_s128", 2, 128, 25, 16, 128, "float32", "simt"),
    ("hymba_s300", 2, 300, 25, 16, 128, "bfloat16", "simt"),
]
MLSTM_HYMBA_HEADLINE = "hymba_serve_s1280"
HYMBA_FORM = {"normalize": False, "scale": 1.0}
# the mLSTM yardstick counts the work in the Pallas kernel's chunks,
# min(128, S) (src/repro/kernels/mlstm_chunk.py:88), whatever chunk the
# port's kernel takes
PALLAS_MLSTM_CHUNK = 128
TF32_OPS = 495e12   # dense tensor-core TF32: products with an f32 operand
# kernel vs plain and vs the oracle, y and a decode step: atol = rtol, as
# tests/test_kernels.py holds the Pallas kernel (both sides compute in f32
# from the same inputs; they differ in chunking and summation order)
MLSTM_TOL = 5e-4
HEADLINE_CASE = "prefill_s128"   # the serve prompt's shape
# whisper's and qwen2-vl's flash cases, reported in the kernels line
SLICE_FLASH_CASES = ("whisper_enc_s1536", "noncausal_s100",
                     "cross_sq32_sk1536", "cross_train_sq128_sk1536",
                     "cross_decode_sk1536", "f32_cross_sq32_sk1536",
                     "g7_hd128_s256", "g7_decode_hd128")
# the qwen2-0.5b paths after train_dmm at full width and a cut depth: at
# 24 layers the three longest took 96.9, 128.5 and 117.2 s of an 835.6 s
# run on an H100 80GB HBM3 at 700 W, and obs 51.2 s where 4 layers take
# ~30 (obs wraps train_dmm's setup, whose 24-layer run precedes it; its
# checks hold at any depth).  train_elastic keeps 12: its churn
# schedule is sized for steps of at least STEP_S_MIN seconds
# train_xlstm runs 8 (seven mLSTM blocks and the sLSTM; 21.6 s at its
# full 24 on an H100 80GB HBM3 at 700 W) to pay for train_sp;
# train_elastic keeps its 12 because its churn schedule assumes steps of
# STEP_S_MIN or more
CUT_DEPTH = {"obs": 4, "train_policies": 4, "train_elastic": 12,
             "train_multi_job": 4, "train_xlstm": 8}
# the CUDA kernels of src/repro_torch/kernels/csrc, by function name
PORT_KERNELS = ("flash_fwd", "flash_fwd_tc", "flash_split_tc",
                "flash_combine", "masked_agg", "fused_adam", "mlstm_fwd",
                "mlstm_state_tc", "mlstm_out_tc")
AGG_HEADLINE = "full_w8_f32"      # the train step's (8, N) buffer
AGG_SUM_HEADLINE = "full_w8_f32_sum"   # the same in sum mode (train_dp)
ADAM_HEADLINE = "full_bfloat16"   # the train step's leaves


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def eager_ms(torch, fn, reps=20, warmup=3):
    """Time per call of back-to-back eager calls: the host's launch cost
    included, as a caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, side, reps=20):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so no host launch cost sits between the kernels.  ``side`` is
    the capture stream, one for every timing (each new stream would keep
    a cuBLAS workspace of its own)."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):   # warm-up off the capture: allocator, handles
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def device_profile(torch, fn, n_top=10):
    """Run ``fn`` under torch.profiler, recording the device's activity
    only (kernels and copies; recording the host's ops as well costs seconds
    of post-processing per 10^4 kernels): device ms, device events, the
    port's own kernels by name and the kernels that took longest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    ours = {}   # the port's kernels by name
    for e in dev:
        name = kernel_name(e.key)
        if name in PORT_KERNELS:
            n, ms = ours.get(name, (0, 0.0))
            ours[name] = (n + e.count, ms + e.self_device_time_total / 1e3)
    return {"device_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "device_events": sum(e.count for e in dev),
            "ours": {k: {"count": n, "device_ms": ms}
                     for k, (n, ms) in ours.items()},
            "top": [{"kernel": e.key[:100], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top[:n_top]]}


def graph_kernel_counts(torch, fn, side, warm=True):
    """(the port's CUDA kernels one call of ``fn`` launches, by name; every
    kernel node of the call), read off the debug dump of a CUDA graph of
    the call (warmed up on ``side`` unless ``warm`` is False, captured,
    never run), with no profiler: deterministic, where a
    profiler trace can lose kernels.  A node is one line of the dump and
    names its kernel, mangled (a source name follows its length) or
    not; a kernel node's label starts with KERNEL."""
    import tempfile

    if warm:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                       # warm-up off the capture
        torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # dumpable, never run
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "call.dot"
        graph.debug_dump(str(path))
        lines = path.read_text().splitlines()
    del graph
    per, total = {}, 0
    for ln in lines:
        names = {n for n in PORT_KERNELS if f"{len(n)}{n}" in ln}
        names |= {m for m in re.findall(r"::(\w+)[<(]", ln)
                  if m in PORT_KERNELS}
        for n in names:
            per[n] = per.get(n, 0) + 1
        total += "label=" in ln and "KERNEL" in ln
    return per, total


def graph_kernels(torch, fn, side):
    """The port's CUDA kernels one call of ``fn`` launches, by name
    (:func:`graph_kernel_counts`)."""
    return graph_kernel_counts(torch, fn, side)[0]


def kernels_per_call(torch, fn, calls=5):
    """The CUDA kernels one call of ``fn`` launches, by name: launches a
    call and device µs a launch, from ``calls`` profiled calls.  One call
    before them is traced and dropped, since the first moments of a trace
    can lose kernels.  A trace that lost events all the same (none at all,
    or a kernel counted a fractional number of times a call: every wrapper
    here launches the same kernels on every call) is taken again, up to 5
    traces; the caller asserts the counts.  The phases that call
    this run first: late in a long run (after the serve and train
    profiles) the profiler has lost the first kernel of every trace."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(5):
        per = {}
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls,
                                       repeat=1),
                     on_trace_ready=lambda p: got.append(p.key_averages())
                     ) as prof:
            for _ in range(1 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        for e in got[0]:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = per.get(kernel_name(e.key), (0, 0.0))
                per[kernel_name(e.key)] = (n + e.count,
                                           us + e.self_device_time_total)
        if per and all(n % calls == 0 for n, _ in per.values()):
            break
    return {k: {"per_call": n / calls, "us": us / n}
            for k, (n, us) in per.items()}


def kernel_name(key):
    """``flash_fwd`` of ``void (anonymous namespace)::flash_fwd<...>``."""
    m = re.search(r"::(\w+)[<(]", key)
    return m.group(1) if m else key[:60]


def valid_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the masks leave, per (batch, head)."""
    n = 0
    for i in range(Sq):
        qpos = i + Sk - Sq
        hi = min(Sk - 1, qpos) if causal else Sk - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    info = build.build_all()
    wall = time.perf_counter() - t0
    per = {}
    for name, rec in info.items():
        ptxas, fn = [], None   # each line under its (mangled) kernel name
        for ln in rec["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                fn = m.group(1)
            elif "registers" in ln or "spill" in ln:
                ptxas.append(f"{fn}: {ln.strip()}")
        per[name] = {"seconds": rec["seconds"], "ptxas": ptxas}
    emit("build", seconds=wall, kernels=per)
    emit("kernels", names=sorted(build.SOURCES))


def phase_flash(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        aligned16, choose_path, flash_attention, split_plan)
    from repro_torch.kernels.ref import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    side = torch.cuda.Stream()
    results = {}
    for c in FLASH_CASES:
        name, B, Sq, Sk, H, KV, hd = (c.name, c.B, c.Sq, c.Sk, c.H, c.KV,
                                      c.hd)
        causal, window, dt = c.causal, c.window, getattr(torch, c.dtype)

        def rand(*shape):
            n = math.prod(shape)
            flat = torch.randn(n + c.offset, generator=gen, device="cuda")
            return flat.to(dt)[c.offset:].view(shape)

        q = rand(B, Sq, H, hd)
        if c.cache:   # decode: a view of the first Sk slots of a cache
            k = rand(B, c.cache, KV, hd)[:, :Sk]
            v = rand(B, c.cache, KV, hd)[:, :Sk]
        else:
            k, v = rand(B, Sk, KV, hd), rand(B, Sk, KV, hd)
        path = choose_path(q.dtype, Sq, H // KV, aligned16(q, k, v))
        check(path == c.path, f"{name}: takes {path}, not {c.path}")
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = reference_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out.shape == want.shape and out.dtype == q.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        err = (out.float() - want.float()).abs().max().item()
        tol, rel_tol = TOL[c.dtype], FLASH_REL_TOL[c.dtype]
        check(err <= tol, f"{name}: max error {err} > {tol}")
        want_max = want.float().abs().max().item()
        rel_err = err / want_max
        check(rel_err <= rel_tol, f"{name}: max error {err} is {rel_err} of "
              f"the largest |output| {want_max} > {rel_tol}")
        # the bar's power: the kernel over the keys less one tile, as a
        # kernel that skipped it would compute, must fail it (on the first
        # Sk - 64 rows at most: the kernel takes Sq <= Sk, and non-causal
        # rows are independent)
        drop_rel = None
        if not causal and Sk >= 2 * FLASH_TILE:
            j = (Sk // 2) // FLASH_TILE * FLASH_TILE
            n = min(Sq, Sk - FLASH_TILE)
            kd, vd = (torch.cat([t[:, :j], t[:, j + FLASH_TILE:]], 1)
                      for t in (k, v))
            dropped = flash_attention(q[:, :n].contiguous(), kd, vd,
                                      causal=False)
            drop_rel = ((dropped.float() - want[:, :n].float()).abs().max()
                        .item() / want_max)
            check(drop_rel > rel_tol, f"{name}: skipping keys [{j}, "
                  f"{j + FLASH_TILE}) is off by only {drop_rel} of the "
                  f"largest |output|, within the bar {rel_tol}")
            del kd, vd, dropped

        qpos = torch.arange(Sq, device="cuda") + (Sk - Sq)
        kpos = torch.arange(Sk, device="cuda")
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device="cuda")
        if causal:
            mask &= kpos[None] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None] > qpos[:, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib_err = (sdpa().transpose(1, 2).float() - want.float()
                   ).abs().max().item()

        def kern():
            return flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return reference_attention(q, k, v, causal=causal, window=window)

        times = {}
        for label, fn in (("ms", kern), ("plain_ms", plain),
                          ("library_ms", sdpa)):
            times[label] = device_ms(torch, fn, side)
            times["eager_" + label] = eager_ms(torch, fn)
        # the library is a yardstick only: a wrong result voids its time
        # (SDPA on views off 16-byte alignment), the run goes on
        lib_invalid = None
        if not lib_err <= tol:
            lib_invalid = (f"library_err {lib_err} > tol {tol}: the "
                           f"library time {times['library_ms']} ms is of a "
                           f"wrong result")
            times["library_ms"] = times["eager_library_ms"] = None
        plan = (split_plan(Sq, Sk, causal, window, B * KV)
                if path == "split_kv" else None)
        # the CUDA kernels a call makes, against what its path launches
        per_call = graph_kernels(torch, kern, side)
        expect = {"simt": {"flash_fwd"}, "wgmma": {"flash_fwd_tc"},
                  "split_kv": {"flash_split_tc"}}[path]
        if plan and plan.splits > 1:
            expect = expect | {"flash_combine"}
        check(set(per_call) == expect
              and all(n == 1 for n in per_call.values()),
              f"{name}: a call launched {per_call}, not one each of "
              f"{sorted(expect)}")

        elt = q.element_size()
        nbytes = elt * (2 * q.numel() + 2 * B * Sk * KV * hd)
        ops = 4 * B * H * hd * valid_pairs(Sq, Sk, causal, window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[c.dtype] * 1e3
        rec = {"case": name, "shape": [B, Sq, Sk, H, KV, hd],
               "dtype": c.dtype, "causal": causal, "window": window,
               "cache": c.cache, "offset": c.offset, "max_abs_err": err,
               "tol": tol, "max_abs_want": want_max, "rel_err": rel_err,
               "rel_tol": rel_tol, "dropped_tile_rel_err": drop_rel, **times, "library_err": lib_err,
               "library_invalid": lib_invalid,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops, "path": path,
               "splits": plan.splits if plan else None,
               "cuda_kernels_per_call": sum(per_call.values()),
               "ms_over_library": (None if lib_invalid else
                                   times["ms"] / times["library_ms"])}
        results[name] = rec
        emit("flash_attention", **rec)
    return results


# (name, B, L cache slots, length, H, KV, hd, dtype, window, path): decode
# with the key count on the device (the graph decode's call): serve's
# position 131 in its 160-slot cache and in a 4096-slot one (15 of 16
# splits empty), Hymba's windowed layer at position 1279 of its 1296
# slots (1024 keys from 256), and the f32 parity decode
FLASH_LEN_CASES = [
    ("decode_len_pos131_L160", 4, 160, 132, 14, 2, 64, "bfloat16", 0,
     "split_kv"),
    ("decode_len_pos131_L4096", 4, 4096, 132, 14, 2, 64, "bfloat16", 0,
     "split_kv"),
    ("decode_len_win1024_pos1279_L1296", 4, 1296, 1280, 25, 5, 64,
     "bfloat16", 1024, "split_kv"),
    ("f32_decode_len_pos131_L160", 1, 160, 132, 14, 2, 64, "float32", 0,
     "simt"),
]
FLASH_LEN_HEADLINE = "decode_len_pos131_L160"
# the negative check: the same call told 64 keys fewer must fail the bar
LEN_SHORT = 64
# a second length for a graph captured at the first: one capture serves
# every length
LEN_REPLAY_SHIFT = 37


def phase_flash_len(torch):
    """The flash kernel with its key count on the device (``length``): per
    FLASH_LEN_CASES row, the kernel over the whole padded cache (every
    slot random, past the length too) against the plain version (masked
    by the length) and against the plain version over the cache sliced to
    the length (the host-int decode's call), at TOL and FLASH_REL_TOL;
    the same call with ``length - LEN_SHORT`` must fail that bar (the
    kernel reads the length); a CUDA graph of the call captured at one
    length and replayed at ``length - LEN_REPLAY_SHIFT`` within the bar
    there; kernel / plain / SDPA device ms beside the bound (the visible
    keys read once), the CUDA kernels of a call off the graph's dump."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        aligned16, choose_path, flash_attention, plan_keys, split_plan)
    from repro_torch.kernels.ref import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    side = torch.cuda.Stream()
    results = {}
    for (name, B, L, n, H, KV, hd, dtname, window, want_path
         ) in FLASH_LEN_CASES:
        dt = getattr(torch, dtname)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q, k, v = rand(B, 1, H, hd), rand(B, L, KV, hd), rand(B, L, KV, hd)
        length = torch.tensor(n, dtype=torch.int32, device="cuda")
        path = choose_path(q.dtype, 1, H // KV, aligned16(q, k, v))
        check(path == want_path, f"{name}: takes {path}, not {want_path}")
        tol, rel_tol = TOL[dtname], FLASH_REL_TOL[dtname]

        def kern():
            return flash_attention(q, k, v, causal=True, window=window,
                                   length=length)

        def plain():
            return reference_attention(q, k, v, causal=True, window=window,
                                       length=length)

        def errs(got, want):
            e = (got.float() - want.float()).abs().max().item()
            return e, e / want.float().abs().max().item()

        out, want = kern(), plain()
        sliced = reference_attention(q, k[:, :n], v[:, :n], causal=True,
                                     window=window)
        err, rel = errs(out, want)
        err_sliced, rel_sliced = errs(out, sliced)
        check(err <= tol and rel <= rel_tol, f"{name}: max error {err} "
              f"({rel} of the largest |output|) > {tol} / {rel_tol}")
        check(err_sliced <= tol and rel_sliced <= rel_tol,
              f"{name}: against the sliced cache {err_sliced} "
              f"({rel_sliced}) > {tol} / {rel_tol}")
        short = torch.tensor(n - LEN_SHORT, dtype=torch.int32,
                             device="cuda")
        _, rel_short = errs(flash_attention(q, k, v, causal=True,
                                            window=window, length=short),
                            want)
        check(rel_short > rel_tol, f"{name}: told {LEN_SHORT} keys fewer "
              f"the kernel is off by only {rel_short} of the largest "
              f"|output|, within the bar {rel_tol}")
        # one capture at length n, replayed at another length
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kern()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out = kern()
        length.fill_(n - LEN_REPLAY_SHIFT)
        graph.replay()
        err_replay, rel_replay = errs(g_out, plain())
        length.fill_(n)
        del graph
        check(err_replay <= tol and rel_replay <= rel_tol,
              f"{name}: a graph captured at length {n} replayed at "
              f"{n - LEN_REPLAY_SHIFT} is off by {err_replay} "
              f"({rel_replay})")

        kpos = torch.arange(L, device="cuda")
        mask = (kpos < n) & ((kpos > n - 1 - window) if window > 0
                             else True)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[None], enable_gqa=True)

        lib_err = (sdpa().transpose(1, 2).float() - want.float()
                   ).abs().max().item()
        times = {label: device_ms(torch, fn, side) for label, fn in
                 (("ms", kern), ("plain_ms", plain), ("library_ms", sdpa))}
        lib_invalid = None
        if not lib_err <= tol:
            lib_invalid = f"library_err {lib_err} > tol {tol}"
            times["library_ms"] = None
        per_call = graph_kernels(torch, kern, side)
        plan = (split_plan(1, plan_keys(1, L, window), False, 0, B * KV)
                if path == "split_kv" else None)
        expect = {"simt": {"flash_fwd"}, "split_kv": {"flash_split_tc"}
                  }[path] | ({"flash_combine"} if plan and plan.splits > 1
                             else set())
        check(set(per_call) == expect
              and all(c == 1 for c in per_call.values()),
              f"{name}: a call launched {per_call}, not one each of "
              f"{sorted(expect)}")
        visible = min(n, window) if window > 0 else n
        elt = q.element_size()
        nbytes = elt * (2 * q.numel() + 2 * B * visible * KV * hd)
        ops = 4 * B * H * hd * visible
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dtname] * 1e3
        rec = {"case": name, "shape": [B, 1, L, H, KV, hd], "length": n,
               "dtype": dtname, "window": window, "path": path,
               "splits": plan.splits if plan else None,
               "chunk": plan.chunk if plan else None,
               "max_abs_err": err, "rel_err": rel, "tol": tol,
               "rel_tol": rel_tol, "sliced_max_abs_err": err_sliced,
               "sliced_rel_err": rel_sliced, "short_rel_err": rel_short,
               "replay_length": n - LEN_REPLAY_SHIFT,
               "replay_max_abs_err": err_replay, **times,
               "library_err": lib_err, "library_invalid": lib_invalid,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops,
               "cuda_kernels_per_call": sum(per_call.values())}
        results[name] = rec
        emit("flash_len", **rec)
    return results


def phase_capture_audit(torch):
    """``repro_torch.analysis.capture_audit`` on the card: every entry
    captured thread-locally with no sync (the eager train step run under
    sync debug mode "error") and updated in place; the report's ``ok``
    must be true."""
    from repro_torch.analysis.capture_audit import run_audit

    report = run_audit()
    emit("capture_audit", **report)
    bad = [e["name"] for e in report["entries"] if not e["ok"]]
    check(report["ok"] and not bad, f"capture_audit: failed {bad}")
    gc.collect()
    torch.cuda.empty_cache()
    return report


def init_weights(torch, cfg):
    from repro_torch.models import model as M

    g = torch.Generator().manual_seed(SEED)
    return M.init_model(cfg, g, device="cpu", dtype=torch.float32)


def cast(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


# the kernels a flash_attention call launches first (the split path's
# merge, flash_combine, follows in the same call)
FLASH_MAIN = ("flash_fwd", "flash_fwd_tc", "flash_split_tc")


@contextlib.contextmanager
def host_int_decode(pos):
    """Decode attention as the parent commit ran it, for one step at the
    host int ``pos``: the new k/v written at ``pos``, the cache sliced to
    ``pos + 1`` on the host, the kernel given no length."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A

    def attn_decode(q, k_new, v_new, cache_k, cache_v, _pos, *, window=0,
                    softcap=0.0):
        cache_k[:, pos] = k_new[:, 0]
        cache_v[:, pos] = v_new[:, 0]
        return (ops.attention(q, cache_k[:, :pos + 1], cache_v[:, :pos + 1],
                              causal=True, window=window), cache_k, cache_v)

    orig, A.attn_decode = A.attn_decode, attn_decode
    try:
        yield
    finally:
        A.attn_decode = orig


@contextlib.contextmanager
def attention_as(fn):
    """``ops.attention`` (every attention call of the models) replaced by
    ``fn(kernel, q, k, v, **kw)`` inside the block."""
    from repro_torch.kernels import ops

    orig = ops.attention
    ops.attention = lambda q, k, v, **kw: fn(orig, q, k, v, **kw)
    try:
        yield
    finally:
        ops.attention = orig


def check_replays(engine, n_new, label):
    """A card engine served each of its requests (one a sampling mode) by
    n_new replays of that mode's decode graph."""
    if engine.device.type == "cuda":
        got = [g.replays for g in engine.graphs.values()]
        check(got and all(r == n_new for r in got), f"{label}: graph "
              f"replays {got}, want {n_new} a graph")


# the decode step's logits against the witness (every attention the plain
# version, f32 statistics): the graph's mean |error| at most this many
# times the parent's host-int step's.  The two differ only in the order
# of bf16 sums inside attention, and their errors differ by far less; an
# attention call that drops or misreads keys is off by whole logits.
WITNESS_MARGIN = 2.0


def graph_decode(torch, label, cfg, engine, prompts, n_new, prefill_want,
                 frames=None):
    """ServeEngine.generate through its decode graph: a request of n_new
    greedy tokens captures the graph of its batch size (the warm-up); the
    timed request then launches only prefill's kernels from Python
    (``prefill_want``) and replays the graph once a token.  The graph's
    kernels a replay come off its dump (the port's by name, every kernel
    node), so the path's launches are prefill's plus replays x the flash
    calls of a replay (one per attention layer, and per cross-attention).
    A request of n_new tokens makes no more synchronizing calls than one
    of 2 (both served by the one graph), and the replay loop alone makes
    none; a replay is bit-equal (logits, token, position, every cache
    leaf) to the eager step over a copy of the same state.  In that step
    every attention call is held at TOL and FLASH_REL_TOL against the
    plain version on its inputs, and its logits against a witness step
    whose every attention is the plain version (f32 statistics): the
    graph's mean error at most WITNESS_MARGIN times that of the parent's
    host-int decode of the same step.  Returns (record, launches on the
    main path, device busy profile)."""
    from repro_torch import tree
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import reference_attention
    from repro_torch.models import model as M

    B, S = prompts.shape
    key = (B, False)
    engine.generate(prompts, n_new, frames=frames)   # warm-up: the capture
    check(key in engine.graphs, f"{label}: no decode graph for {key}")
    g = engine.graphs[key]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    r0 = g.replays
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new, frames=frames)   # one .cpu()
    gen_s = time.perf_counter() - t0
    eager = dict(build.LAUNCHES)
    replays = g.replays - r0
    peak = torch.cuda.max_memory_allocated()
    check(replays == n_new, f"{label}: {replays} replays for {n_new} tokens")
    check(eager == prefill_want, f"{label}: launched {eager} from Python, "
          f"want prefill's {prefill_want}")
    check(ids.shape == (B, n_new) and ids.dtype == np.int32,
          f"{label}: ids {ids.shape} {ids.dtype}")
    check(bool(np.all((ids >= 0) & (ids < cfg.vocab_size))),
          f"{label}: ids out of vocabulary range")
    # the whole request path (prefill, the state's load, the replays, the
    # fetch): a request of n_new tokens makes no more synchronizing calls
    # than one of 2 (the uploads, the allocator's, the one fetch)
    req_msgs = []
    req_syncs = [_count_syncs(torch, lambda: engine.generate(
        prompts, n, frames=frames), req_msgs)[1] for n in (2, n_new)]
    check(req_syncs[1] <= req_syncs[0], f"{label}: {req_syncs[1]} "
          f"synchronizing calls in a request of {n_new} tokens, "
          f"{req_syncs[0]} in one of 2: {req_msgs}")
    check(list(engine.graphs) == [key], f"{label}: graphs "
          f"{list(engine.graphs)} after requests of 2 and {n_new} tokens, "
          f"want one, {key}")
    side = torch.cuda.Stream()
    st = g.state
    with torch.inference_mode():
        snap = st.clone()
        snap.pos.fill_(S)
        snap.t.zero_()
        per, total = graph_kernel_counts(torch, snap.step, side)
        flash_calls = sum(per.get(n, 0) for n in FLASH_MAIN)
        attn_layers = sum(s.kind != "mlstm" and s.kind != "slstm"
                          for s in M.layer_specs(cfg))
        want_calls = attn_layers * (2 if cfg.is_encoder_decoder else 1)
        check(flash_calls == want_calls, f"{label}: {per} in a replay, want "
              f"{want_calls} flash calls")
        launches = dict(eager)
        if flash_calls:
            launches["flash_attention"] = (eager.get("flash_attention", 0)
                                           + replays * flash_calls)
        # the replay loop alone, from a valid position
        st.pos.fill_(S)
        st.t.zero_()
        torch.cuda.synchronize()
        sync_msgs = []
        _, syncs = _count_syncs(torch, lambda: [g.replay()
                                                for _ in range(n_new)],
                                sync_msgs)
        torch.cuda.synchronize()
        check(syncs == 0, f"{label}: {syncs} synchronizing calls in "
              f"{n_new} replays: {sync_msgs}")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        st.pos.fill_(S)
        st.t.zero_()
        start.record()
        for _ in range(n_new):
            g.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / n_new
        # a replay against the eager step, and the parent's step
        st.pos.fill_(S)
        st.t.zero_()
        pre, eager_state = st.clone(), st.clone()
        g.replay()
        want_logits = eager_state.step()
        torch.cuda.synchronize()
        bit_equal = (torch.equal(st.logits, want_logits)
                     and torch.equal(st.tok, eager_state.tok)
                     and torch.equal(st.pos, eager_state.pos)
                     and all(torch.equal(a, b) for a, b in zip(
                         tree.leaves(st.caches),
                         tree.leaves(eager_state.caches))))
        check(bit_equal, f"{label}: a replay differs from the eager step")
        # every attention call of the step against the plain version on
        # its inputs, and the witness step
        chk, wit = pre.clone(), pre.clone()
        calls = []

        def held(kernel, q, k, v, **kw):
            y = kernel(q, k, v, **kw)
            w = reference_attention(q, k, v, **kw)
            e = (y.float() - w.float()).abs().max().item()
            calls.append((str(q.dtype).split(".")[-1], e,
                          e / w.float().abs().max().item()))
            return y

        with attention_as(held):
            chk.step()
        with attention_as(lambda _kernel, q, k, v, **kw:
                          reference_attention(q, k, v, **kw)):
            witness = wit.step().float()
        check(len(calls) == want_calls, f"{label}: {len(calls)} attention "
              f"calls in a step, want {want_calls}")
        bad = [c for c in calls if not (c[1] <= TOL[c[0]]
                                        and c[2] <= FLASH_REL_TOL[c[0]])]
        check(not bad, f"{label}: attention calls of the step off the plain "
              f"version past TOL / FLASH_REL_TOL: {bad}")
        with host_int_decode(S):
            old, _ = M.decode_step(cfg, engine.params, pre.tok, S,
                                   pre.caches)
        old_diff = (old.float() - want_logits.float()).abs().max().item()
        old_argmax = bool(torch.equal(old.argmax(-1), want_logits.argmax(-1)))
        wit_rec = {}
        for name, x in (("graph", want_logits), ("host_int", old)):
            d = (x.float() - witness).abs()
            wit_rec[name] = {"mean_abs_err": d.mean().item(),
                             "max_abs_err": d.max().item(),
                             "argmax_equal": bool(torch.equal(
                                 x.argmax(-1), witness.argmax(-1)))}
        wit_rec["margin"] = WITNESS_MARGIN
        check(wit_rec["graph"]["mean_abs_err"]
              <= WITNESS_MARGIN * wit_rec["host_int"]["mean_abs_err"],
              f"{label}: the graph step is further from the witness than "
              f"{WITNESS_MARGIN} x the host-int step: {wit_rec}")
        del chk, wit
        del snap, pre, eager_state
    rec = {"arch": cfg.name, "batch": B, "prompt": S, "n_new": n_new,
           "layers": cfg.n_layers, "launches": launches,
           "python_launches": eager, "replays": replays,
           "port_kernels_per_replay": per, "kernels_per_replay": total,
           "request_syncs_in_replays": syncs, "replay_bit_equal": bit_equal,
           "replay_ms_per_token": replay_ms,
           "request_syncs": req_syncs,
           "host_int_logits_max_abs_diff": old_diff,
           "host_int_argmax_equal": old_argmax,
           "attention_calls_held": len(calls),
           "attention_max_abs_err": max((c[1] for c in calls), default=None),
           "attention_max_rel_err": max((c[2] for c in calls), default=None),
           "witness": wit_rec,
           "generate_ms": gen_s * 1e3, "max_memory_allocated": peak,
           "first_ids": ids[0, :8].tolist()}
    # the device's busy share of one more request (the graph captured)
    t0 = time.perf_counter()
    engine.generate(prompts, n_new, frames=frames)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(torch, lambda: engine.generate(prompts, n_new,
                                                         frames=frames))
    prof.update(n_new=n_new, wall_ms=wall_ms,
                device_busy_share=prof["device_ms"] / wall_ms)
    return rec, launches, prof


def phase_serve(torch, cfg, params_f32):
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    B, S, n_new = 4, 128, 32
    params = cast(params_f32, "cuda", torch.bfloat16)
    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    rec, launches, prof = graph_decode(
        torch, "serve", cfg, engine, prompts, n_new,
        {"flash_attention": cfg.n_layers})

    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    batch = {"tokens": toks,
             "positions": torch.arange(S, device="cuda").expand(B, S)}
    with torch.inference_mode():
        prefill_ms = eager_ms(torch, lambda: M.prefill(cfg, engine.params,
                                                       batch), reps=5)
    gen_ms = rec["generate_ms"]
    emit("serve", dtype="bfloat16",
         flash_launches=launches.get("flash_attention", 0),
         prefill_ms=prefill_ms,
         decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
         tokens_per_s=B * n_new / (gen_ms / 1e3), **rec)
    emit("serve_profile", **prof)
    return launches


def phase_parity(torch, cfg, params_f32):
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    S, n_new = 64, 8
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=(1, S), dtype=np.int32)
    cpu = ServeEngine(cfg, params_f32, max_len=S + n_new, device="cpu")
    gpu = ServeEngine(cfg, cast(params_f32, "cuda", torch.float32),
                      max_len=S + n_new)
    logits = {}
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=eng.device)
        batch = {"tokens": toks,
                 "positions": torch.arange(S, device=eng.device)[None]}
        with torch.inference_mode():
            logits[name] = M.prefill(cfg, eng.params, batch)[0].float().cpu()
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    ids_cpu = cpu.generate(prompt, n_new)
    ids_gpu = gpu.generate(prompt, n_new)
    # a sampled request: the card's graph splits the key and draws
    sampled = [eng.generate(prompt, n_new, temperature=SAMPLE_T,
                            seed=SAMPLE_SEED) for eng in (cpu, gpu)]
    check_replays(gpu, n_new, "serve_parity")
    same = bool(np.array_equal(ids_cpu, ids_gpu))
    same_t = bool(np.array_equal(*sampled))
    top2 = torch.topk(logits["cpu"][0], 2).values
    rec = {"dtype": "float32", "prompt": S, "n_new": n_new,
           "logits_max_abs_err": err, "tol": PARITY_LOGIT_ATOL,
           "ids_equal": same, "ids_cpu": ids_cpu[0].tolist(),
           "ids_cuda": ids_gpu[0].tolist(),
           "temperature": SAMPLE_T, "sample_seed": SAMPLE_SEED,
           "sampled_ids_equal": same_t,
           "sampled_ids_cpu": sampled[0][0].tolist(),
           "sampled_ids_cuda": sampled[1][0].tolist(),
           "graphs": [list(k) for k in gpu.graphs],
           "first_logit_gap": (top2[0] - top2[1]).item()}
    emit("serve_parity", **rec)
    check(err <= PARITY_LOGIT_ATOL,
          f"prefill logits differ by {err} > {PARITY_LOGIT_ATOL}")
    check(same, "greedy ids differ between the CPU and the card")
    check(same_t, f"ids at temperature {SAMPLE_T} differ between the CPU "
          f"and the card")


def _allclose_excess(torch, got, want, atol, rtol):
    """max(|got - want| - rtol |want|): at most ``atol`` when allclose."""
    d = (got.float() - want.float()).abs() - rtol * want.float().abs()
    return d.max()


AGG_CASES_W = (2, 8, 158)
AGG_CASES_N = (1, 1000, 1 << 20)
FULL_N = 494_032_768           # qwen2-0.5b parameters (tied head)


def _agg_masks(torch, W, gen):
    bits = (torch.arange(W, device="cuda") % 3 != 0).float()
    frac = torch.rand(W, generator=gen, device="cuda")
    return {"bits": bits, "fractional": frac,
            "zero": torch.zeros(W, device="cuda")}


def _agg_times(torch, side, g, mask, reps, mean=True):
    """Kernel / plain / library / bound ms of the mean (or, ``mean=False``,
    the sum mode: the library call ``mask @ g`` alone).  Both modes read
    and write the same bytes, so they share a bound."""
    from repro_torch.kernels.masked_grad_agg import masked_grad_agg
    from repro_torch.kernels.ref import reference_masked_agg

    W, N = g.shape
    m2 = mask.reshape(1, W).to(g.dtype)
    c = torch.clamp(mask.sum(), min=1.0)
    fns = {"ms": lambda: masked_grad_agg(g, mask, mean=mean),
           "plain_ms": lambda: reference_masked_agg(
               g, mask.reshape(-1, 1), mean=mean),
           "library_ms": ((lambda: (m2 @ g) / c) if mean
                          else (lambda: m2 @ g))}
    times = {k: device_ms(torch, f, side, reps=reps) for k, f in fns.items()}
    elt = g.element_size()
    nbytes = W * N * elt + N * elt + 4 * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * W * N / PEAK_OPS["float32"] * 1e3
    return dict(times, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)


def phase_masked_agg(torch):
    from repro_torch.kernels.masked_grad_agg import (MAX_WORKERS,
                                                      masked_grad_agg)
    from repro_torch.kernels.ref import reference_masked_agg

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    side = torch.cuda.Stream()
    worst, worst_sum, cases = 0.0, 0.0, 0
    for dtname in ("float32", "bfloat16"):
        dt = getattr(torch, dtname)
        for W in AGG_CASES_W:
            for N in AGG_CASES_N:
                g = torch.randn(W, N, generator=gen, device="cuda").to(dt)
                for (mname, mask), mean in itertools.product(
                        _agg_masks(torch, W, gen).items(), (True, False)):
                    mode = "mean" if mean else "sum"
                    out = masked_grad_agg(g, mask, mean=mean)
                    want = reference_masked_agg(g, mask.reshape(-1, 1),
                                                mean=mean)[0]
                    check(out.shape == (N,) and out.dtype == dt,
                          f"masked_grad_agg {mode} {W}x{N} {dtname}: "
                          f"output {tuple(out.shape)} {out.dtype}")
                    tol = AGG_TOL[dtname]
                    ex = _allclose_excess(torch, out, want, tol, tol).item()
                    check(ex <= tol, f"masked_grad_agg {mode} {W}x{N} "
                          f"{dtname} {mname} mask: off by {ex} beyond rtol "
                          f"> {tol}")
                    if mname == "zero":
                        check(bool((out == 0).all()), "masked_grad_agg: an "
                              "all-zero mask must give exact zeros")
                    err = (out.float() - want.float()).abs().max().item()
                    if mean:
                        worst = max(worst, err)
                    else:
                        worst_sum = max(worst_sum, err)
                    cases += 1
                del g
    # the worker limit: the kernel takes MAX_WORKERS rows and refuses more
    g = torch.randn(MAX_WORKERS + 1, 1000, generator=gen, device="cuda")
    mask = _agg_masks(torch, MAX_WORKERS + 1, gen)["fractional"]
    out = masked_grad_agg(g[:-1], mask[:-1])
    want = reference_masked_agg(g[:-1], mask[:-1].reshape(-1, 1))[0]
    ex = _allclose_excess(torch, out, want, AGG_TOL["float32"],
                          AGG_TOL["float32"]).item()
    check(ex <= AGG_TOL["float32"], f"masked_grad_agg at the worker limit "
          f"{MAX_WORKERS}: off by {ex}")
    worst = max(worst, (out - want).abs().max().item())
    cases += 1
    try:
        masked_grad_agg(g, mask)
    except ValueError:
        pass
    else:
        raise RuntimeError(f"masked_grad_agg took {MAX_WORKERS + 1} workers")
    del g, out, want
    emit("masked_grad_agg", checked_cases=cases, max_abs_err=worst,
         sum_max_abs_err=worst_sum, max_workers=MAX_WORKERS)

    results = {}
    timed = [("w158_n2^20_f32", 158, 1 << 20, "float32", 20),
             ("w8_n2^20_bf16", 8, 1 << 20, "bfloat16", 20),
             ("full_w8_f32", 8, FULL_N, "float32", 5)]
    for name, W, N, dtname, reps in timed:
        dt = getattr(torch, dtname)
        g = torch.randn(W, N, generator=gen, device="cuda", dtype=dt)
        mask = _agg_masks(torch, W, gen)["bits"]
        out = masked_grad_agg(g, mask)
        want = reference_masked_agg(g, mask.reshape(-1, 1))[0]
        err = (out.float() - want.float()).abs().max().item()
        tol = AGG_TOL[dtname]
        ex = _allclose_excess(torch, out, want, tol, tol).item()
        check(ex <= tol, f"masked_grad_agg {name}: off by {ex} > {tol}")
        del out, want
        torch.cuda.empty_cache()
        rec = {"case": name, "W": W, "N": N, "dtype": dtname,
               "max_abs_err": err, "tol": tol,
               **_agg_times(torch, side, g, mask, reps)}
        results[name] = rec
        emit("masked_grad_agg", **rec)
        if name == AGG_HEADLINE:
            # the sum mode, a data-parallel rank's share of the combine
            out = masked_grad_agg(g, mask, mean=False)
            want = reference_masked_agg(g, mask.reshape(-1, 1),
                                        mean=False)[0]
            err = (out.float() - want.float()).abs().max().item()
            ex = _allclose_excess(torch, out, want, tol, tol).item()
            check(ex <= tol, f"masked_grad_agg sum {name}: off by {ex} > "
                  f"{tol}")
            del out, want
            torch.cuda.empty_cache()
            rec = {"case": name, "mode": "sum", "W": W, "N": N,
                   "dtype": dtname, "max_abs_err": err, "tol": tol,
                   **_agg_times(torch, side, g, mask, reps, mean=False)}
            results[AGG_SUM_HEADLINE] = rec
            emit("masked_grad_agg", **rec)
            worst_sum = max(worst_sum, err)
        del g
        torch.cuda.empty_cache()
    results["shard_major"] = _shard_major_agg(torch, gen, side)
    torch.cuda.empty_cache()
    return results, worst, worst_sum


# the shard checks' tree: qwen2-0.5b's two MLP shapes (dim 0 divisible by
# every shard count), and leaves no count divides on dim 0 (sharded on
# dim 1) or on any dim (replicated)
SHARD_LEAVES = {"a": (896, 4864), "b": (4864, 896), "c": (3, 1024),
                "d": (5, 7), "e": (896,), "f": (7, 8, 64)}
SHARD_COUNTS = (2, 4, 8)


class ShapeMesh:
    """A shape-only ("data", "model") mesh on which this process sits at
    ``coords``: what ``dist.sharding.shard_plan`` reads of a mesh."""
    axis_names = ("data", "model")

    def __init__(self, shape, coords=(0, 0)):
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, coords))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def _shard_plan(torch, like, T, D=1, coords=(0, 0), zero1=False):
    from repro_torch.dist import sharding as shd

    lay = shd.make_layout(ShapeMesh((D, T), coords), "train_fsdp")
    return shd.shard_plan(like, lay, zero1=zero1)


def _shard_major_agg(torch, gen, side):
    """The kernel's sum over an (8, N) buffer laid out shard-major
    (``ops.WorkerGrads`` on a ``ShardPlan``) at 2, 4 and 8 shards, zero1
    off and on (D 2): each leaf's columns of the result against the
    natural-order sum's leaf viewed the same way, bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.masked_grad_agg import masked_grad_agg

    W = 8
    like = {k: torch.empty(sh, device="cuda")
            for k, sh in SHARD_LEAVES.items()}
    nat = ops.WorkerGrads(like, W)
    nat.buf.copy_(torch.randn(nat.buf.shape, generator=gen, device="cuda"))
    mask = _agg_masks(torch, W, gen)["fractional"]
    want = nat._split(masked_grad_agg(nat.buf, mask, mean=False))
    out = {"N": nat.buf.shape[1], "W": W, "cases": 0}
    for T, zero1 in itertools.product(SHARD_COUNTS, (False, True)):
        plan = _shard_plan(torch, like, T, 2, zero1=zero1)
        sm = ops.WorkerGrads(like, W, plan=plan)
        for w in range(W):
            for i in range(len(plan.leaves)):
                sm.rows[w][i].copy_(sm.fit(i, nat.rows[w][i]))
        got = masked_grad_agg(sm.buf, mask, mean=False)
        equal = all(torch.equal(plan.columns(i, got), plan.split(i, x))
                    for i, x in enumerate(want))
        check(equal, f"masked_grad_agg: the shard-major sum at {T} shards "
              f"(zero1 {zero1}) is not the natural sum, permuted")
        dims = sorted({str(leaf.dim) for leaf in plan.leaves})
        check(dims == ["0", "1", "None"], f"shard plan dims {dims}")
        out["cases"] += 1
        if T == 8 and not zero1:
            out["ms"] = device_ms(torch, lambda: masked_grad_agg(
                sm.buf, mask, mean=False), side)
            out["natural_ms"] = device_ms(torch, lambda: masked_grad_agg(
                nat.buf, mask, mean=False), side)
            # the W rows read once, the sum written once (f32)
            out["bound_ms"] = ((W + 1) * out["N"] * 4 / HBM_BYTES_PER_S
                               * 1e3)
            out["bound_by"] = "bytes"
        del sm, got
    out["bit_equal"] = True
    emit("masked_grad_agg", case="shard_major", shards=SHARD_COUNTS, **out)
    return out


def _shard_adam(torch, gen):
    """One fused_adam launch over a rank's slices (each a contiguous copy,
    as a ZeRO-3 rank holds them) at 2, 4 and 8 shards, every rank: its p,
    m and v against the slices of one launch over the full leaves, bit
    for bit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import fused_adam_

    shapes = list(SHARD_LEAVES.values())
    ps, gs, ms, vs = _adam_inputs(torch, shapes, torch.bfloat16, gen)
    scal = ops.adam_scalars(4, 1e-3, 0.9, 0.999)
    full = [[x.clone() for x in t] for t in (ps, ms, vs)]
    fused_adam_(full[0], gs, full[1], full[2], scal, wd=0.01)
    like = dict(zip(SHARD_LEAVES, ps))
    ranks = 0
    for T in SHARD_COUNTS:
        for s in range(T):
            plan = _shard_plan(torch, like, T, coords=(0, s))

            def cut(t):
                return [torch.empty_like(plan.slice_of(i, x),
                                         memory_format=torch.contiguous_format)
                        .copy_(plan.slice_of(i, x)) for i, x in enumerate(t)]

            sp, sg, sm, sv = cut(ps), cut(gs), cut(ms), cut(vs)
            fused_adam_(sp, sg, sm, sv, scal, wd=0.01)
            for got, want in zip((sp, sm, sv), full):
                check(all(torch.equal(a, plan.slice_of(i, b))
                          for i, (a, b) in enumerate(zip(got, want))),
                      f"fused_adam: rank {s} of {T} shards differs from the "
                      f"full update's slice")
            ranks += 1
    rec = {"shards": SHARD_COUNTS, "ranks": ranks, "leaves": len(shapes),
           "bit_equal": True}
    emit("fused_adam", case="shard_views", **rec)
    return rec


def _adam_inputs(torch, shapes, p_dt, gen, offset=()):
    """Random p, g, m, v leaves; the leaves whose index is in ``offset``
    start one element past an aligned address (the kernel's scalar path)."""
    def rand(i, shape, dt, scale=1.0):
        x = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)
        if i not in offset:
            return x
        y = torch.empty(x.numel() + 1, dtype=dt, device="cuda")[1:]
        return y.view(shape).copy_(x)

    ps = [rand(i, s, p_dt) for i, s in enumerate(shapes)]
    gs = [rand(i, s, p_dt) for i, s in enumerate(shapes)]
    ms = [rand(i, s, torch.float32, 0.1) for i, s in enumerate(shapes)]
    vs = [rand(i, s, torch.float32, 0.01).abs_() for i, s in enumerate(shapes)]
    return ps, gs, ms, vs


def _adam_check(torch, ps, gs, ms, vs, step, wd, dtname):
    """One kernel step on copies of the leaves against reference_adam,
    leaf by leaf; returns the max abs error of p, m and v."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import fused_adam_
    from repro_torch.kernels.ref import reference_adam

    scal = ops.adam_scalars(step - 1, 1e-3, 0.9, 0.999)
    kp = [x.clone() for x in ps]
    km = [x.clone() for x in ms]
    kv = [x.clone() for x in vs]
    fused_adam_(kp, gs, km, kv, scal, wd=wd)
    errs = {"p": [], "m": [], "v": []}
    excess = {"p": [], "m": [], "v": []}
    for i in range(len(ps)):
        wp, wm, wv = reference_adam(ps[i], gs[i], ms[i], vs[i], scal, wd=wd)
        for key, got, want in (("p", kp[i], wp), ("m", km[i], wm),
                               ("v", kv[i], wv)):
            errs[key].append((got.float() - want.float()).abs().max())
            atol, rtol = ((ADAM_TOL["p"][dtname], 0.0) if key == "p"
                          else ADAM_TOL[key])
            excess[key].append(_allclose_excess(torch, got, want, atol, rtol)
                               - atol)
        del wp, wm, wv
    err = {k: torch.stack(v).max().item() for k, v in errs.items()}
    over = {k: torch.stack(v).max().item() for k, v in excess.items()}
    for k in over:
        check(over[k] <= 0.0, f"fused_adam {dtname} step {step} wd {wd}: "
              f"{k} beyond tolerance by {over[k]}")
    return err


def _adam_grid_shapes(shapes):
    """The correctness grid's leaves: each distinct shape of the model up
    to 2^24 elements (every layer leaf; not the embedding), and ragged
    sizes around the kernel's chunk of 4096 elements."""
    from repro_torch.kernels.fused_adam import CHUNK

    distinct = [s for s in dict.fromkeys(shapes) if np.prod(s) <= 1 << 24]
    return distinct + [(1,), (3,), (CHUNK - 1,), (CHUNK + 5,),
                       (7, 3 * CHUNK + 1)]


def phase_fused_adam(torch, shapes):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import LeafTable, fused_adam_
    from repro_torch.kernels.ref import reference_adam

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    side = torch.cuda.Stream()
    worst = 0.0
    # the grid of steps and weight decays on a subset of leaves that holds
    # every layer shape, ragged chunk tails and unaligned leaves
    grid = _adam_grid_shapes(shapes)
    offset = set(range(len(grid) - 3, len(grid)))
    for dtname in ("bfloat16", "float32"):
        ps, gs, ms, vs = _adam_inputs(torch, grid, getattr(torch, dtname),
                                      gen, offset)
        for step in (1, 100):
            for wd in (0.0, 0.01):
                err = _adam_check(torch, ps, gs, ms, vs, step, wd, dtname)
                worst = max(worst, *err.values())
                emit("fused_adam", dtype=dtname, step=step, wd=wd,
                     leaves=len(ps), unaligned=len(offset),
                     params=sum(x.numel() for x in ps), max_abs_err=err,
                     tol={"p": ADAM_TOL["p"][dtname], "m": ADAM_TOL["m"],
                          "v": ADAM_TOL["v"]})
        del ps, gs, ms, vs

    # the full-width leaves, as the train step hands them in (bf16 p and
    # g, f32 m and v): one checked step, then the times
    n_params = sum(int(np.prod(s)) for s in shapes)
    results = {}
    dtname = "bfloat16"
    p_dt = getattr(torch, dtname)
    ps, gs, ms, vs = _adam_inputs(torch, shapes, p_dt, gen)
    err = _adam_check(torch, ps, gs, ms, vs, 1, 0.01, dtname)
    worst = max(worst, *err.values())
    # times: in place on the same leaves, as the optimizer runs it
    scal = ops.adam_scalars(0, 1e-3, 0.9, 0.999)
    table = LeafTable()
    lib_params = [x.clone() for x in ps]
    for lp, g in zip(lib_params, gs):
        lp.grad = g
    lib = torch.optim.AdamW(lib_params, lr=1e-3, weight_decay=0.01,
                            fused=True, capturable=True)
    fns = {"ms": lambda: fused_adam_(ps, gs, ms, vs, scal, wd=0.01,
                                     table=table),
           "plain_ms": lambda: [reference_adam(p, g, m, v, scal, wd=0.01)
                                for p, g, m, v in zip(ps, gs, ms, vs)],
           "library_ms": lib.step}
    # the plain version: 290 leaves x ~15 ops a call, few calls a graph
    times = {k: device_ms(torch, f, side, reps=3 if k == "plain_ms"
                          else 10) for k, f in fns.items()}
    times["eager_ms"] = eager_ms(torch, fns["ms"], reps=10)
    times["eager_library_ms"] = eager_ms(torch, lib.step, reps=10)
    pe = ps[0].element_size()
    nbytes = n_params * (2 * pe + pe + 2 * 4 * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * n_params / PEAK_OPS["float32"] * 1e3
    rec = {"case": f"full_{dtname}", "leaves": len(ps),
           "params": n_params, "dtype": dtname, "step": 1, "wd": 0.01,
           "max_abs_err": err, **times,
           "library": f"torch.optim.AdamW(fused=True, capturable=True), "
                      f"{dtname} params, grads and moments",
           "table_uploads": table.uploads,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    results[rec["case"]] = rec
    emit("fused_adam", **rec)
    del ps, gs, ms, vs, lib_params, lib, fns
    torch.cuda.empty_cache()
    results["shard_views"] = _shard_adam(torch, gen)
    torch.cuda.empty_cache()
    return results, worst


def _train_setup(torch, cfg, params, *, n_workers, seq, batch, controller,
                 timer, record=None, metrics_out=None, opt=None,
                 step_fn=None, data=None):
    """A psum Trainer with the slice's optimizer; ``record``, when given,
    is called with each step's aggregated gradient on its device;
    ``metrics_out`` (a list) receives each step's device ``aux`` and
    ``ce``.  ``opt`` and ``step_fn`` are reused when given (one (W, N)
    buffer for two runs).  ``data`` defaults to SyntheticTokens; an
    encoder-decoder or a vision arch gets ``MediaTokens``."""
    from repro_torch import optim
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import Trainer, make_train_step

    if opt is None:
        opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
        if record is not None:
            inner = opt

            def update(grads, state, params_=None):
                record(grads)
                return inner.update(grads, state, params_)

            opt = optim.Optimizer(inner.init, update)
    if step_fn is None:
        step_fn = make_train_step(cfg, opt, mask_agg="psum")
    run_fn = step_fn
    if metrics_out is not None:
        def run_fn(state, b):
            state, m = step_fn(state, b)
            metrics_out.append({k: m[k] for k in ("aux", "ce")})
            return state, m

        run_fn.hold, run_fn.buffers = step_fn.hold, step_fn.buffers
    if data is None:
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, seed=SEED)
    tr = Trainer(step_fn=run_fn, data=data, controller=controller,
                 timer=timer, n_workers=n_workers, mask_agg="psum",
                 metrics_every=1)
    tr.restore_or_init(lambda: {"params": params, "opt": opt.init(params)})
    return tr, opt


def phase_train(torch, cfg, params_f32):
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import FirstKController
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step

    W, S, B, n_steps = 8, 128, 16, TRAIN_STEPS
    t_setup = time.perf_counter()
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, opt = _train_setup(torch, cfg, params, n_workers=W, seq=S, batch=B,
                           controller=FirstKController(W, backup=2),
                           timer=ClusterSim(n_workers=W, n_nodes=2, seed=7))
    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals, clocks, walls_ms = {}, [], []
    torch.cuda.synchronize()
    seconds = {"setup": time.perf_counter() - t_setup}
    t_steps = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_steps):
        build.LAUNCHES.clear()
        uploads = opt.table.uploads
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        uploads = opt.table.uploads - uploads
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        check(launches == want, f"psum step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"step {rec['step']}: loss {rec['loss']}")
        clocks.append(rec["clock"])
        walls_ms.append(wall * 1e3)
        emit("train", mask_agg="psum", step=rec["step"], wall_ms=wall * 1e3,
             tokens_per_s=B * S / wall, c=rec["c"], n=rec["n"],
             loss=rec["loss"], clock=rec["clock"], launches=launches,
             leaf_table_uploads=uploads,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    seconds["psum_steps"] = time.perf_counter() - t_steps

    # the device's busy share of one more psum step
    t_prof = time.perf_counter()
    wall = []

    def one_step():
        t0 = time.perf_counter()
        tr.run(1)
        wall.append((time.perf_counter() - t0) * 1e3)

    prof = device_profile(torch, one_step)
    seconds["profile"] = time.perf_counter() - t_prof
    # the parameters after every psum step, for train_dp
    psum_params = [x.clone() for x in tree.leaves(tr.state["params"])]
    emit("train_profile", mask_agg="psum", wall_ms=wall[0],
         device_busy_share=prof["device_ms"] / wall[0],
         seconds=seconds["profile"], **prof)

    # one step of the weights path, from the same state and optimizer
    t_weights = time.perf_counter()
    tr.step_fn = make_train_step(cfg, opt, mask_agg="weights")
    tr.mask_agg = "weights"
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    rec = tr.run(1)[-1]
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want_w = {"flash_attention": cfg.n_layers, "fused_adam": 1}
    check(launches == want_w, f"weights step: launches {launches}, "
          f"want {want_w}")
    check(bool(np.isfinite(rec["loss"])), f"weights step: loss {rec['loss']}")
    emit("train", mask_agg="weights", step=rec["step"], wall_ms=wall * 1e3,
         tokens_per_s=B * S / wall, c=rec["c"], n=rec["n"], loss=rec["loss"],
         launches=launches, leaves=len(tree.leaves(params)),
         psum_max_memory_allocated=peak,
         seconds=dict(seconds, weights_step=time.perf_counter() - t_weights))
    final_params = tree.leaves(tr.state["params"])
    del tr, opt, params
    torch.cuda.empty_cache()
    return totals, clocks, {"psum": psum_params, "final": final_params,
                            "psum_wall_ms": float(np.median(walls_ms))}


TRAIN_STEPS = 3   # train's psum steps before its profiled one
COLLECTIVE_REPS = 10


def phase_train_dp(torch, cfg, params_f32, ref):
    """train's setup, seeds and schedule through the data-parallel path:
    an NCCL process group of world size 1 (every collective still runs), a
    ("data",) mesh and a pure data-parallel layout, W 8 on the one rank.
    The psum steps (the kernel's sum mode, one all-reduce, the division),
    then one weights step (one all-reduce of the bf16 gradient); each
    step's launch counts, the cutoff broadcast from rank 0, and the
    parameters against train's one-process run (``ref``), bit for bit:
    at world size 1 every sum runs in the same order.  Then the
    collectives alone: the all-reduces of both paths and the broadcast,
    ms beside the step's, and the weights path's gradient all-reduced one
    leaf at a time as a comparison."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    t_setup = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        init_distributed("cuda", init_method=f"file://{d}/pg", rank=0,
                         world_size=1)
        try:
            return _train_dp(torch, cfg, params_f32, ref, t_setup)
        finally:
            dist.destroy_process_group()


def _train_dp(torch, cfg, params_f32, ref, t_setup):
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import FirstKController
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _dp, make_train_step

    W, S, B = 8, 128, 16
    mesh = make_mesh((1,), ("data",))
    lay = shd.Layout(mesh=mesh, mode="train_fsdp", dp=("data",))
    check(lay.dp_size == 1 and lay.n_shards == 1, f"train_dp layout {lay}")
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, opt = _train_setup(torch, cfg, params, n_workers=W, seq=S, batch=B,
                           controller=FirstKController(W, backup=2),
                           timer=ClusterSim(n_workers=W, n_nodes=2, seed=7))
    torch.cuda.synchronize()
    seconds = {"setup": time.perf_counter() - t_setup}
    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg_sum": 1,
            "fused_adam": 1}
    totals, walls = {}, []
    calls = {"all_reduce": 0, "broadcast": 0}
    real = {k: getattr(dist, k) for k in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    t_steps = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for k in calls:
        setattr(dist, k, counting(k))
    try:
        for _ in range(TRAIN_STEPS + 1):
            build.LAUNCHES.clear()
            before = dict(calls)
            t0 = time.perf_counter()
            with shd.use_layout(lay):
                rec = tr.run(1)[-1]
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            check(launches == want, f"dp psum step {rec['step']}: launches "
                  f"{launches}, want {want}")
            # one broadcast (the decision), two all-reduces (the gradient
            # with c; loss, ce and aux)
            made = {k: calls[k] - before[k] for k in calls}
            check(made == {"all_reduce": 2, "broadcast": 1},
                  f"dp psum step {rec['step']}: collectives {made}")
            check(bool(np.isfinite(rec["loss"])),
                  f"dp step {rec['step']}: loss {rec['loss']}")
            walls.append(wall * 1e3)
            emit("train_dp", mask_agg="psum", step=rec["step"],
                 wall_ms=wall * 1e3, c=rec["c"], n=rec["n"],
                 loss=rec["loss"], clock=rec["clock"], launches=launches,
                 collectives=made)
        peak = torch.cuda.max_memory_allocated()
        got = tree.leaves(tr.state["params"])
        psum_equal = all(torch.equal(a, b) for a, b in zip(got, ref["psum"]))
        psum_gap = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, ref["psum"]))
        seconds["psum_steps"] = time.perf_counter() - t_steps

        t_w = time.perf_counter()
        tr.step_fn = make_train_step(cfg, opt, mask_agg="weights")
        tr.mask_agg = "weights"
        build.LAUNCHES.clear()
        before = dict(calls)
        t0 = time.perf_counter()
        with shd.use_layout(lay):
            rec = tr.run(1)[-1]
        w_wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        want_w = {"flash_attention": cfg.n_layers, "fused_adam": 1}
        check(launches == want_w, f"dp weights step: launches {launches}, "
              f"want {want_w}")
        made = {k: calls[k] - before[k] for k in calls}
        # one dtype (bf16) of gradients: one all-reduce, and the metrics'
        check(made == {"all_reduce": 2, "broadcast": 1},
              f"dp weights step: collectives {made}")
    finally:
        for k in calls:
            setattr(dist, k, real[k])
    # the decision's broadcast queues its upload and the collective and
    # waits for neither on rank 0: no synchronizing call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with shd.use_layout(lay):
            tr._broadcast_decision(W, 6, np.full(W, 0.5, np.float32),
                                   1.25, _dp(lay))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = tree.leaves(tr.state["params"])
    final_equal = all(torch.equal(a, b) for a, b in zip(got, ref["final"]))
    final_gap = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, ref["final"]))
    emit("train_dp", mask_agg="weights", step=rec["step"],
         wall_ms=w_wall * 1e3, c=rec["c"], loss=rec["loss"],
         launches=launches, collectives=made)
    seconds["weights_step"] = time.perf_counter() - t_w
    check(psum_equal, f"train_dp: the psum steps' parameters differ from "
          f"train's (max |diff| {psum_gap})")
    check(final_equal, f"train_dp: the weights step's parameters differ "
          f"from train's (max |diff| {final_gap})")
    n = sum(x.numel() for x in got)
    shapes = [x.shape for x in got]
    del tr, opt, params, got
    torch.cuda.empty_cache()

    # the collectives alone, as a step makes them (eager: host launch
    # included), at world size 1
    t_c = time.perf_counter()
    total = torch.zeros(n + 1, dtype=torch.float32, device="cuda")
    flat = torch.zeros(n, dtype=torch.bfloat16, device="cuda")
    # one collective a leaf instead, the design the flat buffer replaced
    leaves = [flat[:math.prod(sh)].view(sh) for sh in shapes]
    vec = torch.zeros(W + 3, dtype=torch.float64, device="cuda")
    group = mesh.group(("data",))
    times = {
        "all_reduce_psum_ms": eager_ms(
            torch, lambda: dist.all_reduce(total, group=group),
            reps=COLLECTIVE_REPS),
        "all_reduce_weights_ms": eager_ms(
            torch, lambda: dist.all_reduce(flat, group=group),
            reps=COLLECTIVE_REPS),
        "all_reduce_per_leaf_ms": eager_ms(
            torch, lambda: [dist.all_reduce(x, group=group) for x in leaves],
            reps=COLLECTIVE_REPS),
        "broadcast_ms": eager_ms(
            torch, lambda: dist.broadcast(vec, src=0, group=group),
            reps=COLLECTIVE_REPS)}
    del total, flat, leaves, vec
    torch.cuda.empty_cache()
    seconds["collectives"] = time.perf_counter() - t_c
    step_ms = float(np.median(walls))
    rec = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "W": W, "params": n,
           "psum_bit_equal": psum_equal, "psum_max_abs_diff": psum_gap,
           "weights_bit_equal": final_equal,
           "weights_max_abs_diff": final_gap,
           "psum_wall_ms": step_ms, "train_psum_wall_ms": ref["psum_wall_ms"],
           "weights_wall_ms": w_wall * 1e3,
           "all_reduce_share_of_psum_step": times["all_reduce_psum_ms"]
           / step_ms,
           "max_memory_allocated": peak, "seconds": seconds, **times}
    emit("train_dp", **rec)
    return totals, rec


def phase_train_zero3(torch, cfg, params_f32, ref):
    """train's setup, seeds and schedule through the ZeRO-3 path: an NCCL
    process group of world size 1, a (1, 1) ("data", "model") mesh in
    ``train_fsdp`` (a model axis of one shard: every gather,
    reduce-scatter and all-reduce still runs), W 8 on the one rank.  Two
    runs, zero1 off and on, each 4 psum steps (the block gathers, each
    worker's full gradient into the shard-major buffer, one sum-mode
    kernel launch, the reduce-scatter, the sums, one fused Adam launch)
    then one weights step; each step's kernel launches and collectives
    counted, and the gathered parameters held against train's
    one-process run (``ref``, which train_dp holds too), bit for bit.
    Then the collectives alone at the step's sizes, ms beside the
    step's."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.launch.mesh import init_distributed

    t_setup = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        init_distributed("cuda", init_method=f"file://{d}/pg", rank=0,
                         world_size=1)
        try:
            return _train_zero3(torch, cfg, params_f32, ref, t_setup)
        finally:
            collectives.Zero3._cache.clear()
            dist.destroy_process_group()


ZERO3_COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce",
                     "broadcast")


def _train_zero3(torch, cfg, params_f32, ref, t_setup):
    import torch.distributed as dist

    from repro_torch import optim, tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import FirstKController
    from repro_torch.dist import collectives
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import gather_state, make_train_step

    W, S, B, L = 8, 128, 16, cfg.n_layers
    mesh = make_mesh((1, 1), ("data", "model"))
    lay = shd.make_layout(mesh, "train_fsdp")
    check(shd.is_zero3(lay) and lay.n_shards == 1 and lay.dp_size == 1,
          f"train_zero3 layout {lay}")
    # a forward gathers each block, the embedding twice (the tied head)
    # and the final norm; the backward's recompute each block again
    per_forward = 2 * L + 3
    seconds = {"setup": time.perf_counter() - t_setup}
    calls = {k: 0 for k in ZERO3_COLLECTIVES}
    real = {k: getattr(dist, k) for k in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    def one_step(tr, label, want, zero1, workers):
        build.LAUNCHES.clear()
        before = dict(calls)
        t0 = time.perf_counter()
        with shd.use_layout(lay):
            rec = tr.run(1)[-1]
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        check(launches == want, f"train_zero3 {label} step {rec['step']}: "
              f"launches {launches}, want {want}")
        made = {k: calls[k] - before[k] for k in calls}
        check(made["reduce_scatter"] == 1 + zero1
              and made["all_gather"] == workers * per_forward + zero1
              and made["broadcast"] == 1 and made["all_reduce"] >= 2,
              f"train_zero3 {label} step {rec['step']}: collectives {made}")
        check(bool(np.isfinite(rec["loss"])),
              f"train_zero3 {label} step {rec['step']}: loss {rec['loss']}")
        emit("train_zero3", zero1=zero1, mask_agg=label, step=rec["step"],
             wall_ms=wall * 1e3, c=rec["c"], loss=rec["loss"],
             launches=launches, collectives=made)
        return rec, launches, wall * 1e3

    totals, runs, keep = {}, {}, None
    for k in calls:
        setattr(dist, k, counting(k))
    try:
        for zero1 in (False, True):
            t_run = time.perf_counter()
            params = cast(params_f32, "cuda", torch.bfloat16)
            opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
            step_fn = make_train_step(cfg, opt, mask_agg="psum", zero1=zero1)
            with shd.use_layout(lay):
                tr, _ = _train_setup(
                    torch, cfg, params, n_workers=W, seq=S, batch=B,
                    controller=FirstKController(W, backup=2),
                    timer=ClusterSim(n_workers=W, n_nodes=2, seed=7),
                    opt=opt, step_fn=step_fn)
            del params
            plan = step_fn.plan_for(lay)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            want = {"flash_attention": 2 * L * W, "masked_grad_agg_sum": 1,
                    "fused_adam": 1}
            for _ in range(TRAIN_STEPS + 1):
                _, launches, wall = one_step(tr, "psum", want, zero1, W)
                walls.append(wall)
                for k, v in launches.items():
                    totals[k] = totals.get(k, 0) + v
            peak = torch.cuda.max_memory_allocated()
            with shd.use_layout(lay):
                got = tree.leaves(gather_state(tr.state, plan,
                                               lay)["params"])
            psum_equal = all(torch.equal(a, b)
                             for a, b in zip(got, ref["psum"]))
            psum_gap = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(got, ref["psum"]))
            del got
            tr.step_fn = make_train_step(cfg, opt, mask_agg="weights",
                                         zero1=zero1)
            tr.mask_agg = "weights"
            _, launches, w_wall = one_step(
                tr, "weights", {"flash_attention": 2 * L, "fused_adam": 1},
                zero1, 1)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            with shd.use_layout(lay):
                got = tree.leaves(gather_state(tr.state, plan,
                                               lay)["params"])
            final_equal = all(torch.equal(a, b)
                              for a, b in zip(got, ref["final"]))
            final_gap = max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, ref["final"]))
            del got
            runs[zero1] = {
                "psum_bit_equal": psum_equal, "psum_max_abs_diff": psum_gap,
                "weights_bit_equal": final_equal,
                "weights_max_abs_diff": final_gap,
                "psum_wall_ms": float(np.median(walls)),
                "weights_wall_ms": w_wall, "max_memory_allocated": peak,
                "seconds": time.perf_counter() - t_run}
            emit("train_zero3", zero1=zero1, **runs[zero1])
            if zero1:
                keep = (tr.state["params"], plan)
            del tr, opt, step_fn
            torch.cuda.empty_cache()
    finally:
        for k in calls:
            setattr(dist, k, real[k])
    for zero1, r in runs.items():
        check(r["psum_bit_equal"], f"train_zero3 zero1={zero1}: the psum "
              f"steps' parameters differ from train's (max |diff| "
              f"{r['psum_max_abs_diff']})")
        check(r["weights_bit_equal"], f"train_zero3 zero1={zero1}: the "
              f"weights step's parameters differ from train's (max |diff| "
              f"{r['weights_max_abs_diff']})")

    # the collectives alone, as a step makes them (eager, host launch
    # included), at world size 1
    t_c = time.perf_counter()
    shards, plan = keep
    z = collectives.Zero3.of(lay, plan)
    flat = tree.leaves(shards)
    blocks = {}
    for i, leaf in enumerate(plan.leaves):
        parts = leaf.path.split("/")
        key = "/".join(parts[:2]) if parts[0] == "layers" else parts[0]
        blocks.setdefault(key, []).append(i)
    idx = list(blocks.values())
    total = torch.zeros(plan.size + 1, dtype=torch.float32, device="cuda")
    red = torch.empty(plan.block, dtype=torch.float32, device="cuda")
    pieces, groups = z._piece_buffers(flat)

    def gather_all():
        for ii in idx:
            z.gather_full(ii, [flat[i] for i in ii])

    def piece_gather():
        for buf, _ in groups:
            recv = list(torch.empty(buf.numel(), dtype=buf.dtype,
                                    device=buf.device).chunk(1))
            dist.all_gather(recv, buf, group=z.g_data)

    times = {
        "gathers_per_forward_ms": eager_ms(torch, gather_all,
                                           reps=COLLECTIVE_REPS),
        "reduce_ms": eager_ms(torch, lambda: z.reduce(total),
                              reps=COLLECTIVE_REPS),
        "reduce_scatter_ms": eager_ms(
            torch, lambda: dist.reduce_scatter(
                red, [total[:plan.block]], group=z.g_model),
            reps=COLLECTIVE_REPS),
        "piece_all_gather_ms": eager_ms(torch, piece_gather,
                                        reps=COLLECTIVE_REPS)}
    del total, red, pieces, groups, shards, flat, keep, z
    collectives.Zero3._cache.clear()
    torch.cuda.empty_cache()
    seconds["collectives"] = time.perf_counter() - t_c
    for zero1, r in runs.items():
        step_coll = (2 * W * times["gathers_per_forward_ms"]
                     + times["reduce_ms"]
                     + (times["piece_all_gather_ms"] if zero1 else 0.0))
        r["collectives_ms_per_psum_step"] = step_coll
        r["collectives_share_of_psum_step"] = step_coll / r["psum_wall_ms"]
    rec = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "W": W, "mesh": dict(mesh.shape),
           "params": sum(leaf.size for leaf in plan.leaves),
           "block_gathers_per_forward": per_forward,
           "train_psum_wall_ms": ref["psum_wall_ms"],
           "zero1_off": runs[False], "zero1_on": runs[True],
           "seconds": seconds, **times}
    emit("train_zero3", **rec)
    return totals, rec


# train_sp's flash shapes on a T-card mesh: (name, B, Sq, Sk, H, KV, hd,
# causal, window).  A causal rank s of T gets its S/T queries over the
# first (s + 1) S/T keys (qwen2-0.5b's heads, a train worker's B 2 at S
# 128); the halo case is a rank past the first whose window (32) reaches
# one chunk of 32 back; whisper's encoder rank holds 1536/T frames over
# all 1536 (8 heads, no GQA)
SP_FLASH_CASES = (
    [(f"sp_t{T}_s{s}", 2, 128 // T, (s + 1) * 128 // T, 14, 2, 64, True, 0)
     for T in (2, 4) for s in range(T)]
    + [("sp_halo_t4", 2, 32, 64, 14, 2, 64, True, 32)]
    + [(f"sp_whisper_enc_t{T}", 2, 1536 // T, 1536, 8, 8, 64, False, 0)
       for T in (2, 4)])
SP_COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "broadcast",
                  "all_to_all_single", "batch_isend_irecv")
RING_TOL = {"loss": 1e-4, "grad": 1e-3}   # tests/sharded/ring_ce_check.py


def _sp_flash(torch):
    """Each SP_FLASH_CASES shape, bf16: the kernel's forward through
    FlashAttention and its backward (the plain attention's) against the
    plain version's autograd on the same inputs, at TOL and FLASH_REL_TOL
    of the largest |output| and |gradient|; the kernel's path and the
    CUDA kernels a call makes; kernel, plain and SDPA ms (graph replay)
    beside the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        FlashAttention, aligned16, choose_path)
    from repro_torch.kernels.ref import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    side = torch.cuda.Stream()
    tol, rel_tol = TOL["bfloat16"], FLASH_REL_TOL["bfloat16"]
    out = {}
    for name, B, Sq, Sk, H, KV, hd, causal, window in SP_FLASH_CASES:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16).requires_grad_(True)

        q, k, v = rand(B, Sq, H, hd), rand(B, Sk, KV, hd), rand(B, Sk, KV, hd)
        path = choose_path(q.dtype, Sq, H // KV, aligned16(q, k, v))
        check(path == "wgmma", f"{name}: takes {path}, not wgmma")
        y = FlashAttention.apply(q, k, v, causal, window)
        want = reference_attention(q, k, v, causal=causal, window=window)
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
        got_g = torch.autograd.grad(y, (q, k, v), dy)
        want_g = torch.autograd.grad(want, (q, k, v), dy)
        err = (y.float() - want.float()).abs().max().item()
        want_max = want.float().abs().max().item()
        check(err <= tol and err / want_max <= rel_tol,
              f"{name}: forward off by {err} ({err / want_max} of the "
              f"largest |output| {want_max}; bars {tol}, {rel_tol})")
        grad_rel = []
        for label, a, b in zip("qkv", got_g, want_g):
            scale = b.float().abs().max().item()
            gerr = (a.float() - b.float()).abs().max().item()
            grad_rel.append(gerr / scale)
            check(gerr / scale <= rel_tol, f"{name}: d{label} off by {gerr}, "
                  f"{gerr / scale} of its largest {scale} > {rel_tol}")
        qd, kd, vd = (t.detach() for t in (q, k, v))
        qpos = torch.arange(Sq, device="cuda") + (Sk - Sq)
        kpos = torch.arange(Sk, device="cuda")
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device="cuda")
        if causal:
            mask &= kpos[None] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None] > qpos[:, None] - window
        qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))

        def kern():
            return FlashAttention.apply(qd, kd, vd, causal, window)

        def plain():
            return reference_attention(qd, kd, vd, causal=causal,
                                       window=window)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        with torch.no_grad():
            lib_err = (sdpa().transpose(1, 2).float() - want.float()
                       ).abs().max().item()
            times = {label: device_ms(torch, fn, side) for label, fn in (
                ("ms", kern), ("plain_ms", plain), ("library_ms", sdpa))}
            per_call = graph_kernels(torch, kern, side)
        check(per_call == {"flash_fwd_tc": 1},
              f"{name}: a call launched {per_call}, not one flash_fwd_tc")
        if not lib_err <= tol:
            times["library_ms"] = None   # a yardstick of a wrong result
        nbytes = 2 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
        ops = 4 * B * H * hd * valid_pairs(Sq, Sk, causal, window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["bfloat16"] * 1e3
        rec = {"case": name, "shape": [B, Sq, Sk, H, KV, hd],
               "causal": causal, "window": window, "path": path,
               "max_abs_err": err, "rel_err": err / want_max,
               "grad_rel_err": max(grad_rel), "library_err": lib_err,
               **times, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        emit("train_sp_flash", **rec)
        out[name] = rec
        del q, k, v, y, want, got_g, want_g
    return out


def phase_train_sp(torch, cfg, params_f32, ref):
    """Sequence parallelism: the flash kernel at the shapes it gets on a
    T-card mesh (``_sp_flash``), then train's setup, seeds and schedule
    through ``train_sp`` at NCCL world size 1 on a (1, 1) ("data",
    "model") mesh, W 8: the sequence over the model axis (its one rank
    holds all of it; every gather of k/v, reduce-scatter and all-reduce
    still runs), the parameters ZeRO-3 over it.  The 4 psum steps and the
    weights step with the dense CE (launches and collectives every step,
    the gathered parameters bit-equal to train's), then one psum and one
    weights step from a fresh state with the vocab-ring CE against the
    dense one (ring_ce_check's bars)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import init_distributed

    t0 = time.perf_counter()
    flash = _sp_flash(torch)
    flash_s = time.perf_counter() - t0
    build.LAUNCHES.clear()
    t_setup = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        init_distributed("cuda", init_method=f"file://{d}/pg", rank=0,
                         world_size=1)
        try:
            totals, rec = _train_sp(torch, cfg, params_f32, ref, t_setup)
        finally:
            collectives.Zero3._cache.clear()
            dist.destroy_process_group()
    rec["seconds"]["flash"] = flash_s
    emit("train_sp", **rec)
    return totals, rec, flash


def _train_sp(torch, cfg, params_f32, ref, t_setup):
    import torch.distributed as dist

    from repro_torch import optim, tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import FirstKController
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.dist import collectives
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (gather_state, make_train_step,
                                          shard_state)
    from repro_torch.perf.knobs import use_knobs

    W, S, B, L = 8, 128, 16, cfg.n_layers
    mesh = make_mesh((1, 1), ("data", "model"))
    lay = shd.make_layout(mesh, "train_sp")
    check(shd.seq_parallel(lay) and shd.is_zero3(lay) and lay.n_shards == 1
          and lay.dp_size == 1, f"train_sp layout {lay}")
    # a forward gathers each block (and again in the backward's
    # recompute), the embedding twice (its lookup and the tied head) and
    # the final norm, and k/v once a layer (again in the recompute); the
    # backward reduce-scatters the k/v gradient once a layer
    gathers = 4 * L + 3
    seconds = {"setup": time.perf_counter() - t_setup}
    calls = {k: 0 for k in SP_COLLECTIVES}
    real = {k: getattr(dist, k) for k in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    def one_step(run, label, want, workers, want_calls):
        build.LAUNCHES.clear()
        before = dict(calls)
        t0 = time.perf_counter()
        rec = run()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        check(launches == want, f"train_sp {label}: launches {launches}, "
              f"want {want}")
        made = {k: calls[k] - before[k] for k in calls}
        check(all(made[k] == n for k, n in want_calls.items())
              and made["all_reduce"] >= workers + 2,
              f"train_sp {label}: collectives {made}, want {want_calls} and "
              f"at least {workers + 2} all-reduces")
        check(bool(np.isfinite(float(rec["loss"]))),
              f"train_sp {label}: loss {rec['loss']}")
        emit("train_sp_step", mask_agg=label, wall_ms=wall * 1e3,
             loss=float(rec["loss"]), launches=launches, collectives=made)
        return launches, wall * 1e3, made

    psum_want = {"flash_attention": 2 * L * W, "masked_grad_agg_sum": 1,
                 "fused_adam": 1}
    weights_want = {"flash_attention": 2 * L, "fused_adam": 1}
    psum_calls = {"all_gather": W * gathers, "reduce_scatter": W * L + 1,
                  "broadcast": 1, "all_to_all_single": 0,
                  "batch_isend_irecv": 0}
    weights_calls = dict(psum_calls, all_gather=gathers,
                         reduce_scatter=L + 1)
    totals, walls, step_calls = {}, [], {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    for k in calls:
        setattr(dist, k, counting(k))
    try:
        t_run = time.perf_counter()
        params = cast(params_f32, "cuda", torch.bfloat16)
        opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
        step_fn = make_train_step(cfg, opt, mask_agg="psum")
        with shd.use_layout(lay):
            tr, _ = _train_setup(
                torch, cfg, params, n_workers=W, seq=S, batch=B,
                controller=FirstKController(W, backup=2),
                timer=ClusterSim(n_workers=W, n_nodes=2, seed=7),
                opt=opt, step_fn=step_fn)
        del params
        plan = step_fn.plan_for(lay)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def trainer_step():
            with shd.use_layout(lay):
                return tr.run(1)[-1]

        for _ in range(TRAIN_STEPS + 1):
            launches, wall, made = one_step(trainer_step, "psum", psum_want,
                                            W, psum_calls)
            walls.append(wall)
            step_calls["psum"] = made
            add(launches)
        peak = torch.cuda.max_memory_allocated()
        with shd.use_layout(lay):
            got = tree.leaves(gather_state(tr.state, plan, lay)["params"])
        psum_equal = all(torch.equal(a, b) for a, b in zip(got, ref["psum"]))
        psum_gap = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, ref["psum"]))
        del got
        tr.step_fn = make_train_step(cfg, opt, mask_agg="weights")
        tr.mask_agg = "weights"
        launches, w_wall, step_calls["weights"] = one_step(
            trainer_step, "weights", weights_want, 1, weights_calls)
        add(launches)
        with shd.use_layout(lay):
            got = tree.leaves(gather_state(tr.state, plan, lay)["params"])
        final_equal = all(torch.equal(a, b)
                          for a, b in zip(got, ref["final"]))
        final_gap = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref["final"]))
        del got, tr, opt, step_fn
        torch.cuda.empty_cache()
        seconds["dense"] = time.perf_counter() - t_run

        # the ring against the dense CE: one psum and one weights step
        # each from the same fresh state and batch, the aggregated gradient
        # caught in f32 before its cast to the leaves' dtype
        t_ring = time.perf_counter()
        mask = np.ones(W, np.float32)
        mask[[2, 5]] = 0.0
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=SEED).batch(0)
        caught = []
        as_tree = collectives.Zero3.as_tree

        def catching(self, like, flat):
            caught.append([x.clone() for x in flat])
            return as_tree(self, like, flat)

        ring = {}
        collectives.Zero3.as_tree = catching
        try:
            for agg in ("psum", "weights"):
                batch = dict(data)
                if agg == "psum":
                    batch["mask"] = mask
                else:
                    batch["weights"] = collectives.example_weights(mask, B)
                for impl in ("dense", "ring"):
                    params = cast(params_f32, "cuda", torch.bfloat16)
                    opt = optim.adamw(3e-4, fused=True)
                    step_fn = make_train_step(cfg, opt, mask_agg=agg)
                    with shd.use_layout(lay):
                        state = shard_state(
                            {"params": params, "opt": opt.init(params)},
                            step_fn.plan_for(lay))
                    del params
                    caught.clear()
                    loss = []

                    def run_one():
                        with shd.use_layout(lay), use_knobs(ce_impl=impl):
                            m = step_fn(state, batch)[1]
                        loss.append(float(m["loss"]))
                        return m

                    psum = agg == "psum"
                    n_w = W if psum else 1
                    # the ring reads the tied head's shard where it lies:
                    # no gather of it
                    head = int(impl == "ring" and cfg.tie_embeddings)
                    launches, wall, _ = one_step(
                        run_one, f"{agg}_{impl}",
                        psum_want if psum else weights_want, n_w,
                        dict(psum_calls if psum else weights_calls,
                             broadcast=0, all_gather=n_w * (gathers - head)))
                    add(launches)
                    ring[(agg, impl)] = {"loss": loss[-1],
                                         "grad": caught[-1], "wall_ms": wall}
                    del state, opt, step_fn
                    torch.cuda.empty_cache()
        finally:
            collectives.Zero3.as_tree = as_tree
        seconds["ring"] = time.perf_counter() - t_ring
    finally:
        for k in calls:
            setattr(dist, k, real[k])
    check(psum_equal, f"train_sp: the psum steps' parameters differ from "
          f"train's (max |diff| {psum_gap})")
    check(final_equal, f"train_sp: the weights step's parameters differ "
          f"from train's (max |diff| {final_gap})")
    ring_rec = {}
    for agg in ("psum", "weights"):
        d, r = ring[(agg, "dense")], ring[(agg, "ring")]
        dloss = abs(d["loss"] - r["loss"])
        gerr = max((a - b).abs().max().item()
                   for a, b in zip(d["grad"], r["grad"]))
        gmax = max(a.abs().max().item() for a in d["grad"])
        ring_rec[agg] = {"dense_loss": d["loss"], "ring_loss": r["loss"],
                         "dloss": dloss, "grad_max_abs_diff": gerr,
                         "grad_max_abs": gmax, "dense_wall_ms": d["wall_ms"],
                         "ring_wall_ms": r["wall_ms"]}
        check(dloss < RING_TOL["loss"] and gerr < RING_TOL["grad"],
              f"train_sp {agg}: the ring CE's loss is off the dense one's by "
              f"{dloss} (bar {RING_TOL['loss']}), its aggregated gradient by "
              f"{gerr} (bar {RING_TOL['grad']})")
    del ring
    rec = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "W": W, "mesh": dict(mesh.shape),
           "psum_bit_equal": psum_equal, "psum_max_abs_diff": psum_gap,
           "weights_bit_equal": final_equal,
           "weights_max_abs_diff": final_gap,
           "psum_wall_ms": float(np.median(walls)), "psum_walls_ms": walls,
           "weights_wall_ms": w_wall,
           "train_psum_wall_ms": ref["psum_wall_ms"],
           "max_memory_allocated": peak, "collectives_per_step": step_calls,
           "gathers_per_forward": gathers, "ring": ring_rec,
           "seconds": seconds}
    return totals, rec


# mlstm_chunk at a T-card train_sp mesh's per-rank shapes: (name, B, S, H,
# dq, dv, normalize).  xLSTM's train shape takes the wgmma path, Hymba's
# (q/k rows broadcast over the 25 heads, unnormalized) the CUDA-core path.
SP_MLSTM_CASES = (("xlstm_train", 2, 128, 4, 512, 512, True),
                  ("hymba_train", 2, 128, 25, 16, 128, False))
SP_MLSTM_T = (2, 4)
SP_SSM_PSUM_STEPS = 2   # then one weights step, as train_xlstm runs them


def _sp_mlstm(torch):
    """Each SP_MLSTM_CASES shape cut into T = 2 and 4 ranks' columns, the
    prefix carried rank to rank as ``ops.mlstm`` carries it: a rank's own
    final state by a states-only launch, the combine of the ranks' before
    it as the entering state of a launch through MLSTMChunk.  Each rank's
    y is held against the whole sequence's plain call at MLSTM_TOL and its
    final state against the plain call from the same entering state; the
    gradients of q, k, v, g, i and of the entering state, for a loss that
    reads y and the final state, against autograd of the plain path on the
    card at MLSTM_GRAD_TOL of their scale.  At rank 1 (every later rank
    has its shapes) the launch from the entering state, the states-only
    launch and the plain call are timed (graph replay) beside their
    bounds, with the CUDA kernels a call makes."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import aligned16
    from repro_torch.kernels.mlstm_chunk import (PATH_KERNELS, MLSTMChunk,
                                                 choose_path, mlstm_chunk)
    from repro_torch.kernels.mlstm_plain import (ScanState, combine,
                                                 local_recurrence)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    side = torch.cuda.Stream()
    out = {}
    for name, B, S, H, dq, dv, norm in SP_MLSTM_CASES:
        form = {} if norm else HYMBA_FORM
        opts = (True, None) if norm else (False, 1.0)
        if norm:
            xs = _mlstm_inputs(torch, B, S, H, dq, "bfloat16", "normal", gen)
        else:
            c_, b_, *rest = _mamba_inputs(torch, B, S, H, dq, dv, "bfloat16",
                                          gen)
            xs = (_heads(c_, H), _heads(b_, H), *rest)
        y_full, _ = local_recurrence(*(t.float() for t in xs), **form)
        for T in SP_MLSTM_T:
            n = S // T
            prefix, worst = None, {"y": 0.0, "final": 0.0, "grad": 0.0}
            for s in range(T):
                cols = [t[:, s * n:(s + 1) * n] for t in xs]
                path = choose_path(cols[0].dtype, dq, aligned16(*cols[:3]),
                                   dv=dv, normalize=norm)
                check(path == ("wgmma" if norm else "simt"),
                      f"sp_mlstm {name} T{T} rank {s}: takes {path}")
                build.LAUNCHES.clear()
                with torch.no_grad():
                    _, own = mlstm_chunk(*cols, outputs=False, **form)
                leaves = [t.detach().requires_grad_(True) for t in cols]
                init = [t.detach().clone().requires_grad_(True)
                        for t in (prefix or ())]
                y, *final = MLSTMChunk.apply(*leaves, *opts, True, *init)
                check(build.LAUNCHES["mlstm_chunk"] == 2, f"sp_mlstm {name} "
                      f"T{T} rank {s}: {dict(build.LAUNCHES)} launches")
                want_y = y_full[:, s * n:(s + 1) * n]
                y_ex = _allclose_excess(torch, y, want_y, MLSTM_TOL,
                                        MLSTM_TOL).item()
                check(y_ex <= MLSTM_TOL, f"sp_mlstm {name} T{T} rank {s}: y "
                      f"off the whole sequence's by {y_ex}")
                r = torch.randn(y.shape, generator=gen, device="cuda")
                rs = [torch.randn(t.shape, generator=gen, device="cuda")
                      for t in final]

                def loss(y_, fin):
                    return (y_ * r).sum() + sum((a * b).sum()
                                                for a, b in zip(fin, rs))

                got = torch.autograd.grad(loss(y, final), leaves + init)
                plain = [t.detach().float().contiguous().requires_grad_(True)
                         for t in leaves]
                pinit = [t.detach().clone().requires_grad_(True)
                         for t in init]
                yp, fp = local_recurrence(
                    *plain, init_state=ScanState(*pinit) if pinit else None,
                    **form)
                want = torch.autograd.grad(loss(yp, fp), plain + pinit)
                fin_err = _scaled_err(torch, [a.detach() for a in final],
                                      [b.detach() for b in fp])
                check(fin_err <= MLSTM_TOL, f"sp_mlstm {name} T{T} rank {s}: "
                      f"final state off by {fin_err} of its scale")
                for key, a, b, x in zip(
                        ["q", "k", "v", "g", "i", "loga0", "m0", "C0", "n0"],
                        got, want, leaves + init):
                    check(a.dtype == x.dtype and bool(torch.isfinite(a).all()),
                          f"sp_mlstm {name} T{T} rank {s}: d{key} {a.dtype}")
                    err = _scaled_err(torch, [a.float()],
                                      [b.to(a.dtype).float()])
                    check(err <= MLSTM_GRAD_TOL, f"sp_mlstm {name} T{T} rank "
                          f"{s}: d{key} off by {err} of its scale")
                    worst["grad"] = max(worst["grad"], err)
                worst["y"] = max(worst["y"], (y - want_y).abs().max().item())
                worst["final"] = max(worst["final"], fin_err)
                if s == 1:
                    ent = ScanState(*(t.detach() for t in init))
                    args = [t.detach() for t in cols]
                    with torch.no_grad():
                        per_call = graph_kernels(torch, lambda: mlstm_chunk(
                            *args, init_state=ent, **form), side)
                        per_state = graph_kernels(torch, lambda: mlstm_chunk(
                            *args, outputs=False, **form), side)
                        times = {label: device_ms(torch, fn, side) for
                                 label, fn in (
                            ("ms", lambda: mlstm_chunk(
                                *args, init_state=ent, **form)),
                            ("state_ms", lambda: mlstm_chunk(
                                *args, outputs=False, **form)),
                            ("plain_ms", lambda: local_recurrence(
                                *args, init_state=ent, **form)))}
                    kernels = dict.fromkeys(PATH_KERNELS[path], 1)
                    check(per_call == kernels, f"sp_mlstm {name} T{T}: a "
                          f"call from a state launched {per_call}")
                    check(per_state == {PATH_KERNELS[path][0]: 1},
                          f"sp_mlstm {name} T{T}: a states-only call "
                          f"launched {per_state}")
                    qk_heads = None if norm else 1
                    bound = mlstm_bound(B, n, H, dq, "bfloat16", dv, qk_heads,
                                        init=True)
                    sbound = mlstm_bound(B, n, H, dq, "bfloat16", dv,
                                         qk_heads, outputs=False)
                prefix = own if prefix is None else combine(prefix, own)
                del leaves, init, y, final, got, plain, pinit, yp, fp, want
            rec = {"case": f"{name}_t{T}", "shape": [B, n, H, dq], "dv": dv,
                   "normalize": norm, "path": path, "ranks": T,
                   "max_abs_err": worst["y"], "final_scaled_err":
                   worst["final"], "grad_scaled_err": worst["grad"],
                   "tol": {"y": MLSTM_TOL, "grad": MLSTM_GRAD_TOL},
                   "cuda_kernels_per_call": per_call,
                   "cuda_kernels_states_only": per_state, **times,
                   "library_ms": None, "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"],
                   "state_bound_ms": sbound["bound_ms"],
                   "state_bound_by": sbound["bound_by"]}
            emit("sp_mlstm", **rec)
            out[rec["case"]] = rec
        del xs, y_full
    torch.cuda.empty_cache()
    return out


def phase_train_sp_ssm(torch, label, cfg, params, ref, controller_fn):
    """An SSM arch's train_sp at NCCL world size 1: the setup, seeds and
    schedule of its train phase (``params`` a function of fresh card
    weights, ``controller_fn`` of a fresh controller; W 8, seq 128 x batch
    16, fused AdamW, ClusterSim(8, 2 nodes, seed 7)) under a (1, 1)
    ("data", "model") train_sp layout: SP_SSM_PSUM_STEPS psum steps and
    one weights step, each asserting its launches (every mlstm_chunk and
    flash call twice a forward: the block's recompute runs it again), the
    gathered parameters bit-equal to ``ref``'s after the psum steps and
    after the weights step."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.launch.mesh import init_distributed

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        init_distributed("cuda", init_method=f"file://{d}/pg", rank=0,
                         world_size=1)
        try:
            totals, rec = _train_sp_ssm(torch, label, cfg, params, ref,
                                        controller_fn)
        finally:
            collectives.Zero3._cache.clear()
            dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    emit(label, **rec)
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _train_sp_ssm(torch, label, cfg, params, ref, controller_fn):
    import torch.distributed as dist

    from repro_torch import optim, tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import gather_state, make_train_step
    from repro_torch.models import model as M

    W, S, B = 8, 128, 16
    lay = shd.make_layout(make_mesh((1, 1), ("data", "model")), "train_sp")
    kinds = [sp.kind for sp in M.layer_specs(cfg)]
    n_rec = kinds.count("mlstm") + kinds.count("hybrid")
    n_attn = kinds.count("hybrid")
    opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
    step_fn = make_train_step(cfg, opt, mask_agg="psum")
    with shd.use_layout(lay):
        tr, _ = _train_setup(
            torch, cfg, params(), n_workers=W, seq=S, batch=B,
            controller=controller_fn(),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7), opt=opt,
            step_fn=step_fn)
    plan = step_fn.plan_for(lay)

    def want(workers, agg):
        w = {"mlstm_chunk": 2 * n_rec * workers, "fused_adam": 1, **agg}
        if n_attn:
            w["flash_attention"] = 2 * n_attn * workers
        return w

    totals, steps, equal, gap = {}, [], {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(SP_SSM_PSUM_STEPS + 1):
        agg = "psum" if i < SP_SSM_PSUM_STEPS else "weights"
        if i == SP_SSM_PSUM_STEPS:
            tr.step_fn = make_train_step(cfg, opt, mask_agg="weights")
            tr.mask_agg = "weights"
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with shd.use_layout(lay):
            rec = tr.run(1)[-1]    # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        w = (want(W, {"masked_grad_agg_sum": 1}) if agg == "psum"
             else want(1, {}))
        check(launches == w, f"{label} {agg} step {rec['step']}: launches "
              f"{launches}, want {w}")
        check(bool(np.isfinite(rec["loss"])),
              f"{label} step {rec['step']}: loss {rec['loss']}")
        steps.append({"mask_agg": agg, "step": rec["step"], "c": rec["c"],
                      "loss": rec["loss"], "wall_ms": wall * 1e3,
                      "launches": launches})
        if i + 1 >= SP_SSM_PSUM_STEPS:
            key = agg
            with shd.use_layout(lay):
                got = _cpu_copy(torch, gather_state(tr.state, plan, lay)
                                ["params"])
            equal[key] = _bit_equal(torch, got, ref[key])
            gap[key] = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(got, ref[key]))
            del got
    check(all(equal.values()), f"{label}: the parameters differ from the "
          f"train phase's ({gap})")
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "W": W, "mesh": dict(lay.mesh.shape),
           "steps": steps, "bit_equal": equal, "max_abs_diff": gap,
           "n_params": sum(x.numel() for x in tree.leaves(tr.state["params"])),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del tr, opt, step_fn
    return totals, rec


def _scaled_err(torch, got, want):
    """Per leaf: max |got - want| over max |want| (the leaf's own scale)."""
    out = []
    for a, b in zip(got, want):
        scale = b.abs().max().clamp(min=1e-30)
        out.append(((a - b).abs().max() / scale).item())
    return max(out)


PARITY_TOL = {"loss": 1e-4, "grad": 1e-4, "m": 1e-4, "v": 3e-4}
# a leaf whose CPU gradient stays under ZERO_GRAD_REL of the largest
# leaf's on every step is 0 by construction (whisper's key biases: ~1e-9,
# f32 rounding noise on both devices, far below the other leaves' 1e-4 of
# their scale): its gradient and m are held at ZERO_GRAD_ATOL absolute
ZERO_GRAD_REL = 1e-6
ZERO_GRAD_ATOL = 1e-6


def _host_rss():
    """(current, process peak) resident bytes of this process."""
    import resource

    with open("/proc/self/statm") as f:
        cur = int(f.read().split()[1]) * resource.getpagesize()
    return cur, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _train_parity(torch, cfg, p_cpu, *, W, S, B, n_steps, cutoff,
                  data=None):
    """The psum step (StaticCutoffController(W, cutoff), ClusterSim(W, 2
    nodes, seed 7), fused AdamW) for ``n_steps`` on the CPU (plain
    versions), then on the card (kernels), from the f32 params ``p_cpu``
    (updated in place by the CPU run).  The CPU run keeps its gradients;
    the card's are compared with them as they come, on the card, so the
    host holds one run's state and gradients, not two.  Returns the record
    of train_parity's comparisons (losses, the aggregated gradient, m, v,
    p held tightly where every step's |g| is above 1e-3 of its leaf's
    largest and within 2 lr per step elsewhere) and the per-step aux of
    both runs.

    A leaf whose CPU gradient is under ZERO_GRAD_REL of the largest leaf's
    on every step is 0 by construction (whisper's key biases: a softmax
    does not see a shift of its row), so both devices hold rounding noise
    there.  Its gradient and m are held at ZERO_GRAD_ATOL absolute instead
    of to their own scale, and its p within 2 lr a step only (Adam moves
    each entry by about lr times the noise's sign); the record names
    these leaves."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import StaticCutoffController
    from repro_torch.optim import cosine_schedule

    p_gpu = cast(p_cpu, "cuda", torch.float32)
    seconds, hist, aux = {}, {}, {}
    g_cpu, sure, grad_errs = [], None, []
    names = _leaf_names(p_cpu)
    zero = []   # set from the CPU's gradients before the card's run
    zero_abs = [0.0]

    def check_gpu(g):
        nonlocal sure
        want = [x.to("cuda") for x in g_cpu.pop(0)]
        per_leaf = [0.0 if z else _scaled_err(torch, [a.float()], [b])
                    for a, b, z in zip(tree.leaves(g), want, zero)]
        for a, b, z in zip(tree.leaves(g), want, zero):
            if z:
                zero_abs[0] = max(zero_abs[0], a.abs().max().item(),
                                  b.abs().max().item())
        worst = int(np.argmax(per_leaf))
        grad_errs.append((per_leaf[worst], names[worst]))
        # where the CPU's |g| is well above noise on every step
        s = [x.abs() > 1e-3 * x.abs().max() if not z
             else torch.zeros_like(x, dtype=torch.bool)
             for x, z in zip(want, zero)]
        sure = s if sure is None else [a & b for a, b in zip(sure, s)]

    state = {}
    for dev, params, rec in (
            ("cpu", p_cpu,
             lambda g: g_cpu.append([x.float() for x in tree.leaves(g)])),
            ("cuda", p_gpu, check_gpu)):
        if dev == "cuda":
            tops = [[x.abs().max().item() for x in g] for g in g_cpu]
            zero[:] = [all(t[i] < ZERO_GRAD_REL * max(t) for t in tops)
                       for i in range(len(names))]
        t0 = time.perf_counter()
        mets = []
        tr, _ = _train_setup(
            torch, cfg, params, n_workers=W, seq=S, batch=B,
            controller=StaticCutoffController(W, cutoff=cutoff),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7), record=rec,
            metrics_out=mets, data=data)
        hist[dev] = tr.run(n_steps)
        aux[dev] = [float(m["aux"]) for m in mets]
        state[dev] = {"p": tr.state["params"],
                      "m": tr.state["opt"]["m"], "v": tr.state["opt"]["v"]}
        del tr, mets
        gc.collect()
        seconds[dev] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_c, h_g = hist["cpu"], hist["cuda"]
    check([(h["c"], h["clock"]) for h in h_c]
          == [(h["c"], h["clock"]) for h in h_g], "cutoffs/clock differ")
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(h_c, h_g))

    def pairs(key, skip_zero=False):   # (card leaf, CPU leaf on the card)
        for a, b, z in zip(tree.leaves(state["cuda"][key]),
                           tree.leaves(state["cpu"][key]), zero):
            if not (skip_zero and z):
                yield a, b.to("cuda")

    m_err = max(_scaled_err(torch, [a], [b]) for a, b in pairs("m", True))
    v_err = max(_scaled_err(torch, [a], [b]) for a, b in pairs("v", True))
    zero_m = max([0.0] + [max(a.abs().max().item(), b.abs().max().item())
                          for a, b, z in zip(tree.leaves(state["cuda"]["m"]),
                                             tree.leaves(state["cpu"]["m"]),
                                             zero) if z])
    # Adam's first steps move each entry by about lr times the sign of its
    # gradient, whatever the gradient's size: where |g| sits at rounding
    # noise the two devices may disagree on that sign, so p is held tightly
    # only where every step's |g| is above 1e-3 of its leaf's largest, and
    # within 2 lr per step elsewhere.
    sched = cosine_schedule(3e-4, 2, 20)
    lr_sum = float(sum(sched(s) for s in range(n_steps)))
    tight_tol, loose_tol = 0.05 * lr_sum, 2.0 * lr_sum
    tight_err = loose_err = 0.0
    n_tight = n_all = 0
    for i, (a, b) in enumerate(pairs("p")):
        d = (a - b).abs()
        if bool(sure[i].any()):
            tight_err = max(tight_err, d[sure[i]].max().item())
        loose_err = max(loose_err, d.max().item())
        n_tight += int(sure[i].sum())
        n_all += d.numel()
    seconds["compare"] = time.perf_counter() - t0
    rec = {"dtype": "float32", "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "workers": W, "seq": S, "batch": B,
           "steps": n_steps, "c": [h["c"] for h in h_g],
           "loss_cpu": [h["loss"] for h in h_c],
           "loss_cuda": [h["loss"] for h in h_g],
           "loss_max_abs_err": loss_err,
           "grad_scaled_err": max(e for e, _ in grad_errs),
           "grad_scaled_err_by_step": [e for e, _ in grad_errs],
           "grad_worst_leaf_by_step": [n for _, n in grad_errs],
           "m_scaled_err": m_err, "v_scaled_err": v_err,
           "p_tight_max_abs_err": tight_err, "p_tight_tol": tight_tol,
           "p_tight_share": n_tight / n_all,
           "p_max_abs_err": loose_err, "p_tol": loose_tol, "tol": PARITY_TOL,
           "zero_grad_leaves": [n for n, z in zip(names, zero) if z],
           "zero_grad_max_abs": zero_abs[0], "zero_m_max_abs": zero_m,
           "zero_grad_rel": ZERO_GRAD_REL, "zero_grad_atol": ZERO_GRAD_ATOL,
           "seconds": seconds}
    del state, p_gpu, sure
    gc.collect()
    torch.cuda.empty_cache()
    return rec, aux


def _leaf_names(node, pre=""):
    """'/layers/1/moe/router'-style names, in ``tree.leaves`` order."""
    if isinstance(node, dict):
        return [n for k in sorted(node) for n in
                _leaf_names(node[k], f"{pre}/{k}")]
    if isinstance(node, (list, tuple)):
        return [n for i, v in enumerate(node) for n in
                _leaf_names(v, f"{pre}/{i}")]
    return [pre]


def _check_train_parity(rec, what, tol=None):
    """train_parity's bars (``PARITY_TOL``), or ``tol``: the first step's
    gradient (identical params on both devices) at ``tol["grad"]``, the
    later steps' at ``tol["grad_later"]`` where given; the leaves whose
    gradient is 0 by construction at ZERO_GRAD_ATOL."""
    tol = tol or PARITY_TOL
    worst = max(rec["zero_grad_max_abs"], rec["zero_m_max_abs"])
    check(worst <= ZERO_GRAD_ATOL, f"{what}: a zero-gradient leaf's "
          f"gradient or m reached {worst} > {ZERO_GRAD_ATOL} "
          f"({rec['zero_grad_leaves']})")
    by_step = rec["grad_scaled_err_by_step"]
    check(rec["loss_max_abs_err"] <= tol["loss"],
          f"{what}: loss differs by {rec['loss_max_abs_err']}")
    check(by_step[0] <= tol["grad"], f"{what}: step 1's aggregated "
          f"gradient differs by {by_step[0]} of its scale")
    check(max(by_step) <= tol.get("grad_later", tol["grad"]),
          f"{what}: aggregated gradient differs by {max(by_step)} of its "
          f"scale ({by_step} by step)")
    check(rec["m_scaled_err"] <= tol["m"],
          f"{what}: m differs by {rec['m_scaled_err']} of its scale")
    check(rec["v_scaled_err"] <= tol["v"],
          f"{what}: v differs by {rec['v_scaled_err']} of its scale")
    check(rec["p_tight_max_abs_err"] <= rec["p_tight_tol"],
          f"{what}: p differs by {rec['p_tight_max_abs_err']} > "
          f"{rec['p_tight_tol']} where |g| is well above noise")
    check(rec["p_max_abs_err"] <= rec["p_tol"],
          f"{what}: p differs by {rec['p_max_abs_err']} > {rec['p_tol']}")


def phase_train_parity(torch, cfg_full):
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    p_cpu = M.init_model(cfg, torch.Generator().manual_seed(SEED + 3),
                         device="cpu", dtype=torch.float32)
    rec, _ = _train_parity(torch, cfg, p_cpu, W=4, S=32, B=8, n_steps=2,
                           cutoff=3)
    emit("train_parity", **rec)
    _check_train_parity(rec, "train_parity")


# ---------------------------------------------------------------------------
# The DMM decision path.  It has no kernel of its own: plain torch ops,
# captured as one CUDA graph per controller mode and replayed once a step.
# ---------------------------------------------------------------------------

NORMAL_TOL = (1e-6, 1e-7)   # (rtol, atol) of tests/test_torch_random.py
FIT_TOL = 2e-3              # of the loss trajectory's largest |value|
WINDOW_TOL = 2e-3           # rtol = atol, tests/test_controller_device.py
# The server's windows against the card's controllers and the CPU server
# (ps_parity, ps_parity_158): the reference's server bar, rtol = atol
# (tests/test_ps_server.py:130).  The card meets it since the
# controller's decision divides its ring by the norm scale as a tensor
# (C.12): CUDA divides by a python float as a product with the
# reciprocal, one ulp off the bucket's true division in up to 500 of
# the 3,318 ring entries, and the censored imputation's f32 tail (a
# truncation CDF within ~1e-5 of 1, where its spacing is 6e-8) turned
# those ulps into 1.82e-4 of window at J = 1, n = 158 (1.47e-4 at
# J = 3).  Since: 0.0 at J = 1, 4.3e-6 at J = 3, 1.6e-5 against the CPU
# server (H100).
SERVER_WINDOW_TOL = 1e-4


def _twin_check(torch):
    """(a) The jax.random twin on the card against the twin on the CPU, at
    the shapes the controller draws: bits equal for split, fold_in,
    uniform and categorical; normals within NORMAL_TOL."""
    from repro_torch import random as R
    from repro_torch.core.runtime_model import api

    logits = torch.randn((4, 151936), generator=torch.Generator()
                         .manual_seed(SEED)) * 3.0
    out = {"bits_equal": [], "normal_max_abs_err": 0.0,
           "normal_bit_equal_share": 1.0, "tol": NORMAL_TOL}

    def draws(seed, dev):
        key = R.PRNGKey(seed, device=dev)
        k1, k2, k3, _ = R.split(key, 4)
        steps = R.split(k1, 21)
        return {"split": R.split(key, 4),
                "split_steps": steps,
                "fold_in": api._colwise_keys(k3, 158),
                "uniform": api.colwise_uniform(k2, 158).view(torch.int32),
                "categorical": R.categorical(key, logits.to(dev)),
                "normal_guide": R.normal(steps, (64, 32)),
                "normal_transition": R.normal(k2, (64, 32)),
                "normal_colwise": api.colwise_normal(k3, 64, 158)}

    for seed in (0, 7, 1_000_010):
        cpu, gpu = draws(seed, "cpu"), draws(seed, "cuda")
        for name, a in cpu.items():
            b = gpu[name].cpu()
            if name.startswith("normal"):
                err = float((a - b).abs().max())
                out["normal_max_abs_err"] = max(out["normal_max_abs_err"],
                                                err)
                share = float((a.view(torch.int32) == b.view(torch.int32))
                              .float().mean())
                out["normal_bit_equal_share"] = min(
                    out["normal_bit_equal_share"], share)
                check(torch.allclose(b, a, rtol=NORMAL_TOL[0],
                                     atol=NORMAL_TOL[1]),
                      f"twin {name} (seed {seed}): card and CPU normals "
                      f"differ by {err}")
            else:
                check(torch.equal(a, b), f"twin {name} (seed {seed}): card "
                      f"and CPU bits differ")
    out["bits_equal"] = [k for k in cpu if not k.startswith("normal")]
    return out


def _rel_close(a, b, tol):
    return bool(np.all(np.abs(a - b) <= tol + tol * np.abs(b)))


def phase_dmm(torch):
    """(a) the twin, (b) the fit on card and CPU, (c) 100 steps of the
    device backend on the card against the numpy backend, (d) timing."""
    from repro_torch.cluster.simulator import ClusterSim, paper_cluster_158
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import RuntimeModel

    t0 = time.perf_counter()
    twin = _twin_check(torch)
    emit("dmm_twin", **twin, seconds=time.perf_counter() - t0)

    # (b) the same init on both devices, 60 ELBO steps at batch 8
    trace = paper_cluster_158(seed=0).run(60)
    losses, fit_s, models = {}, {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        rm = RuntimeModel(158, lag=20, device=dev).init(0)
        losses[dev] = np.asarray(rm.fit(trace, steps=60, batch=8, seed=0))
        fit_s[dev] = time.perf_counter() - t0
        models[dev] = rm
    scale = float(np.abs(losses["cpu"]).max())
    fit_err = float(np.abs(losses["cuda"] - losses["cpu"]).max())
    emit("dmm_fit", n=158, lag=20, steps=60, batch=8,
         loss_first=[losses[d][0] for d in ("cpu", "cuda")],
         loss_last=[losses[d][-1] for d in ("cpu", "cuda")],
         max_abs_err=fit_err, scale=scale, tol=FIT_TOL * scale,
         seconds=fit_s)
    check(fit_err <= FIT_TOL * scale, f"fit: card and CPU losses differ by "
          f"{fit_err} > {FIT_TOL} x {scale}")

    # (c) the card's device backend against the port's f64 numpy backend,
    # both on the card-fitted params
    rm = models["cuda"]
    dev = CutoffController(rm, k_samples=32, seed=0, backend="device")
    ref = CutoffController(rm.to("cpu"), k_samples=32, seed=0,
                           backend="numpy")
    dev.seed_window(trace)
    ref.seed_window(trace)
    sim = paper_cluster_158(seed=7)
    cutoffs, censored, win_err = [], 0, 0.0
    t0 = time.perf_counter()
    for step in range(100):
        c_dev, c_ref = dev.predict_cutoff(), ref.predict_cutoff()
        check(c_dev == c_ref, f"dmm parity step {step}: cutoff {c_dev} on "
              f"the card, {c_ref} from the numpy backend")
        cutoffs.append(c_dev)
        times = sim.step()
        mask = times <= order_stats.iter_time(times, c_dev) + 1e-12
        censored += int(not mask.all())
        dev.observe(times, mask)
        ref.observe(times, mask)
        a, b = dev.window_array()[-1], ref.window_array()[-1]
        win_err = max(win_err, float(np.abs(a - b).max()))
        check(_rel_close(a, b, WINDOW_TOL), f"dmm parity step {step}: "
              f"window rows differ by {win_err}")
    modes = sorted(k[0] for k in dev.graphs)
    emit("dmm_parity", steps=100, k_samples=32, cutoffs=cutoffs,
         distinct_cutoffs=len(set(cutoffs)), censored_steps=censored,
         window_max_abs_err=win_err, window_tol=WINDOW_TOL,
         graphs=[list(map(str, k)) for k in dev.graphs],
         replays=dev.replays, seconds=time.perf_counter() - t0)
    check(censored >= 50, f"only {censored} censored steps")
    check(len(set(cutoffs)) > 1, "one cutoff for every step")
    check(len(modes) == len(set(modes)) and all(k[1] for k in dev.graphs),
          f"graphs {list(dev.graphs)}: want one decision graph a mode")
    check(dev.replays == 101, f"{dev.replays} graph replays for 101 "
          f"decisions")

    # (d) timing at n = 8 and n = 158, K = 64, lag 20
    timing = {}
    for n in (8, 158):
        sims = ((lambda s: ClusterSim(n_workers=8, n_nodes=2, seed=s))
                if n == 8 else (lambda s: paper_cluster_158(seed=s)))
        tr = sims(3).run(40)
        rm = RuntimeModel(n, lag=20, device="cuda").init(1)
        rm.norm_scale = float(2.0 * tr[:21].mean())
        ctl = CutoffController(rm, k_samples=64, seed=0)
        ctl.seed_window(tr)
        sim = sims(4)
        obs_us, pred_us = [], []
        for i in range(45):
            t0 = time.perf_counter()
            c = ctl.predict_cutoff()
            t1 = time.perf_counter()
            times = sim.step()
            mask = times <= order_stats.iter_time(times, c) + 1e-12
            t2 = time.perf_counter()
            ctl.observe(times, mask)
            t3 = time.perf_counter()
            if i >= 5:        # the first steps capture the graphs
                pred_us.append((t1 - t0) * 1e6)
                obs_us.append((t3 - t2) * 1e6)
        key = max(ctl.graphs, key=lambda k: k[0] == "censored")
        graph = ctl.graphs[key]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 50
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        per = kernels_per_call(torch, graph.replay)
        top = sorted(per.items(), key=lambda kv: -kv[1]["per_call"]
                     * kv[1]["us"])[:5]
        timing[n] = {
            "graph": list(map(str, key)),
            "decision_device_us": start.elapsed_time(end) / reps * 1e3,
            "observe_wall_us": float(np.median(obs_us)),
            "predict_cutoff_wall_us": float(np.median(pred_us)),
            "observe_plus_predict_wall_us": float(np.median(
                np.add(obs_us, pred_us))),
            "cuda_kernels_per_replay": sum(v["per_call"]
                                           for v in per.values()),
            "top_kernels": {k[:60]: v for k, v in top},
            "graphs_captured": len(ctl.graphs)}
        emit("dmm_timing", n=n, k_samples=64, lag=20, **timing[n])
        del ctl, graph
    torch.cuda.empty_cache()
    return timing


def phase_train_dmm(torch, cfg, params_f32, firstk_clocks):
    """Full-width qwen2-0.5b psum training (the train phase's setup) with
    the paper's controller: the DMM fitted on the card as
    examples/quickstart.py fits it, CutoffController(rm, k_samples=48)
    seeded with that trace.  Each step asserts the train phase's launch
    counts, a finite loss and one graph replay a decision; per step it
    prints the cutoff, the simulated clock, wall ms, predict_cutoff's
    wall µs and the device µs of the decision(s) launched in the step (CUDA
    events on the controller's stream around its launches).  Then the
    same trainer alternates first-k and the DMM for 6 steps, adjacent in
    time, to compare their wall per step."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController, FirstKController
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.kernels import build

    W, S, B, n_steps = 8, 128, 16, 5
    t_setup = time.perf_counter()
    trace = ClusterSim(n_workers=W, n_nodes=2, seed=0).run(200)
    rm = RuntimeModel(n_workers=W, lag=20, device="cuda").init(0)
    t0 = time.perf_counter()
    fit = rm.fit(trace, steps=200, batch=8)
    fit_s = time.perf_counter() - t0
    ctl = CutoffController(rm, k_samples=48)
    ctl.seed_window(trace)
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, _ = _train_setup(torch, cfg, params, n_workers=W, seq=S, batch=B,
                         controller=ctl,
                         timer=ClusterSim(n_workers=W, n_nodes=2, seed=7))

    # instrumentation on this instance only: host clock around
    # predict_cutoff, CUDA events around each fused launch
    predict_us, launches_ev = [], []
    predict, launch = ctl.predict_cutoff, ctl._launch

    def timed_predict():
        t0 = time.perf_counter()
        c = predict()
        predict_us.append((time.perf_counter() - t0) * 1e6)
        return c

    def timed_launch(mode, decide):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(ctl._stream)
        launch(mode, decide)
        ev[1].record(ctl._stream)
        launches_ev.append(ev)

    ctl.predict_cutoff, ctl._launch = timed_predict, timed_launch
    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals = {}
    torch.cuda.synchronize()
    emit("train_dmm_setup", fit_steps=200, fit_batch=8, fit_seconds=fit_s,
         fit_loss_first=fit[0], fit_loss_last=fit[-1],
         norm_scale=rm.norm_scale, k_samples=48,
         seconds=time.perf_counter() - t_setup)
    for i in range(n_steps):
        build.LAUNCHES.clear()
        n_ev, replays = len(launches_ev), ctl.replays
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        step_ev = launches_ev[n_ev:]
        for ev in step_ev:
            ev[1].synchronize()
        check(launches == want, f"dmm psum step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"dmm step {rec['step']}: loss {rec['loss']}")
        check(ctl.replays - replays == len(step_ev) == (2 if i == 0 else 1),
              f"dmm step {rec['step']}: {ctl.replays - replays} replays "
              f"for {len(step_ev)} decisions")
        emit("train_dmm", mask_agg="psum", step=rec["step"],
             wall_ms=wall * 1e3, tokens_per_s=B * S / wall, c=rec["c"],
             n=rec["n"], loss=rec["loss"], clock=rec["clock"],
             firstk_clock=(firstk_clocks[i] if i < len(firstk_clocks)
                           else None),
             predict_cutoff_wall_us=predict_us[-1],
             decision_device_us=[s.elapsed_time(e) * 1e3
                                 for s, e in step_ev],
             launches=launches, graphs=len(ctl.graphs),
             max_memory_allocated=torch.cuda.max_memory_allocated())
    # the wall cost of the controller itself: psum steps of the same
    # trainer alternating first-k and the DMM (A B A B A B), adjacent in
    # time; not asserted
    firstk = FirstKController(W, backup=2)
    walls = {"firstk": [], "dmm": []}
    for i in range(6):
        name = "dmm" if i % 2 else "firstk"
        tr.controller = ctl if i % 2 else firstk
        t0 = time.perf_counter()
        tr.run(1)
        walls[name].append((time.perf_counter() - t0) * 1e3)
    emit("train_dmm_ab", order="firstk,dmm x3", wall_ms=walls,
         median_ms={k: float(np.median(v)) for k, v in walls.items()})
    del tr, params, ctl
    torch.cuda.empty_cache()
    return totals, rm


# ---------------------------------------------------------------------------
# Telemetry (repro_torch.obs) attached to the full-width DMM training, the
# multi-tenant server, the supervisor and serving: no kernel of its own;
# the training path runs flash_attention, masked_grad_agg and fused_adam.
# ---------------------------------------------------------------------------

OBS_STEPS, OBS_EVERY = 6, 3    # two drains of three decisions each
OBS_PS_TICKS, OBS_PS_WARM = 25, 5
OBS_PS_J = (1, 3, 8)           # the flush breakdown's job counts (K 64)


def _is_sync(w):
    """A warning of sync debug mode about a synchronizing call (not its
    one-time notice that the mode is a prototype)."""
    msg = str(w.message)
    return "synchroniz" in msg and "prototype feature" not in msg


class _Stamped:
    """A timer that stamps the host clock at each step's draw (one a
    step): the gaps are the step walls, warm-up step excluded."""

    def __init__(self, inner):
        self.inner, self.stamps = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self):
        self.stamps.append(time.perf_counter())
        return self.inner.step()


def _obs_train(torch, cfg, params_f32, rm, trace, obs=None, wrap=None):
    """train_dmm's setup (full width, bf16, CutoffController(rm, 48)
    seeded with ``trace``, psum, fused AdamW, ClusterSim seed 7) with
    drains every OBS_EVERY steps, run OBS_STEPS steps in one ``run`` with
    the sync debug mode at "warn".  ``obs`` is attached and the controller
    wrapped for it (``wrap``, when given, goes between the two).  Returns
    the history, the controller wrapper, the run's wall seconds with the
    gaps between step starts (ms), where the steps made synchronizing
    calls outside the drains (file:line of each) and how many each drain
    made."""
    import warnings

    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController

    ctl = CutoffController(rm, k_samples=48)
    ctl.seed_window(trace)
    inner = wrap(ctl) if wrap is not None else ctl
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, _ = _train_setup(
        torch, cfg, params, n_workers=8, seq=128, batch=16,
        controller=obs.wrap(inner, policy="dmm") if obs else inner,
        timer=_Stamped(ClusterSim(n_workers=8, n_nodes=2, seed=7)))
    tr.metrics_every, tr.obs, tr.name = OBS_EVERY, obs, "dmm"
    drain, in_drains, drain_idx = tr._drain_metrics, [], set()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted():
            k = len(caught)
            drain()
            in_drains.append(sum(map(_is_sync, caught[k:])))
            drain_idx.update(range(k, len(caught)))

        tr._drain_metrics = counted
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            tr.run(OBS_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del tr._drain_metrics
        wall = time.perf_counter() - t0
    syncs = [f"{Path(w.filename).name}:{w.lineno}"
             for i, w in enumerate(caught)
             if _is_sync(w) and i not in drain_idx]
    hist, step_ms = tr.history, np.diff(tr.timer.stamps) * 1e3
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()
    return hist, inner, (wall, step_ms), syncs, in_drains


def _obs_ps(torch, rm, J, k_samples, obs=None, looped=False):
    """J jobs on train_dmm's width-8 model in one PSServer bucket
    (windows ClusterSim(8, 2 nodes, seed 30 + j), seeds 7 j), OBS_PS_TICKS
    ticks of the tick protocol (prefetch, predict, observe, flush).
    ``looped``: after each flush J looped CutoffControllers decide, as
    in ps_timing, so the next tick's launches meet a busy device.
    Returns the cutoff sequences, the final windows and, inside each
    flush, the host µs of the bucket's wait for its last launch and of
    its launch (upload, replay, fetch)."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.ps import PSServer

    srv = PSServer(obs=obs)
    ctls, loops = [], []
    for j in range(J):
        window = ClusterSim(n_workers=8, n_nodes=2, seed=30 + j).run(40)
        h = srv.admit(f"job{j}", rm, window=window, k_samples=k_samples,
                      seed=7 * j)
        ctls.append(obs.wrap(h, policy=f"job{j}") if obs else h)
        if looped:
            loops.append(CutoffController(rm, k_samples=k_samples,
                                          seed=7 * j))
            loops[-1].seed_window(window)
    b = next(iter(srv._buckets.values()))
    # host µs a flush spends in the bucket's waits and launches, summed
    # over the flush (its first launch captures, and the capture waits)
    parts, flushing = {"wait": [], "launch": []}, [False]

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if flushing[0]:
                parts[name][-1] += (time.perf_counter() - t0) * 1e6
            return out
        return run

    b.wait, b.launch = timed("wait", b.wait), timed("launch", b.launch)
    sims = [ClusterSim(n_workers=8, n_nodes=2, seed=50 + j)
            for j in range(J)]
    seqs = [[] for _ in range(J)]
    for _ in range(OBS_PS_TICKS):
        srv.prefetch()
        for j, ctl in enumerate(ctls):
            c = ctl.predict_cutoff()
            t = sims[j].step()
            ctl.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
            seqs[j].append(int(c))
        for v in parts.values():
            v.append(0.0)
        flushing[0] = True
        srv.flush()
        flushing[0] = False
        for j, ctl in enumerate(loops):
            c = ctl.predict_cutoff()
            t = sims[j].step()
            ctl.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
    if obs is not None:
        obs.drain()
    windows = [srv.window_array(f"job{j}") for j in range(J)]
    return seqs, windows, parts


def _obs_small_cost(torch, obs_cls, steps=36, reps=2):
    """Wall per step of supervised's small config (bench_tiny_config at
    head_dim 64, f32, Elfving over 6 workers), bare against obs attached
    (controller wrapped), in turns bare, obs, obs, bare."""
    from repro_torch import optim
    from repro_torch.cluster.simulator import paper_cluster_158
    from repro_torch.core.controller import ElfvingController
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import supervised as S
    from repro_torch.launch.train import Trainer, make_train_step
    from repro_torch.models import model as M

    cfg = S.supervised_config()
    opt = optim.adamw(3e-3)
    step_fn = make_train_step(cfg, opt)

    def run(with_obs, n):
        obs = obs_cls() if with_obs else None
        ctl = ElfvingController(SUP_WORKERS)
        tr = Trainer(step_fn=step_fn, data=SyntheticTokens(
            vocab_size=cfg.vocab_size, seq_len=8, global_batch=60, seed=0),
            controller=obs.wrap(ctl, policy="elfving") if obs else ctl,
            timer=paper_cluster_158(1, n_workers=SUP_WORKERS),
            n_workers=SUP_WORKERS, obs=obs, name="small")
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        tr.restore_or_init(lambda: {"params": params,
                                    "opt": opt.init(params)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6, tr.history

    run(False, 5)                       # warm-up: allocator, cuBLAS
    us = {"bare": [], "obs": []}
    hists = {}
    for with_obs in (False, True) * reps:
        key = "obs" if with_obs else "bare"
        step_us, hists[key] = run(with_obs, steps)
        us[key].append(step_us)
    same = [h["loss"] for h in hists["bare"]] == [h["loss"]
                                                  for h in hists["obs"]]
    return us, same


def phase_obs(torch, cfg, params_f32, rm):
    """Telemetry attached to the paths already on the card, each held
    against its bare twin bit for bit:

    * full-width qwen2-0.5b DMM training (train_dmm's setup and fitted
      model): a checking run whose controller is peeked synchronously
      (``.cpu()`` of the sample cloud) at every decision, then bare, then
      with an ObsRun writing its four streams.  Losses and cutoffs equal;
      every decision scored from its own samples (each recorded pred_iter
      equals the peek's); the synchronizing calls between drains equal
      with obs on and off; the kernel launches of the obs run;
    * PSServer at J = 3 (K 16) obs on against off: cutoffs and windows
      equal, ps.dispatch one level inside ps.flush, every record scored;
      then the host µs of ps.flush and ps.dispatch at J = 1, 3, 8 (K 64),
      the dispatch split into the bucket's wait and its launch, on an
      idle device and with J looped controllers between ticks;
    * the supervised storm obs on against off (losses, cutoffs, the drill
      report equal) and supervisor.tick's µs from its spans;
    * one short full-width request served obs on against off (ids equal);
    * the cost: step wall bare against obs at supervised's small config
      and at full width; ring push, drain and span µs;
    * the artifacts rendered by ``python -m repro_torch.obs`` (and
      ``--chrome``), the timeline summary on one line."""
    import os
    import tempfile

    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import _PolicyWrapper
    from repro_torch.kernels import build
    from repro_torch.launch import supervised as S
    from repro_torch.obs import ObsRun, report
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.engine import ServeEngine

    trace = ClusterSim(n_workers=8, n_nodes=2, seed=0).run(200)

    class Peek(_PolicyWrapper):
        """Checking run only: E[x_(c)] from a synchronous fetch of the
        sample cloud at each decision (the scorer's formula)."""

        def __init__(self, inner):
            super().__init__(inner)
            self.pred = []

        def predict_cutoff(self):
            c = self.inner.predict_cutoff()
            s = self.inner.predicted_samples()
            self.pred.append(None if s is None else float(np.sort(
                s.cpu().numpy().astype(np.float64), axis=1)[:, c - 1]
                .mean()))
            return c

    # -- full width: the checking run first (it also takes whatever a
    # first run after train_dmm does once), then bare and obs -----------
    chk_obs = ObsRun()
    chk, peek, _, _, _ = _obs_train(torch, cfg, params_f32, rm, trace,
                                    obs=chk_obs, wrap=Peek)
    bare, _, bare_s, bare_syncs, bare_drains = _obs_train(
        torch, cfg, params_f32, rm, trace)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        obs = ObsRun(os.path.join(d, "run"))
        build.LAUNCHES.clear()
        inst, _, obs_s, obs_syncs, obs_drains = _obs_train(
            torch, cfg, params_f32, rm, trace, obs=obs)
        launches = dict(build.LAUNCHES)
        obs.close()
        key = lambda h: [(r["c"], r["loss"]) for r in h]
        check(key(inst) == key(bare) == key(chk),
              f"obs: losses or cutoffs differ with obs on: bare "
              f"{key(bare)}, obs {key(inst)}, checking {key(chk)}")
        recs = obs.decisions.records
        check(len(recs) == OBS_STEPS and all(
            r["pred_iter"] is not None for r in recs),
            f"obs: {len(recs)} decisions recorded, "
            f"{sum(r['pred_iter'] is None for r in recs)} without samples")
        got = [r["pred_iter"] for r in chk_obs.decisions.records]
        check(got == peek.pred and [r["pred_iter"] for r in recs] == got,
              f"obs: recorded pred_iter {got} (obs run "
              f"{[r['pred_iter'] for r in recs]}) against the peeks "
              f"{peek.pred}")
        check(len(bare_drains) == len(obs_drains) >= 2,
              f"obs: drains {bare_drains} bare, {obs_drains} obs")
        check(obs_syncs == bare_syncs,
              f"obs: synchronizing calls between drains with obs "
              f"{obs_syncs}, bare {bare_syncs}")
        want = {"flash_attention": cfg.n_layers * 8 * OBS_STEPS,
                "masked_grad_agg": OBS_STEPS, "fused_adam": OBS_STEPS}
        check(launches == want, f"obs run launched {launches}, want {want}")
        spans = obs.trace.spans
        step_us = [s["dur_us"] for s in spans if s["name"] == "trainer.step"]
        emit("obs_train", arch=cfg.name, steps=OBS_STEPS,
             metrics_every=OBS_EVERY, cutoffs=[r["c"] for r in inst],
             losses_equal=True, decisions=len(recs),
             pred_iter=[r["pred_iter"] for r in recs],
             peek_pred_iter=peek.pred,
             syncs_between_drains={"bare": len(bare_syncs),
                                   "obs": len(obs_syncs)},
             sync_sites=sorted(set(bare_syncs)),
             syncs_in_drains={"bare": bare_drains, "obs": obs_drains},
             run_seconds={"bare": bare_s[0], "obs": obs_s[0]},
             step_gap_ms={"bare": bare_s[1].tolist(),
                          "obs": obs_s[1].tolist()},
             step_gap_ms_median={"bare": float(np.median(bare_s[1])),
                                 "obs": float(np.median(obs_s[1]))},
             trainer_step_span_us_median=float(np.median(step_us)),
             launches=launches)
        rows = report.timeline_summary(spans)
        emit("obs_timeline", rows=rows)
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent / "src"))
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", os.path.join(d, "run"),
             "--chrome", os.path.join(d, "trace.json")],
            capture_output=True, text=True, env=env, timeout=120)
        check(cli.returncode == 0 and "decision quality" in cli.stdout
              and "trainer.step" in cli.stdout,
              f"obs: the CLI failed ({cli.returncode}): {cli.stderr[-2000:]}")
        with open(os.path.join(d, "trace.json")) as f:
            n_chrome = len(json.load(f)["traceEvents"])
        emit("obs_cli", seconds=time.perf_counter() - t0,
             chrome_events=n_chrome, lines=len(cli.stdout.splitlines()))
    del bare, inst, chk

    # -- the multi-tenant server ----------------------------------------
    bare_seqs, bare_w, _ = _obs_ps(torch, rm, 3, 16)
    ps_obs = ObsRun()
    inst_seqs, inst_w, _ = _obs_ps(torch, rm, 3, 16, obs=ps_obs)
    check(inst_seqs == bare_seqs and all(
        np.array_equal(a, b) for a, b in zip(inst_w, bare_w)),
        "obs: the server's cutoffs or windows differ with obs on")
    by = {}
    for s in ps_obs.trace.spans:
        by.setdefault(s["name"], []).append(s)
    depth = by["ps.flush"][0]["depth"]
    check(len(by["ps.flush"]) == len(by["ps.dispatch"]) == OBS_PS_TICKS
          and all(s["depth"] == depth + 1 for s in by["ps.dispatch"]),
          "obs: ps.dispatch is not one level inside every ps.flush")
    recs = ps_obs.decisions.records
    check(len(recs) == 3 * OBS_PS_TICKS
          and all(r["pred_iter"] is not None for r in recs),
          "obs: server decisions unscored")
    breakdown = {}
    for looped in (False, True):
        for J in OBS_PS_J:
            t_obs = ObsRun()
            _, _, parts = _obs_ps(torch, rm, J, 64, obs=t_obs,
                                  looped=looped)
            flush = [s["dur_us"] for s in t_obs.trace.spans
                     if s["name"] == "ps.flush"][OBS_PS_WARM:]
            disp = [s["dur_us"] for s in t_obs.trace.spans
                    if s["name"] == "ps.dispatch"][OBS_PS_WARM:]
            wait = parts["wait"][OBS_PS_WARM:]
            launch = parts["launch"][OBS_PS_WARM:]
            med = lambda v: float(np.median(v))
            breakdown[("looped_" if looped else "") + f"J{J}"] = {
                "flush_us": med(flush), "dispatch_us": med(disp),
                "flush_minus_dispatch_us": med(np.subtract(flush, disp)),
                "wait_us": med(wait), "launch_us": med(launch),
                "dispatch_rest_us": med(np.subtract(
                    disp, np.add(wait, launch))),
                "ticks": len(flush)}
    emit("obs_ps", J=3, k_samples=16, ticks=OBS_PS_TICKS,
         cutoffs_equal=True, windows_equal=True, decisions=len(recs),
         breakdown_k64=breakdown)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the supervisor ---------------------------------------------------
    sup_bare = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                                device="cuda", verbose=False)
    sup_obs = ObsRun()
    sup_inst = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                                device="cuda", verbose=False, obs=sup_obs)
    sk = lambda out: [(h["n"], h["c"], h["loss"]) for h in out["history"]]
    check(sk(sup_inst) == sk(sup_bare) and sup_inst["match"]
          and sup_inst["report"] == sup_bare["report"],
          "obs: the supervised storm differs with obs on")
    tick_us = [s["dur_us"] for s in sup_obs.trace.spans
               if s["name"] == "supervisor.tick"]
    counters = sup_obs.metrics.summary()["counters"]
    check(len(tick_us) == SUP_STEPS
          and counters["supervisor.ticks"] == SUP_STEPS,
          f"obs: {len(tick_us)} supervisor.tick spans, counters {counters}")
    small_us, small_same = _obs_small_cost(torch, ObsRun)
    check(small_same, "obs: the small config's losses differ with obs on")

    # -- serving ----------------------------------------------------------
    params = cast(params_f32, "cuda", torch.bfloat16)
    engine = ServeEngine(cfg, params, device="cuda")
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(1, 16), dtype=np.int32)
    ids_bare = engine.generate(prompt, 8)
    engine.obs = serve_obs = ObsRun()
    ids_obs = engine.generate(prompt, 8)
    names = [s["name"] for s in serve_obs.trace.spans]
    check(np.array_equal(ids_bare, ids_obs)
          and names == ["serve.prefill", "serve.decode", "serve.fetch"],
          f"obs: served ids differ with obs on ({names})")
    del engine, params
    torch.cuda.empty_cache()

    # -- the collectors' own costs ---------------------------------------
    ring = MetricsRegistry().ring("cost", ("loss", "gnorm", "c",
                                           "iter_time"))
    loss = torch.ones((), device="cuda")
    for _ in range(20):
        ring.push((loss, loss, 5.0, 0.5))
    ring.drain()
    t0 = time.perf_counter()
    for _ in range(200):
        ring.push((loss, loss, 5.0, 0.5))
    push_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drained = ring.drain()
    drain_us = (time.perf_counter() - t0) * 1e6
    check(len(drained["rows"]) == 200, "obs: ring drain lost rows")
    tracer = Tracer()
    t0 = time.perf_counter()
    for _ in range(1000):
        with tracer.span("cost", track="t"):
            pass
    span_us = (time.perf_counter() - t0) / 1000 * 1e6
    emit("obs_cost", small_config_step_us=small_us,
         small_config_obs_over_bare=(float(np.median(small_us["obs"]))
                                     / float(np.median(small_us["bare"]))),
         full_width_step_gap_ms_median={
             "bare": float(np.median(bare_s[1])),
             "obs": float(np.median(obs_s[1]))},
         full_width_obs_over_bare=(float(np.median(obs_s[1]))
                                   / float(np.median(bare_s[1]))),
         ring_push_us=push_us, ring_drain_200_rows_us=drain_us,
         span_us=span_us, supervisor_tick_us_median=float(
             np.median(tick_us)), supervisor_tick_us_max=float(
             np.max(tick_us)), supervisor_counters=counters,
         serve_spans=names)
    return launches


# ---------------------------------------------------------------------------
# The straggler-policy frontier, compression and the checkpoint store on
# the full-width psum setup: no kernel of their own; the fold, the Elfving
# math and the compression are plain torch, the dropped mean and the
# anytime combine go through masked_grad_agg.
# ---------------------------------------------------------------------------

CKPT_SLACK = 1.05   # free space wanted beyond the checkpoint's bytes


def _cpu_copy(torch, t):
    """Leaves of a tree as a list of CPU copies (bit-exact compares)."""
    from repro_torch import tree

    return [x.detach().to("cpu", copy=True) for x in tree.leaves(t)]


def _bit_equal(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_train_policies(torch, cfg, params_f32, rm):
    """Full-width qwen2-0.5b psum training (train's setup: bf16, W 8, seq
    128, batch 16, fused AdamW, ClusterSim(8, 2 nodes, seed 7)) under the
    other straggler policies, with checkpoint/resume and compression:

      1. stale reuse: StaleReuseController(CutoffController(rm, 48),
         decay 0.5), 5 steps, 2 masked_grad_agg launches a step (the
         fresh and the dropped mean); the Trainer checkpoints at step 2
         (AsyncCheckpointer, a temporary directory);
      2. resume: a fresh Trainer restored from step 2 (the timer advanced
         to step 2) takes steps 3-4: params, m and v bit-equal to the
         uninterrupted run's, the same c; then from the same checkpoint 2
         steps with decay 0 against 2 discard steps (a plain psum step,
         the bare CutoffController): params bit-equal;
      3. Elfving: ElfvingController(8, warmup 2), 3 steps on
         paper_cluster_158(seed 0, n_workers 8): c below 8 after the
         warm-up (on ClusterSim(8, 2 nodes, seed 7) the runtimes' sd is
         9% of their mean and Eq. 3 keeps every worker);
      4. anytime: AnytimeController(FirstKController(8, 2), n_micro 2),
         grad_accum 2, 2 steps: flash 2 x L x 8 a step, a contribution
         strictly inside (0, 1);
      5. compression: compress_pod_grads, 2 steps, the ef residual's
         largest magnitude against the quantization step.

    ``rm`` is train_dmm's fitted RuntimeModel; the window is seeded with
    the trace it was fitted on.  Each trainer is freed before the next:
    a psum step holds its (8, 494,032,768) f32 buffer."""
    import shutil
    import tempfile

    from repro_torch import optim, tree
    from repro_torch.checkpoint import store
    from repro_torch.cluster.simulator import ClusterSim, paper_cluster_158
    from repro_torch.core.controller import (AnytimeController,
                                             CutoffController,
                                             ElfvingController,
                                             FirstKController,
                                             StaleReuseController)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import build
    from repro_torch.launch.train import Trainer, make_train_step

    W, S, B, L = 8, 128, 16, cfg.n_layers
    want = {"flash_attention": L * W, "masked_grad_agg": 1, "fused_adam": 1}
    want_stale = dict(want, masked_grad_agg=2)
    trace = ClusterSim(n_workers=W, n_nodes=2, seed=0).run(200)
    opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
    totals, out = {}, {"seconds": {}}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    def timer(steps=0):
        sim = ClusterSim(n_workers=W, n_nodes=2, seed=7)
        for _ in range(steps):
            sim.step()
        return sim

    def dmm():
        ctl = CutoffController(rm, k_samples=48)
        ctl.seed_window(trace)
        return ctl

    def trainer(step_fn, controller, sim, params=None, **kw):
        params = (params if params is not None
                  else cast(params_f32, "cuda", torch.bfloat16))
        tr = Trainer(step_fn=step_fn, data=SyntheticTokens(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=SEED),
            controller=controller, timer=sim, n_workers=W, mask_agg="psum",
            metrics_every=1, **kw)
        return tr.restore_or_init(
            lambda: {"params": params, "opt": opt.init(params)})

    def drive(tr, n_steps, policy, want_l):
        recs = []
        for _ in range(n_steps):
            build.LAUNCHES.clear()
            t0 = time.perf_counter()
            rec = tr.run(1)[-1]     # drains the loss: ends in a device sync
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            check(launches == want_l, f"{policy} step {rec['step']}: "
                  f"launches {launches}, want {want_l}")
            check(bool(np.isfinite(rec["loss"])),
                  f"{policy} step {rec['step']}: loss {rec['loss']}")
            emit("train_policies", policy=policy, step=rec["step"],
                 wall_ms=wall * 1e3, c=rec["c"], n=rec["n"],
                 loss=rec["loss"], clock=rec["clock"], launches=launches,
                 max_memory_allocated=torch.cuda.max_memory_allocated())
            recs.append(rec)
        return recs

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (1) stale reuse, checkpointed at step 2
        n_params = sum(x.numel() for x in tree.leaves(params_f32))
        need = n_params * (2 + 4 + 4 + 2)   # bf16 p, f32 m and v, bf16 stale
        free = shutil.disk_usage(ckpt_dir).free
        check(free >= CKPT_SLACK * need, f"{ckpt_dir}: {free} bytes free, "
              f"the checkpoint needs {need} (x {CKPT_SLACK})")
        stale_step = make_train_step(cfg, opt, mask_agg="psum",
                                     stale_reuse=True)
        tr = trainer(stale_step, StaleReuseController(dmm(), decay=0.5),
                     timer(), ckpt_dir=ckpt_dir, ckpt_every=2)
        ckpt_s = {}
        write, snapshot = store.save, store.AsyncCheckpointer.save

        def timed_write(*args, **kw):
            t0 = time.perf_counter()
            path = write(*args, **kw)
            ckpt_s["write"] = time.perf_counter() - t0
            return path

        def timed_snapshot(self, *args, **kw):
            t0 = time.perf_counter()
            snapshot(self, *args, **kw)
            ckpt_s["snapshot"] = time.perf_counter() - t0

        store.save, store.AsyncCheckpointer.save = timed_write, timed_snapshot
        try:
            recs = drive(tr, 2, "stale_reuse", want_stale)
        finally:
            store.save, store.AsyncCheckpointer.save = write, snapshot
        tr.ckpt_dir = None                  # one checkpoint, at step 2
        step_dir = Path(ckpt_dir) / f"step_{2:010d}"
        ckpt_bytes = {p.name: p.stat().st_size for p in step_dir.iterdir()}
        check(store.list_steps(ckpt_dir) == [2]
              and store.groups(ckpt_dir, 2) == ["ctl", "meta", "stale",
                                                "state"],
              f"checkpoint {store.list_steps(ckpt_dir)}: groups "
              f"{store.groups(ckpt_dir, 2)}")
        recs += drive(tr, 2, "stale_reuse", want_stale)
        after4 = (_cpu_copy(torch, tr.state["params"]),
                  _cpu_copy(torch, tr.state["opt"]["m"]),
                  _cpu_copy(torch, tr.state["opt"]["v"]))
        recs += drive(tr, 1, "stale_reuse", want_stale)
        check(min(r["c"] for r in recs) < W, f"stale reuse: no step "
              f"dropped a worker: c {[r['c'] for r in recs]}")
        out["stale_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["stale_c"] = [r["c"] for r in recs]
        emit("train_policies_checkpoint", step=2, bytes=ckpt_bytes,
             total_bytes=sum(ckpt_bytes.values()),
             snapshot_s=ckpt_s["snapshot"], write_s=ckpt_s["write"],
             free_bytes=free, stale_max_memory_allocated=out[
                 "stale_peak_bytes"])
        del tr
        torch.cuda.empty_cache()

        # (2) resume from step 2: bit-equal to the uninterrupted steps 3-4
        t0 = time.perf_counter()
        tr = trainer(stale_step, StaleReuseController(dmm(), decay=0.5),
                     timer(2), ckpt_dir=ckpt_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(tr.step == 2 and tr.controller._step == 2
              and tr._stale is not None, f"restored step {tr.step}, "
              f"controller step {tr.controller._step}")
        resumed = drive(tr, 2, "stale_reuse_resumed", want_stale)
        got = (_cpu_copy(torch, tr.state["params"]),
               _cpu_copy(torch, tr.state["opt"]["m"]),
               _cpu_copy(torch, tr.state["opt"]["v"]))
        same = {k: _bit_equal(torch, a, b)
                for k, a, b in zip(("params", "m", "v"), got, after4)}
        same_c = [r["c"] for r in resumed] == out["stale_c"][2:4]
        emit("train_policies_resume", restore_s=restore_s,
             c=[r["c"] for r in resumed], uninterrupted_c=out["stale_c"][2:4],
             bit_equal=same)
        check(all(same.values()) and same_c, f"resumed run differs from "
              f"the uninterrupted one: {same}, c {same_c}")
        del tr, got, after4
        torch.cuda.empty_cache()

        # decay 0 against discard, both from the step-2 checkpoint
        tr = trainer(stale_step, StaleReuseController(dmm(), decay=0.0),
                     timer(2), ckpt_dir=ckpt_dir)
        d0 = drive(tr, 2, "stale_decay0", want_stale)
        d0_params = _cpu_copy(torch, tr.state["params"])
        del tr, stale_step
        torch.cuda.empty_cache()
        plain_step = make_train_step(cfg, opt, mask_agg="psum")
        tr = trainer(plain_step, dmm(), timer(2), ckpt_dir=ckpt_dir)
        discard = drive(tr, 2, "discard", want)
        same = _bit_equal(torch, _cpu_copy(torch, tr.state["params"]),
                          d0_params)
        emit("train_policies_decay0", c=[r["c"] for r in d0],
             discard_c=[r["c"] for r in discard], params_bit_equal=same)
        check(same and [r["c"] for r in d0] == [r["c"] for r in discard],
              "decay 0 differs from discard")
        del tr, d0_params
    finally:
        # reprolint: disable=nonatomic-checkpoint-write -- removes the phase's own scratch directory (this run's checkpoints) once the phase is done
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (3) Elfving, on the discard step (its buffer reused)
    tr = trainer(plain_step, ElfvingController(W, warmup=2),
                 paper_cluster_158(seed=0, n_workers=W))
    elf = drive(tr, 3, "elfving", want)
    check(elf[-1]["c"] < W, f"elfving: c {[r['c'] for r in elf]}, want a "
          f"cut after the warm-up")
    del tr, plain_step
    torch.cuda.empty_cache()

    # (4) anytime: fractional contributions through the same kernel
    contribs = []
    ctl = AnytimeController(FirstKController(W, backup=2), n_micro=2)
    contribution = ctl.contribution

    def recorded(times, c):
        contribs.append(contribution(times, c))
        return contribs[-1]

    ctl.contribution = recorded
    tr = trainer(make_train_step(cfg, opt, mask_agg="psum", grad_accum=2),
                 ctl, timer())
    drive(tr, 2, "anytime", dict(want, flash_attention=2 * L * W))
    fractional = [float(f) for fs in contribs for f in fs if 0 < f < 1]
    emit("train_policies_anytime", contributions=[c.tolist()
                                                  for c in contribs])
    check(bool(fractional), f"anytime: no fractional contribution in "
          f"{[c.tolist() for c in contribs]}")
    del tr, ctl
    torch.cuda.empty_cache()

    # (5) compression: the optimizer sees the dequantized gradient
    qstep = []

    def update(grads, state, params=None):
        qstep.append(torch.stack([g.float().abs().max()
                                  for g in tree.leaves(grads)]) / 127.0)
        return opt.update(grads, state, params)

    qopt = optim.Optimizer(opt.init, update, opt.table)
    tr = trainer(make_train_step(cfg, qopt, mask_agg="psum",
                                 compress_pod_grads=True),
                 FirstKController(W, backup=2), timer())
    drive(tr, 2, "compressed", want)
    ef_max = torch.stack([e.abs().max() for e in tree.leaves(
        tr.state["ef"])])
    ratio = float((ef_max / qstep[-1].clamp(min=1e-30)).max())
    emit("train_policies_compression", ef_max_abs=float(ef_max.max()),
         quant_step_max=float(qstep[-1].max()), ef_over_step_max=ratio,
         ef_bytes=sum(e.numel() * 4 for e in tree.leaves(tr.state["ef"])))
    # |ef| <= step / 2 per leaf; the step is read back from bf16 values
    check(bool((ef_max <= 0.51 * qstep[-1] + 1e-12).all()),
          f"ef residual beyond half a quantization step: {ratio}")
    del tr, qopt
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    emit("train_policies_summary", **out, launches=totals)
    return totals


# ---------------------------------------------------------------------------
# Elastic membership on the full-width psum setup: the ElasticController
# with its async DMM refit through an 8 -> 6 -> 8 churn.  No kernel of its
# own; the psum step's three kernels run at W = 6.
# ---------------------------------------------------------------------------

ELASTIC_BATCH = 24     # divisible by 8 and by 6 (train's 16 is not by 6)
ELASTIC_LAG = 10       # launch/elastic.py's DMM
REFIT_STEPS = 60
REFIT_FRESH = 3
KILL_AT = 6            # ChurnSim steps: kill (6, 7) here, restore later
ELASTIC_CKPT = 12      # the mid-churn checkpoint (width 6)
# the schedule's sizing: a width's first REFIT_FRESH steps feed the refit,
# which may run REFIT_SLOWDOWN x its lone wall beside the trainer (they
# share the interpreter lock: up to 5.3x in a run on an H100 80GB HBM3 at
# 700 W), over steps of at least STEP_S_MIN seconds (medians of 0.84-2.11
# s there); then 2 DMM steps.  Both bounds sit outside what was measured.
REFIT_SLOWDOWN = 6.0
STEP_S_MIN = 0.7


def _elastic_capture(torch, rm, trace):
    """A width-8 refit of REFIT_STEPS steps on the card through
    ``_spawn_refit`` (``ElasticController._fit_model``: a stream of its
    own) while the main thread builds a CutoffController on ``rm`` and
    makes 5 decisions (2 graph captures, then replays).  Against the
    same decisions with no fit running (identical cutoffs) and the same
    fit alone (its loss trajectory)."""
    from repro_torch.cluster.simulator import paper_cluster_158
    from repro_torch.core.controller import (CutoffController,
                                             ElasticController,
                                             _poll_refit_task, _spawn_refit)
    from repro_torch.core.runtime_model.api import RuntimeModel

    ectl = ElasticController(rm, k_samples=32, seed=0,
                             refit_steps=REFIT_STEPS)
    losses = []
    fit = RuntimeModel.fit

    def recorded_fit(self, *args, **kw):
        out = fit(self, *args, **kw)
        losses.append(out)
        return out

    def decide():
        t0 = time.perf_counter()
        ctl = CutoffController(rm, k_samples=32, seed=0)
        ctl.seed_window(trace)
        sim = paper_cluster_158(seed=5, n_workers=8)
        cutoffs = []
        for _ in range(5):
            c = ctl.predict_cutoff()
            cutoffs.append(c)
            times = sim.step()
            mask = np.zeros(8, bool)
            mask[np.argsort(times)[:c]] = True
            ctl.observe(times, mask)
        ctl._wait()
        return {"cutoffs": cutoffs, "graphs": len(ctl.graphs),
                "replays": ctl.replays, "s": time.perf_counter() - t0}

    def refit():
        return _spawn_refit(lambda: ectl._fit_model(trace, 8, 1), 0)

    def finish(task):
        task[0].join(timeout=600)
        check(not task[0].is_alive(), "refit thread still running")
        done, model, err = _poll_refit_task(task, 0, 8)
        if err is not None:
            raise RuntimeError(f"refit raised: {err!r}") from err
        check(done and model is not None, "refit gave no model")
        return model

    RuntimeModel.fit = recorded_fit
    try:
        alone = decide()
        t0 = time.perf_counter()
        finish(refit())
        refit_alone_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        task = refit()
        time.sleep(0.3)             # the fit is inside its step loop
        busy = decide()
        alive = task[0].is_alive()
        finish(task)
        refit_busy_s = time.perf_counter() - t0
    finally:
        RuntimeModel.fit = fit
    a, b = (np.asarray(x) for x in losses)
    scale = float(np.abs(a).max())
    fit_err = float(np.abs(a - b).max())
    out = {"refit_steps": REFIT_STEPS, "refit_alone_s": refit_alone_s,
           "refit_beside_captures_s": refit_busy_s,
           "decisions_alone_s": alone["s"],
           "decisions_beside_refit_s": busy["s"],
           "cutoffs": busy["cutoffs"], "cutoffs_no_fit": alone["cutoffs"],
           "graphs": busy["graphs"], "replays": busy["replays"],
           "fit_alive_after_decisions": alive,
           "fit_losses_bit_equal": bool(np.array_equal(a, b)),
           "fit_loss_max_abs_err": fit_err, "fit_loss_tol": FIT_TOL * scale,
           "fit_loss_first_last": [a[0], a[-1]]}
    emit("elastic_capture", **out)
    check(alive, "the refit ended before the decisions did: nothing was "
          "captured beside it")
    check(busy["cutoffs"] == alone["cutoffs"], f"cutoffs beside a refit "
          f"{busy['cutoffs']}, alone {alone['cutoffs']}")
    check(busy["graphs"] == alone["graphs"] >= 2, f"graphs {busy['graphs']} "
          f"beside the refit, {alone['graphs']} alone")
    check(fit_err <= FIT_TOL * scale, f"the refit beside the captures "
          f"drifted from the lone fit by {fit_err} > {FIT_TOL} x {scale}")
    return out


def phase_train_elastic(torch, cfg, params_f32):
    """Full-width qwen2-0.5b psum training (bf16, seq 128, batch 24, fused
    AdamW) through an 8 -> 6 -> 8 churn under ElasticController(rm,
    k_samples 32, refit_steps 60, refit_fresh 3, fallback_warmup 2,
    refit_async): rm is RuntimeModel(8, lag 10) fitted on the card on
    paper_cluster_158(0, 8).run(120) for 150 steps (launch/elastic.py's
    fit), seeded with the trace's last 40 rows; the timer
    ChurnSim(paper_cluster_158(1, 8)) kills workers 6 and 7 at step 6 and
    restores them after a gap sized from the refit's measured wall.

    First the concurrency check (``_elastic_capture``).  Then every step
    asserts the launches at its width, a finite loss and 1 <= c <= n; the
    widths run 8, 6, 8, and at each new width the fallback decides first,
    then the refitted DMM, before the next event.  A checkpoint at step 12
    (width 6); once the first trainer is freed, a fresh trainer built at
    width 8 restores it: width 6, members 0..5, the window allclose to the
    saved one; 2 steps.  One masked_grad_agg call timed on the trainer's
    own (6, N) buffer."""
    import shutil
    import tempfile

    from repro_torch import optim, tree
    from repro_torch.checkpoint import store
    from repro_torch.cluster.simulator import (ChurnEvent, ChurnSim,
                                               paper_cluster_158)
    from repro_torch.core.controller import ElasticController
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import reference_masked_agg
    from repro_torch.launch.train import Trainer, make_train_step

    W, S, B, L = 8, 128, ELASTIC_BATCH, cfg.n_layers
    t_phase = time.perf_counter()
    trace = paper_cluster_158(0, n_workers=W).run(120)
    rm = RuntimeModel(W, lag=ELASTIC_LAG, device="cuda").init(0)
    t0 = time.perf_counter()
    fit = rm.fit(trace, steps=150, batch=8, seed=0)
    fit_s = time.perf_counter() - t0
    capture = _elastic_capture(torch, rm, trace)

    gap = REFIT_FRESH + math.ceil(REFIT_SLOWDOWN * capture["refit_alone_s"]
                                  / STEP_S_MIN) + 2
    gap = max(gap, ELASTIC_CKPT - KILL_AT + 1)
    restore_at, n_steps = KILL_AT + gap, KILL_AT + 2 * gap
    opt = optim.adamw(optim.cosine_schedule(3e-4, 2, 20), fused=True)
    out = {"fit_seconds": fit_s, "fit_loss_first_last": [fit[0], fit[-1]],
           "schedule": {"kill": KILL_AT, "restore": restore_at,
                        "steps": n_steps, "checkpoint": ELASTIC_CKPT}}

    def churn(steps_done=0):
        sim = ChurnSim(paper_cluster_158(1, n_workers=W),
                       [ChurnEvent(step=KILL_AT, kill=(6, 7)),
                        ChurnEvent(step=restore_at, restore=(6, 7))])
        for _ in range(steps_done):
            sim.step()
        return sim

    def elastic():
        ctl = ElasticController(rm, k_samples=32, seed=0,
                                refit_steps=REFIT_STEPS,
                                refit_fresh=REFIT_FRESH, fallback_warmup=2,
                                refit_async=True)
        ctl.seed_window(trace[-40:])
        return ctl

    def trainer(ctl, sim, **kw):
        params = cast(params_f32, "cuda", torch.bfloat16)
        tr = Trainer(step_fn=make_train_step(cfg, opt, mask_agg="psum"),
                     data=SyntheticTokens(vocab_size=cfg.vocab_size,
                                          seq_len=S, global_batch=B,
                                          seed=SEED),
                     controller=ctl, timer=sim, n_workers=W,
                     mask_agg="psum", metrics_every=1, **kw)
        return tr.restore_or_init(
            lambda: {"params": params, "opt": opt.init(params)})

    totals = {}

    def one_step(tr, phase, ctl, extra=None):
        job = ctl._refit_job
        alive0 = job is not None and job[0].is_alive()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        n, c = rec["n"], rec["c"]
        want = {"flash_attention": L * n, "masked_grad_agg": 1,
                "fused_adam": 1}
        check(launches == want, f"{phase} step {rec['step']} (n {n}): "
              f"launches {launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"{phase} step {rec['step']}: loss {rec['loss']}")
        check(1 <= c <= n, f"{phase} step {rec['step']}: c {c} of {n}")
        job = ctl._refit_job
        r = {"step": rec["step"], "n": n, "c": c, "mode": modes[-1],
             "refit_in_flight": [alive0,
                                 job is not None and job[0].is_alive()],
             "graphs": len(ctl._dmm.graphs) if ctl._dmm is not None else 0,
             "wall_ms": wall * 1e3, "loss": rec["loss"],
             "clock": rec["clock"], "launches": launches,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "memory_reserved": torch.cuda.memory_reserved(), **(extra or {})}
        emit(phase, **r)
        return r

    # instrumentation on this instance only: the mode of each decision,
    # the refits' fit time on their thread, and when each install happened
    modes, refits = [], []
    ctl = elastic()
    predict, fit_model, install = (ctl.predict_cutoff, ctl._fit_model,
                                   ctl._install_dmm)

    def traced_predict():
        c = predict()
        modes.append(ctl.mode)
        return c

    def timed_fit(rows, n, seed):
        r = {"n": n, "seed": seed, "rows": len(rows),
             "spawned": time.perf_counter(), "spawn_step": tr.step}
        refits.append(r)
        model = fit_model(rows, n, seed)
        r["fit_s"] = time.perf_counter() - r["spawned"]
        return model

    def timed_install(model):
        install(model)
        r = refits[-1]
        r["spawn_to_install_s"] = time.perf_counter() - r["spawned"]
        r["install_step"] = tr.step + 1

    ctl.predict_cutoff, ctl._fit_model = traced_predict, timed_fit
    ctl._install_dmm = timed_install
    bufs = []
    aggregate = ops.WorkerGrads.aggregate

    def kept_aggregate(self, mask):
        bufs[:] = [self]           # the psum step's own (W, N) buffer
        return aggregate(self, mask)

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    steps, mem, ckpt_s = [], {}, {}
    try:
        n_params = sum(x.numel() for x in tree.leaves(params_f32))
        need = n_params * (2 + 4 + 4)       # bf16 p, f32 m and v
        free = shutil.disk_usage(ckpt_dir).free
        check(free >= CKPT_SLACK * need, f"{ckpt_dir}: {free} bytes free, "
              f"the checkpoint needs {need} (x {CKPT_SLACK})")
        tr = trainer(ctl, churn(), ckpt_dir=ckpt_dir,
                     ckpt_every=ELASTIC_CKPT)
        write, snapshot = store.save, store.AsyncCheckpointer.save

        def timed_write(*args, **kw):
            t0 = time.perf_counter()
            path = write(*args, **kw)
            ckpt_s["write"] = time.perf_counter() - t0
            return path

        def timed_snapshot(self, *args, **kw):
            t0 = time.perf_counter()
            snapshot(self, *args, **kw)
            ckpt_s["snapshot"] = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        agg = None
        for i in range(n_steps):
            if i in (KILL_AT, restore_at):
                torch.cuda.reset_peak_memory_stats()
            if i + 1 == ELASTIC_CKPT:
                store.save = timed_write
                store.AsyncCheckpointer.save = timed_snapshot
            if i == restore_at - 1:
                # keep the buffer of the last width-6 step only: held
                # across a resize, it would sit beside the next width's
                ops.WorkerGrads.aggregate = kept_aggregate
            try:
                steps.append(one_step(tr, "train_elastic", ctl))
            finally:
                store.save, store.AsyncCheckpointer.save = write, snapshot
                ops.WorkerGrads.aggregate = aggregate
            if tr.step == ELASTIC_CKPT:
                tr.ckpt_dir = None          # one checkpoint, at width 6
            n = steps[-1]["n"]
            m = mem.setdefault(str(n) if i < restore_at else f"{n}_again",
                               {})
            m["max_memory_allocated"] = steps[-1]["max_memory_allocated"]
            m["memory_reserved"] = max(m.get("memory_reserved", 0),
                                       steps[-1]["memory_reserved"])
            if i == restore_at - 1:
                # the trainer's own (6, N) buffer, the DMM back (no fit
                # thread beside the timing's graph capture)
                check(ctl._refit_job is None and n == 6, "a refit is still "
                      "in flight at the end of width 6")
                g = bufs[0].buf
                mask = _agg_masks(torch, g.shape[0], torch.Generator(
                    device="cuda").manual_seed(SEED))["bits"]
                got = ops.masked_aggregate(g, mask)
                want = reference_masked_agg(g, mask.reshape(-1, 1))[0]
                err = (got - want).abs().max().item()
                ex = _allclose_excess(torch, got, want, AGG_TOL["float32"],
                                      AGG_TOL["float32"]).item()
                del got, want
                agg = {"W": g.shape[0], "N": g.shape[1], "max_abs_err": err,
                       **_agg_times(torch, torch.cuda.Stream(), g, mask, 5)}
                emit("train_elastic_masked_grad_agg", **agg)
                check(ex <= AGG_TOL["float32"], f"masked_grad_agg on the "
                      f"(6, N) buffer: off by {ex}")
                del g, mask, bufs[:]
        saved = store.restore_group(ckpt_dir, "ctl", step=ELASTIC_CKPT)
        step_dir = Path(ckpt_dir) / f"step_{ELASTIC_CKPT:010d}"
        ckpt_bytes = {p.name: p.stat().st_size for p in step_dir.iterdir()}
        out["checkpoint"] = dict(ckpt_s, bytes=ckpt_bytes,
                                 total_bytes=sum(ckpt_bytes.values()),
                                 free_bytes=free)
        del tr, ctl
        torch.cuda.empty_cache()

        # a fresh trainer at width 8 restores the mid-churn checkpoint
        ctl2 = elastic()
        modes.clear()
        predict2 = ctl2.predict_cutoff

        def traced_predict2():
            c = predict2()
            modes.append(ctl2.mode)
            return c

        ctl2.predict_cutoff = traced_predict2
        t0 = time.perf_counter()
        tr = trainer(ctl2, churn(ELASTIC_CKPT), ckpt_dir=ckpt_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        warm = bool(np.allclose(ctl2.window_array(), saved["window"]))
        out["restart"] = {"restore_s": restore_s, "step": tr.step,
                          "n": tr.n_workers, "members": tr.members.tolist(),
                          "window_allclose": warm, "mode": ctl2.mode}
        check(tr.step == ELASTIC_CKPT and tr.n_workers == 6
              and tr.members.tolist() == list(range(6)) and warm,
              f"restart: {out['restart']}")
        tr.ckpt_dir = None
        resumed = [one_step(tr, "train_elastic_resumed", ctl2)
                   for _ in range(2)]
        out["restart"]["c"] = [r["c"] for r in resumed]
        out["restart"]["wall_ms"] = [r["wall_ms"] for r in resumed]
        del tr, ctl2
        torch.cuda.empty_cache()
    finally:
        ops.WorkerGrads.aggregate = aggregate
        # reprolint: disable=nonatomic-checkpoint-write -- removes the phase's own scratch directory (this run's checkpoints) once the phase is done
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # the summary, printed before it is checked
    widths = [s["n"] for s in steps]
    runs = [(s["n"], s["mode"]) for i, s in enumerate(steps)
            if i == 0 or (steps[i - 1]["n"], steps[i - 1]["mode"])
            != (s["n"], s["mode"])]
    first = {f"{steps[i]['n']}@{steps[i]['step']}": steps[i]["wall_ms"]
             for i in (KILL_AT, restore_at)}
    skip = {0, KILL_AT, restore_at, ELASTIC_CKPT - 1}
    skip |= {i for i in range(1, len(steps))
             if steps[i]["graphs"] != steps[i - 1]["graphs"]}
    medians = {}
    for n in (8, 6):
        kept = [s for i, s in enumerate(steps) if i not in skip
                and s["n"] == n]
        busy = [s["wall_ms"] for s in kept if all(s["refit_in_flight"])]
        idle = [s["wall_ms"] for s in kept if not any(s["refit_in_flight"])]
        medians[str(n)] = {
            "refit_in_flight": float(np.median(busy)) if busy else None,
            "no_refit": float(np.median(idle)) if idle else None,
            "steps": [len(busy), len(idle)]}
    for r in refits:
        r.pop("spawned")
    out.update(widths=widths, mode_runs=runs, refits=refits,
               first_step_after_resize_ms=first,
               median_wall_ms_by_width=medians,
               memory_by_width=mem, masked_grad_agg_w6=agg,
               launches=totals, seconds=time.perf_counter() - t_phase)
    emit("train_elastic_summary", **out)
    check([w for i, w in enumerate(widths) if i == 0 or widths[i - 1] != w]
          == [8, 6, 8], f"widths {widths}")
    check(runs == [(8, "dmm"), (6, "fallback"), (6, "dmm"), (8, "fallback"),
                   (8, "dmm")], f"mode runs {runs}: a refit did not land "
          f"in time (refits {refits}; steps of {capture['refit_alone_s']:.2f}"
          f" s alone)")
    check(len(refits) == 2 and all("spawn_to_install_s" in r
                                    for r in refits), f"refits {refits}")
    return totals, agg


# ---------------------------------------------------------------------------
# The multi-tenant parameter server: no kernel of its own (the decision is
# torch ops in one CUDA graph a bucket); its parity, its timing beside the
# looped controllers, and three full-width jobs through a worker churn.
# ---------------------------------------------------------------------------

PS_WIDTHS = (16, 10, 6)   # the ragged bucket (tests/test_torch_ps.py)
PS_TICKS = 100
PS_K = 16
PS_TIMING = (("j1_n8", (8,)), ("j3_n8", (8,) * 3), ("j8_n8", (8,) * 8),
             ("ragged_16_10_6", PS_WIDTHS))
MJ_JOBS, MJ_W = 3, 6       # three jobs of 6 workers: partitions of 18
MJ_VICTIMS = (6, 7)        # job1's first two workers
MJ_KILL = 8                # the kill takes effect at this tick
MJ_RESTORE_MIN = 18        # the restore no earlier than this tick ...
MJ_DMM_TICKS = 2           # ... and after this many DMM ticks at width 4
MJ_TICKS_MIN = 26
MJ_TICKS_MAX = 60


def _runs(seq):
    """Consecutive runs of equal items, each kept once."""
    return [x for i, x in enumerate(seq) if i == 0 or seq[i - 1] != x]


def _graph_device_us(torch, graph, reps=50):
    """Device µs of one replay of ``graph``: ``reps`` back-to-back replays
    between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def _ps_parity(torch):
    """J = 3 ragged jobs (16/10/6) over PS_TICKS ticks: the card's server
    against three looped device controllers and against the server on the
    CPU; then J = 1 at n = 158 against the card's own controller."""
    from repro_torch.cluster.simulator import paper_cluster_158
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.ps import PSServer

    t0 = time.perf_counter()
    card, cpu = PSServer(), PSServer()
    refs, hc, hp, sims = [], [], [], []
    for j, n in enumerate(PS_WIDTHS):
        trace = paper_cluster_158(seed=n, n_workers=n).run(40)
        rm = RuntimeModel(n, lag=10, device="cuda").init(0)
        rm.fit(trace, steps=50, batch=8, seed=0)
        ref = CutoffController(rm, k_samples=PS_K, seed=11 * j)
        ref.seed_window(trace)
        refs.append(ref)
        hc.append(card.admit(f"job{j}", rm, window=trace, k_samples=PS_K,
                             seed=11 * j))
        hp.append(cpu.admit(f"job{j}", rm.to("cpu"), window=trace,
                            k_samples=PS_K, seed=11 * j))
        sims.append(paper_cluster_158(seed=300 + j, n_workers=n))
    fit_s = time.perf_counter() - t0
    check(len(card._buckets) == 1, "mixed widths must share one bucket")
    b = next(iter(card._buckets.values()))
    censored, seqs = 0, [[] for _ in PS_WIDTHS]
    t0 = time.perf_counter()
    for tick in range(PS_TICKS):
        card.prefetch()
        cpu.prefetch()
        for j in range(len(PS_WIDTHS)):
            c = (refs[j].predict_cutoff(), hc[j].predict_cutoff(),
                 hp[j].predict_cutoff())
            check(c[0] == c[1] == c[2], f"ps_parity tick {tick} job{j}: "
                  f"cutoffs {c} (looped controller, card server, CPU server)")
            seqs[j].append(c[0])
            t = sims[j].step()
            mask = t <= order_stats.iter_time(t, c[0]) + 1e-12
            censored += int(not mask.all())
            for h in (refs[j], hc[j], hp[j]):
                h.observe(t, mask)
        fl = (card.flush(), cpu.flush())
        check(fl == (1, 1), f"ps_parity tick {tick}: flush {fl}, want 1 "
              f"launch a tick on each server")
    err_ref = err_cpu = 0.0
    for j in range(len(PS_WIDTHS)):
        a, r, p = (hc[j].window_array(), refs[j].window_array(),
                   hp[j].window_array())
        err_ref = max(err_ref, float(np.abs(a - r).max()))
        err_cpu = max(err_cpu, float(np.abs(a - p).max()))
        check(_rel_close(a, r, SERVER_WINDOW_TOL)
              and _rel_close(a, p, SERVER_WINDOW_TOL),
              f"ps_parity job{j}: windows differ by {err_ref} (controller) "
              f"and {err_cpu} (CPU server)")
    out = {"J": len(PS_WIDTHS), "widths": list(PS_WIDTHS), "n_pad": b.n_pad,
           "ticks": PS_TICKS, "k_samples": PS_K,
           "cutoffs": {f"job{j}": s for j, s in enumerate(seqs)},
           "distinct_cutoffs": [len(set(s)) for s in seqs],
           "censored_observations": censored,
           "window_max_abs_err_vs_controllers": err_ref,
           "window_max_abs_err_vs_cpu_server": err_cpu,
           "window_tol": SERVER_WINDOW_TOL, "graphs": sorted(b.graphs),
           "captures": b.captures, "replays": b.replays,
           "dispatches": card.dispatches, "fit_seconds": fit_s,
           "seconds": time.perf_counter() - t0}
    emit("ps_parity", **out)
    check(censored >= 50, f"only {censored} censored observations")
    check(any(len(set(s)) > 1 for s in seqs), "one cutoff for every step")
    check(b.captures == 2 and b.replays == PS_TICKS + 1,
          f"{b.captures} captures and {b.replays} replays for "
          f"{PS_TICKS} ticks: want 2 and {PS_TICKS + 1}")

    # J = 1 at n = 158 against the card's own controller
    t0 = time.perf_counter()
    trace = paper_cluster_158(seed=0).run(60)
    rm = RuntimeModel(158, lag=20, device="cuda").init(0)
    rm.fit(trace, steps=30, batch=8, seed=0)
    ref = CutoffController(rm, k_samples=32, seed=0)
    ref.seed_window(trace)
    srv = PSServer()
    h = srv.admit("job0", rm, window=trace, k_samples=32, seed=0)
    sim = paper_cluster_158(seed=7)
    cutoffs, censored = [], 0
    for step in range(100):
        c = (ref.predict_cutoff(), h.predict_cutoff())
        check(c[0] == c[1], f"ps_parity_158 step {step}: cutoffs {c} "
              f"(controller, server)")
        cutoffs.append(c[0])
        t = sim.step()
        mask = t <= order_stats.iter_time(t, c[0]) + 1e-12
        censored += int(not mask.all())
        ref.observe(t, mask)
        h.observe(t, mask)
        check(srv.flush() == 1, f"ps_parity_158 step {step}: flush")
    a, r = h.window_array(), ref.window_array()
    out158 = {"n": 158, "steps": 100, "k_samples": 32,
              "distinct_cutoffs": len(set(cutoffs)),
              "censored_steps": censored,
              "window_max_abs_err": float(np.abs(a - r).max()),
              "seconds": time.perf_counter() - t0}
    emit("ps_parity_158", **out158)
    check(censored >= 50 and len(set(cutoffs)) > 1, f"ps_parity_158: "
          f"{censored} censored steps, {len(set(cutoffs))} cutoffs")
    check(_rel_close(a, r, SERVER_WINDOW_TOL), f"ps_parity_158: windows "
          f"differ by {out158['window_max_abs_err']}")
    return out


def _ps_timing(torch):
    """For each PS_TIMING case (K 64, lag 20, as dmm_timing): the bucket's
    observe+decide graph (device µs a replay, CUDA kernels a replay) and
    the host µs of a tick's flush and predict_cutoff fetches, beside the
    same jobs decided by J looped device controllers."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.cutoff import order_stats
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.ps import PSServer

    K, lag, ticks, warm = 64, 20, 30, 5
    out = {}
    for case, widths in PS_TIMING:
        J = len(widths)
        models, traces = [], []
        for j, n in enumerate(widths):
            tr = ClusterSim(n_workers=n, n_nodes=2, seed=3 + j).run(40)
            rm = RuntimeModel(n, lag=lag, device="cuda").init(1 + j)
            rm.norm_scale = float(2.0 * tr[:lag + 1].mean())
            models.append(rm)
            traces.append(tr)
        srv = PSServer()
        hs = [srv.admit(f"job{j}", rm, window=tr, k_samples=K, seed=j)
              for j, (rm, tr) in enumerate(zip(models, traces))]
        ctls = []
        for j, (rm, tr) in enumerate(zip(models, traces)):
            ctl = CutoffController(rm, k_samples=K, seed=j)
            ctl.seed_window(tr)
            ctls.append(ctl)
        sims = [ClusterSim(n_workers=n, n_nodes=2, seed=40 + j)
                for j, n in enumerate(widths)]
        flush_us, pred_us, loop_us = [], [], []
        for tick in range(ticks):
            srv.prefetch()
            t_pred = 0.0
            for j, h in enumerate(hs):
                t0 = time.perf_counter()
                c = h.predict_cutoff()
                t_pred += time.perf_counter() - t0
                t = sims[j].step()
                h.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
            t0 = time.perf_counter()
            srv.flush()
            t_flush = time.perf_counter() - t0
            t_loop = 0.0
            for j, ctl in enumerate(ctls):
                t = sims[j].step()
                t0 = time.perf_counter()
                c = ctl.predict_cutoff()
                ctl.observe(t, t <= order_stats.iter_time(t, c) + 1e-12)
                t_loop += time.perf_counter() - t0
            if tick >= warm:      # the first ticks capture the graphs
                flush_us.append(t_flush * 1e6)
                pred_us.append(t_pred * 1e6)
                loop_us.append(t_loop * 1e6)
        srv.flush()
        b = next(iter(srv._buckets.values()))
        b.wait()
        graph = b.graphs["observe"]
        per = kernels_per_call(torch, graph.replay)
        loop_graphs = [c.graphs[max(c.graphs, key=lambda k: k[0]
                                    == "censored")] for c in ctls]
        loop_dev = [_graph_device_us(torch, g) for g in loop_graphs]
        loop_per = kernels_per_call(torch, loop_graphs[0].replay)
        rec = {"J": J, "widths": list(widths), "n_pad": b.n_pad,
               "k_samples": K, "lag": lag,
               "device_us_per_replay": _graph_device_us(torch, graph),
               "cuda_kernels_per_replay": sum(v["per_call"]
                                              for v in per.values()),
               "looped_device_us": sum(loop_dev),
               "looped_cuda_kernels": J * sum(v["per_call"]
                                              for v in loop_per.values()),
               "flush_wall_us": float(np.median(flush_us)),
               "predict_fetch_wall_us": float(np.median(pred_us)),
               "flush_plus_predict_wall_us": float(np.median(
                   np.add(flush_us, pred_us))),
               "looped_observe_plus_predict_wall_us": float(np.median(
                   loop_us)),
               "captures": b.captures, "replays": b.replays,
               "dispatches": srv.dispatches}
        emit("ps_timing", case=case, **rec)
        check(b.captures == 2, f"ps_timing {case}: {b.captures} captures")
        out[case] = rec
        del srv, hs, ctls, graph, loop_graphs, b
    torch.cuda.empty_cache()
    return out


def phase_ps(torch):
    """ps_parity and ps_timing, then the memory they leave behind.  Each
    controller and bucket runs on a stream of its own, and cuBLAS keeps
    a workspace for every stream that ran a matmul (~0.8 GB for this
    phase's ~25 streams in a run on the H100), which later phases' peaks
    would otherwise carry: the workspaces are released here."""
    before = torch.cuda.memory_allocated()
    out = {"parity": _ps_parity(torch), "timing": _ps_timing(torch)}
    gc.collect()
    left = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    emit("ps_memory", allocated_before=before, allocated_after=left,
         cublas_workspaces_cleared=clear is not None,
         allocated_after_clearing=torch.cuda.memory_allocated())
    return out


# ---------------------------------------------------------------------------
# The paper's CNN workload (Fig. 4's setting) and the supervised trainer.
# ---------------------------------------------------------------------------

# The card's CNN against the CPU's, of each value's own scale, f32 (TF32
# off).  The two convolve in another summation order, a few ulps apart
# (~1e-6 of a leaf; the same with cuDNN deterministic, benchmarked or
# off: scripts/torch_cnn_grad_leaves.py), and a 2x2 max-pool window
# whose two largest entries lie that close may pick the other entry on
# the card and send its gradient there (one of pool 2's 802,816 windows
# at batch 512, its entries 7.3e-7 apart: 9.1e-5 of c2.w's scale on the
# H100).  So the CPU reference takes the card's pooling choices, each
# flipped window must be such a near-tie (its entries within
# CNN_NEAR_TIE of each other), and the gradient is held to 1e-5, ten
# times the routed readings (1.0-1.2e-6); TF32 convolutions read 6e-3
# to 1e-2 and bf16 autocast 3.4e-2 to 3.8e-2.
CNN_TOL = {"loss": 1e-5, "grad": 1e-5}
CNN_NEAR_TIE = 1e-5   # relative gap of a flipped window's two entries
CNN_WORKERS, CNN_BATCH, CNN_STEPS = 32, 512, 150   # paper_figures.py:126
CNN_FIT_ROWS = CNN_FIT_STEPS = 300
CNN_EVAL_EVERY, CNN_VALID = 10, 2000


def _cnn_pools(torch, C, params, x):
    """The pre-pool activations and argmax indices of the CNN's two
    max-pools, as ``cnn_apply`` computes them."""
    import torch.nn.functional as F

    acts, idx = [], []
    with torch.no_grad():
        h = C._conv(x[:, None], params["c1"])
        for name in ("c2", "c3"):
            acts.append(h)
            h, i = F.max_pool2d(h, 2, return_indices=True)
            idx.append(i)
            h = C._conv(h, params[name])
    return acts, idx


def _cnn_routed_loss(C, params, x, y, weights, idx):
    """``cnn_loss`` with each max-pool taking the argmax ``idx`` given."""
    h = C._conv(x[:, None], params["c1"])
    for i, name in zip(idx, ("c2", "c3")):
        h = h.flatten(2).gather(2, i.flatten(2)).view(i.shape)
        h = C._conv(h, params[name])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return C.cross_entropy(h @ params["fc"]["w"] + params["fc"]["b"], y,
                           weights)


def _cnn_parity(torch):
    """Loss and gradient of the CNN on the card against the CPU: batch
    512, f32, the mean and the cutoff weights of 32 workers (every third
    cut).  The CPU reference routes each max-pool's gradient as the card
    did (CNN_TOL's comment); the windows that flipped are counted."""
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.models import cnn as C

    x, y = SyntheticImages(seed=0, noise=0.9).batch(0, CNN_BATCH)
    bits = (np.arange(CNN_WORKERS) % 3 != 2).astype(np.float32)
    w = np.repeat(bits, CNN_BATCH // CNN_WORKERS)
    p_cpu = C.cnn_init(SEED, device="cpu")
    leaves = {}
    args = {}
    for dev in ("cpu", "cuda"):
        leaves[dev] = {k: {n: t.detach().to(dev).requires_grad_(True)
                           for n, t in p.items()} for k, p in p_cpu.items()}
        args[dev] = [torch.from_numpy(a).to(dev) for a in (x, y, w)]
    acts, idx_cpu = _cnn_pools(torch, C, leaves["cpu"], args["cpu"][0])
    _, idx_card = _cnn_pools(torch, C, leaves["cuda"], args["cuda"][0])
    idx_card = [i.cpu() for i in idx_card]
    flips = []
    for lvl, (h, ic, ig) in enumerate(zip(acts, idx_cpu, idx_card), 1):
        a = h.flatten(2).gather(2, ic.flatten(2))
        b = h.flatten(2).gather(2, ig.flatten(2))
        gap = ((a - b).abs() / a.abs().clamp(min=1e-30))[ic.flatten(2)
                                                          != ig.flatten(2)]
        flips.append({"pool": lvl, "windows": ic.numel(),
                      "flipped": int(gap.numel()),
                      "max_rel_gap": float(gap.max()) if gap.numel() else 0.0})
    check(all(f["max_rel_gap"] <= CNN_NEAR_TIE for f in flips),
          f"cnn: a max-pool window the card decided otherwise is not a "
          f"near-tie: {flips}")

    def loss_grad(dev, kind, idx=None):
        p, (xx, yy, ww) = leaves[dev], args[dev]
        ww = None if kind == "mean" else ww
        loss = (C.cnn_loss(p, xx, yy, ww) if idx is None
                else _cnn_routed_loss(C, p, xx, yy, ww, idx))
        grads = torch.autograd.grad(
            loss, [t for q in p.values() for t in q.values()])
        return loss.detach().cpu(), [g.cpu() for g in grads]

    errs = {}
    for kind in ("mean", "weighted"):
        lg, gg = loss_grad("cuda", kind)
        lc, gc = loss_grad("cpu", kind)
        lr, gr = loss_grad("cpu", kind, idx_card)
        _, gs = loss_grad("cpu", kind, idx_cpu)
        errs[kind] = {"loss_scaled_err": _scaled_err(torch, [lg], [lr]),
                      "grad_scaled_err": _scaled_err(torch, gg, gr),
                      "grad_scaled_err_unrouted": _scaled_err(torch, gg, gc),
                      "routed_equals_port_on_cpu": all(
                          torch.equal(a, b) for a, b in zip(gs, gc)),
                      "loss_cpu": float(lc), "loss_cuda": float(lg)}
        check(errs[kind]["routed_equals_port_on_cpu"],
              f"cnn {kind}: the routed CPU loss is not cnn_loss's")
        check(errs[kind]["loss_scaled_err"] <= CNN_TOL["loss"]
              and errs[kind]["grad_scaled_err"] <= CNN_TOL["grad"],
              f"cnn {kind}: card vs CPU {errs[kind]}")
    emit("cnn_parity", batch=CNN_BATCH, dtype="float32", tol=CNN_TOL,
         near_tie=CNN_NEAR_TIE, pool_flips=flips, **errs)


def _cnn_fig4(torch):
    """The paper's workload at the reference's Fig. 4 setting: full sync,
    the DMM cutoff (k_samples 48, its graph on the card) and the Elfving
    cutoff over ClusterSim(32, 4 nodes, seed 21), batch 512, momentum
    (0.05, 0.9), 150 steps, the validation loss every 10 steps on 2,000
    images.  Reports each controller's curve; who wins is not checked."""
    from repro_torch import optim
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import (CutoffController,
                                             ElfvingController,
                                             FullSyncController)
    from repro_torch.core.runtime_model.api import RuntimeModel
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.launch.cnn import run_cnn_cutoff
    from repro_torch.models.cnn import cnn_init

    n = CNN_WORKERS
    t0 = time.perf_counter()
    trace = ClusterSim(n_workers=n, n_nodes=4, seed=0).run(CNN_FIT_ROWS)
    rm = RuntimeModel(n, lag=20, device="cuda").init(0)
    rm.fit(trace, steps=CNN_FIT_STEPS, batch=8, seed=0)
    fit_s = time.perf_counter() - t0
    data = SyntheticImages(seed=0, noise=0.9)
    out = {}
    for name in ("sync", "cutoff", "order"):
        if name == "sync":
            ctl = FullSyncController(n)
        elif name == "order":
            ctl = ElfvingController(n)
        else:
            ctl = CutoffController(rm, k_samples=48)
            ctl.seed_window(trace[-21:])
        t0 = time.perf_counter()
        run = run_cnn_cutoff(ctl, ClusterSim(n_workers=n, n_nodes=4,
                                             seed=21),
                             data, cnn_init(SEED, device="cuda"),
                             optim.momentum(0.05, 0.9), n_workers=n,
                             steps=CNN_STEPS, batch=CNN_BATCH,
                             eval_every=CNN_EVAL_EVERY, n_valid=CNN_VALID)
        rec = {"controller": name, "curve": run["curve"],
               "final_valid_loss": run["curve"][-1][1],
               "sim_clock_s": run["clock"],
               "step_wall_ms_median": float(np.median(run["step_wall_ms"])),
               "cutoffs_distinct": sorted(set(run["cutoffs"])),
               "mean_cutoff": float(np.mean(run["cutoffs"])),
               "seconds": time.perf_counter() - t0,
               "decision_device_us": None}
        if name == "cutoff":
            check(ctl.replays == CNN_STEPS + 1, f"cnn cutoff: "
                  f"{ctl.replays} graph replays for {CNN_STEPS} steps")
            graph = ctl.graphs[max(ctl.graphs,
                                   key=lambda k: k[0] == "censored")]
            rec["decision_device_us"] = _graph_device_us(torch, graph)
            rec["graph_replays"] = ctl.replays
        check(len(run["curve"]) == CNN_STEPS // CNN_EVAL_EVERY
              and all(np.isfinite(v) for _, v in run["curve"])
              and np.all(np.isfinite(run["losses"])),
              f"cnn {name}: curve {run['curve']}")
        check(all(1 <= c <= n for c in run["cutoffs"]),
              f"cnn {name}: cutoffs out of range")
        emit("cnn_fig4", **rec)
        out[name] = rec
    emit("cnn_fig4_summary", workers=n, batch=CNN_BATCH, steps=CNN_STEPS,
         fit_rows=CNN_FIT_ROWS, fit_steps=CNN_FIT_STEPS, fit_seconds=fit_s,
         final_valid_loss={k: v["final_valid_loss"] for k, v in out.items()},
         sim_clock_s={k: v["sim_clock_s"] for k, v in out.items()})
    return out


def phase_cnn(torch):
    """(a) the CNN's loss and gradient, card against CPU; (b) the Fig. 4
    workload under three controllers on the card."""
    _cnn_parity(torch)
    return _cnn_fig4(torch)


SUP_STEPS, SUP_WORKERS = 36, 6      # tests/test_controlplane.py:366


def phase_supervised(torch):
    """launch.supervised on the card: the seeded storm of default_plan(6)
    over 36 steps (bench_tiny_config at head_dim 64, f32), the report as
    the reference's test asserts it, every launch a flash_attention one
    (2 layers x 36 steps x 2 trainers), the losses against the same run
    on the CPU (PARITY_TOL's loss bar); the host µs of Supervisor.tick;
    then one SIGKILL against ProcWorkerPool subprocess workers."""
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.launch import supervised as S

    n_layers = S.supervised_config().n_layers
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    card = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                            verbose=False)
    card_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    cpu = S.run_supervised(steps=SUP_STEPS, n_workers=SUP_WORKERS,
                           device="cpu", verbose=False)
    cpu_s = time.perf_counter() - t0
    rep = card["report"]
    want = {"flash_attention": 2 * n_layers * SUP_STEPS}
    check(launches == want, f"supervised launched {launches}, want {want}")
    check(card["match"] and rep["n_detected"] == 2
          and rep["max_detection_ticks"] <= 5
          and rep["failed_restarts"] == 1 and rep["evicted"] == []
          and sorted(set(card["widths"])) == [5, 6],
          f"supervised report {rep}, match {card['match']}, widths "
          f"{sorted(set(card['widths']))}")
    check([(h["n"], h["c"], h["clock"]) for h in card["history"]]
          == [(h["n"], h["c"], h["clock"]) for h in cpu["history"]],
          "supervised: widths, cutoffs or clock differ card vs CPU")
    loss_err = max(abs(a["loss"] - b["loss"])
                   for a, b in zip(card["history"], cpu["history"]))
    check(loss_err <= PARITY_TOL["loss"],
          f"supervised: losses differ by {loss_err} card vs CPU")

    _, sup, _ = S.build_supervised(SUP_WORKERS, S.default_plan(SUP_WORKERS))
    tick_us = []
    for t in range(60):
        t1 = time.perf_counter()
        sup.tick(t)
        tick_us.append((time.perf_counter() - t1) * 1e6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drill_") as d:
        t0 = time.perf_counter()
        drill = S.proc_crash_drill(d)
        drill_s = time.perf_counter() - t0
    check(drill["dead_tick"] == drill["crash_tick"] + 5
          and drill["restart_tick"] == drill["dead_tick"] + 2
          and drill["members"] == [0, 1, 2]
          and all(drill["running_at_end"]),
          f"ProcWorkerPool crash drill: {drill['report']}")
    emit("supervised", steps=SUP_STEPS, workers=SUP_WORKERS,
         layers=n_layers, head_dim=S.supervised_config().head_dim,
         match=card["match"], widths=sorted(set(card["widths"])),
         report={k: v for k, v in rep.items() if k != "incidents"},
         incidents=rep["incidents"], launches=launches,
         loss_max_abs_err_vs_cpu=loss_err, loss_tol=PARITY_TOL["loss"],
         final_loss=card["history"][-1]["loss"], seconds_card=card_s,
         seconds_cpu=cpu_s, supervisor_tick_host_us_median=float(
             np.median(tick_us)),
         supervisor_tick_host_us_max=float(np.max(tick_us)))
    emit("supervised_proc_drill", crash_tick=drill["crash_tick"],
         dead_tick=drill["dead_tick"], restart_tick=drill["restart_tick"],
         rejoin_tick=drill["rejoin_tick"],
         detection_ticks=drill["report"]["max_detection_ticks"],
         members=drill["members"], seconds=drill_s)
    return launches


def phase_train_multi_job(torch, cfg):
    """Three full-width qwen2-0.5b jobs (bf16, seq 128, global batch 24,
    psum, fused AdamW) of 6 workers each through launch.multi_job:
    build_multi_job over PartitionedSim(paper_cluster_158(1, 18),
    partition_ids(18, 3)), each job's RuntimeModel(6, lag 10) fitted on the
    card, one PSServer (k_samples 32, refit_async, refit_steps 60,
    refit_fresh 3), round-robin, run_ticks one tick at a time.  A
    ChurnEvent kills job1's workers 6 and 7 at tick 8; the restore is
    appended to the schedule once job1 has decided through its refitted
    width-4 DMM for 2 ticks (and no earlier than tick 18), so a slow refit
    stretches the run instead of failing it; the run ends once job1 has
    decided through its width-6 DMM for 2 ticks (at least 26 ticks).

    Every step asserts the launches at its width (flash L x W,
    masked_grad_agg 1, fused_adam 1), a finite loss and 1 <= c <= n;
    every tick at most 2 launches of the decision, captures only where the
    stack changed.  job1's modes run dmm, fallback, dmm at width 4,
    fallback, dmm at width 6; jobs 0 and 2 stay on the DMM.  At width 4
    the shared step keeps a (4, N) and a (6, N) buffer, and
    masked_grad_agg is timed on job1's own (4, N) one."""
    from repro_torch.cluster.simulator import ChurnEvent
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import reference_masked_agg
    from repro_torch.launch.multi_job import build_multi_job, run_ticks
    from repro_torch.ps import make_scheduler

    L = cfg.n_layers
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    server, jobs, sim = build_multi_job(
        MJ_JOBS, MJ_W, seed=SEED, churn_events=[
            ChurnEvent(step=MJ_KILL, kill=MJ_VICTIMS)],
        global_batch=ELASTIC_BATCH, refit_steps=REFIT_STEPS,
        refit_fresh=REFIT_FRESH, refit_async=True, metrics_every=1,
        device="cuda", cfg=cfg, seq_len=128, mask_agg="psum")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    step_fn = jobs["job0"].trainer.step_fn
    check(all(r.trainer.step_fn is step_fn for r in jobs.values()),
          "the jobs must share one train step")
    emit("train_multi_job_setup", jobs=MJ_JOBS, workers=MJ_W,
         batch=ELASTIC_BATCH, seq=128, seconds=setup_s,
         memory_allocated=torch.cuda.memory_allocated(),
         windows=[int(server.registry[j].count) for j in jobs])

    steps, modes, refits, tick_of = [], {j: [] for j in jobs}, [], [0]
    totals = {}

    def in_flight():
        return any(j.refit_task is not None and j.refit_task[0].is_alive()
                   for j in server.registry.jobs())

    def instrument(job_id, tr):
        run, predict = tr.run, tr.controller.predict_cutoff

        def traced_predict():
            c = predict()
            modes[job_id].append(server.registry[job_id].mode)
            return c

        def timed_run(n_steps, **kw):
            alive0 = in_flight()
            build.LAUNCHES.clear()
            t0 = time.perf_counter()
            hist = run(n_steps, **kw)     # drains the loss: a device sync
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            rec = hist[-1]
            n, c = rec["n"], rec["c"]
            want = {"flash_attention": L * n, "masked_grad_agg": 1,
                    "fused_adam": 1}
            check(launches == want, f"train_multi_job {job_id} step "
                  f"{rec['step']} (n {n}): launches {launches}, want {want}")
            check(bool(np.isfinite(rec["loss"])), f"train_multi_job "
                  f"{job_id} step {rec['step']}: loss {rec['loss']}")
            check(1 <= c <= n, f"train_multi_job {job_id}: c {c} of {n}")
            steps.append({"job": job_id, "tick": tick_of[0], "n": n, "c": c,
                          "mode": modes[job_id][-1], "wall_ms": wall * 1e3,
                          "refit_in_flight": [alive0, in_flight()],
                          "loss": rec["loss"]})
            return hist

        tr.controller.predict_cutoff = traced_predict
        tr.run = timed_run

    for job_id, r in jobs.items():
        instrument(job_id, r.trainer)
    fit_model, install = server._fit_model, server._install_refit

    def timed_fit(job, rows, n, seed):
        r = {"job": job.job_id, "n": n, "seed": seed, "rows": len(rows),
             "spawned": time.perf_counter(), "spawn_tick": tick_of[0]}
        refits.append(r)
        model = fit_model(job, rows, n, seed)
        r["fit_s"] = time.perf_counter() - r["spawned"]
        return model

    def timed_install(job, model):
        install(job, model)
        r = [x for x in refits if x["job"] == job.job_id][-1]
        r["spawn_to_install_s"] = time.perf_counter() - r["spawned"]
        r["install_tick"] = tick_of[0]

    server._fit_model, server._install_refit = timed_fit, timed_install
    bucket = next(iter(server._buckets.values()))
    sched = make_scheduler("rr")
    ticks, restore_at, agg, mem = [], None, None, {}
    tick = 0
    while True:
        check(tick < MJ_TICKS_MAX, f"train_multi_job: job1 not back on its "
              f"width-6 DMM after {MJ_TICKS_MAX} ticks (refits {refits})")
        tick_of[0] = tick
        caps, st = bucket.captures, bucket.st
        t0 = time.perf_counter()
        out = run_ticks(server, jobs, sched, 1)
        wall = time.perf_counter() - t0
        j1 = [s for s in steps if s["job"] == "job1"][-1]
        period = ("w6" if tick < MJ_KILL else "w4"
                  if restore_at is None or tick < restore_at else "w6_again")
        m = mem.setdefault(period, {"max_memory_allocated": 0,
                                    "memory_reserved": 0})
        m["max_memory_allocated"] = max(m["max_memory_allocated"],
                                        torch.cuda.max_memory_allocated())
        m["memory_reserved"] = max(m["memory_reserved"],
                                   torch.cuda.memory_reserved())
        ticks.append({"tick": tick, "wall_ms": wall * 1e3,
                      "dispatches": out["dispatches"],
                      "captures": bucket.captures - caps,
                      "restacked": bucket.st is not st,
                      "job1": [j1["n"], j1["mode"]],
                      "c": [s["c"] for s in steps[-MJ_JOBS:]]})
        emit("train_multi_job", **ticks[-1])
        j1_steps = [s for s in steps if s["job"] == "job1"]
        dmm4 = sum(1 for s in j1_steps if (s["n"], s["mode"]) == (4, "dmm"))
        if (restore_at is None and dmm4 >= MJ_DMM_TICKS
                and tick + 1 >= MJ_RESTORE_MIN):
            # width 4, on its DMM, no fit thread: job1's own (4, N) buffer
            check(not in_flight(), "a refit in flight at the end of width 4")
            widths = sorted(k[0] for k in step_fn.buffers)
            check(widths == [4, MJ_W], f"buffers of widths {widths} at "
                  f"width 4: want one per width in use")
            g = next(v for k, v in step_fn.buffers.items()
                     if k[0] == 4).buf
            mask = _agg_masks(torch, g.shape[0], torch.Generator(
                device="cuda").manual_seed(SEED))["bits"]
            got = ops.masked_aggregate(g, mask)
            want = reference_masked_agg(g, mask.reshape(-1, 1))[0]
            err = (got - want).abs().max().item()
            ex = _allclose_excess(torch, got, want, AGG_TOL["float32"],
                                  AGG_TOL["float32"]).item()
            del got, want
            agg = {"W": g.shape[0], "N": g.shape[1], "max_abs_err": err,
                   "buffers_widths": widths,
                   **_agg_times(torch, torch.cuda.Stream(), g, mask, 5)}
            emit("train_multi_job_masked_grad_agg", **agg)
            check(ex <= AGG_TOL["float32"], f"masked_grad_agg on the "
                  f"(4, N) buffer: off by {ex}")
            del g, mask
            # the timing's own peak (the plain version's temporaries) is
            # not the training's
            torch.cuda.reset_peak_memory_stats()
            restore_at = tick + 1
            sim.events.append(ChurnEvent(step=restore_at,
                                         restore=MJ_VICTIMS))
            check(bool(sim.membership_at(restore_at)[list(MJ_VICTIMS)]
                       .all()), "the restore did not reach the schedule")
        tick += 1
        dmm6 = sum(1 for s in j1_steps if restore_at is not None
                   and s["tick"] >= restore_at
                   and (s["n"], s["mode"]) == (MJ_W, "dmm"))
        if dmm6 >= MJ_DMM_TICKS and tick >= MJ_TICKS_MIN:
            break
    buffers_after = sorted(k[0] for k in step_fn.buffers)

    # the summary, printed before it is checked
    runs = {j: _runs([(s["n"], s["mode"]) for s in steps if s["job"] == j])
            for j in jobs}
    walls = {}
    for n in (MJ_W, 4):
        kept = [s for s in steps if s["n"] == n and s["tick"] > 0]
        busy = [s["wall_ms"] for s in kept if all(s["refit_in_flight"])]
        idle = [s["wall_ms"] for s in kept
                if not any(s["refit_in_flight"])]
        walls[str(n)] = {
            "refit_in_flight": float(np.median(busy)) if busy else None,
            "no_refit": float(np.median(idle)) if idle else None,
            "steps": [len(busy), len(idle)]}
    for r in refits:
        r.pop("spawned")
    tick_walls = [t["wall_ms"] for t in ticks[1:]]
    out = {"ticks": len(ticks), "kill_tick": MJ_KILL,
           "restore_tick": restore_at, "mode_runs": runs,
           "dispatches": sum(t["dispatches"] for t in ticks),
           "dispatches_by_tick": [t["dispatches"] for t in ticks],
           "captures_by_tick": [t["captures"] for t in ticks],
           "captures": bucket.captures, "replays": bucket.replays,
           "tick_wall_ms_median": float(np.median(tick_walls)),
           "step_wall_ms_median_by_width": walls, "refits": refits,
           "memory_by_period": mem,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "buffers_widths_at_end": buffers_after,
           "masked_grad_agg_w4": agg, "launches": totals,
           "setup_seconds": setup_s,
           "seconds": time.perf_counter() - t_phase}
    emit("train_multi_job_summary", **out)
    check(runs["job1"] == [(MJ_W, "dmm"), (4, "fallback"), (4, "dmm"),
                           (MJ_W, "fallback"), (MJ_W, "dmm")],
          f"job1 mode runs {runs['job1']} (refits {refits})")
    for j in ("job0", "job2"):
        check(runs[j] == [(MJ_W, "dmm")], f"{j} mode runs {runs[j]}")
    # one launch a tick; a second in the first tick (its decide-only
    # prefetch), in each resize's tick (resize flushes what is queued) and
    # in each rejoin's tick (the rejoined job's first decision)
    check(all(d <= 2 for d in out["dispatches_by_tick"])
          and out["dispatches"] <= len(ticks) + 5,
          f"decision launches by tick {out['dispatches_by_tick']}")
    # a capture only in the tick the stack changed, or the next one (its
    # first decide-only launch): never in a steady tick
    changed = {0} | {i + d for i, t in enumerate(ticks) if t["restacked"]
                     for d in (0, 1)}
    check(all(t["captures"] == 0 for t in ticks if t["tick"] not in changed),
          f"a steady tick captured: {out['captures_by_tick']}")
    check(len(refits) == 2 and all("spawn_to_install_s" in r
                                    for r in refits), f"refits {refits}")
    check(buffers_after == [MJ_W], f"buffers of widths {buffers_after} "
          f"after the restore: want the width-4 one freed")
    # the instrumented methods close over their trainers: collect the
    # cycles before the next phase
    del server, jobs, sim, step_fn, bucket
    gc.collect()
    torch.cuda.empty_cache()
    return totals, agg


def _mlstm_inputs(torch, B, S, H, hd, dtname, gates, gen):
    """q/k/v in ``dtname`` and f32 log gates, as the mLSTM block makes
    them: g = log_sigmoid(forget logits), i = the input logits."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt = getattr(torch, dtname)
    q, k = (0.5 * randn(B, S, H, hd)).to(dt), (0.5 * randn(B, S, H, hd)).to(dt)
    v = randn(B, S, H, hd).to(dt)
    if gates == "extreme":   # forget logits -10 or +10, input up to 10
        f = torch.where(randn(B, S, H) > 0, 10.0, -10.0)
        i = 20.0 * torch.rand((B, S, H), generator=gen, device="cuda") - 10.0
    else:
        f, i = randn(B, S, H) + 3.0, 0.5 * randn(B, S, H)
    return q, k, v, F.logsigmoid(f), i


def mlstm_ops(B, S, H, hd, chunk, dv=None, init=False, outputs=True):
    """Operations of the chunkwise algorithm at ``chunk``, as (q k^T, the
    rest): per (b, h) and chunk of L positions, q k^T and (W q k^T) v over
    the L(L+1)/2 causal pairs, and the two (L, hd) x (hd, dv) products (q C
    with the entering state, which is zero for the first chunk unless the
    call has an ``init`` state, and the state update).  ``dv`` (None: hd)
    is v's width; ``outputs`` False counts the state update alone."""
    dv = hd if dv is None else dv
    qk = rest = 0
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        if outputs:
            qk += L * (L + 1) * hd
            rest += (L * (L + 1) * dv
                     + 2 * L * hd * dv * (2 if c0 or init else 1))
        else:
            rest += 2 * L * hd * dv
    return B * H * qk, B * H * rest


def mlstm_in_bytes(B, S, H, hd, dtname, dv=None, qk_heads=None):
    """Bytes of one call's inputs, each read once: q/k (``qk_heads`` of
    them in memory, None: H; 1 for Hymba's broadcast), v and the f32
    gates."""
    elt = 2 if dtname == "bfloat16" else 4
    dv = hd if dv is None else dv
    qk_heads = H if qk_heads is None else qk_heads
    return (2 * B * S * qk_heads * hd * elt + B * S * H * dv * elt
            + 2 * B * S * H * 4)


def mlstm_bound(B, S, H, hd, dtname, dv=None, qk_heads=None, init=False,
                outputs=True):
    """The least time the card could take for one call, in ms, with its
    basis: the bytes (q/k/v, the gates and an ``init`` state read once, y
    unless ``outputs`` is False and the final state written once) over
    3.35 TB/s, against the operations (counted in the Pallas kernel's
    chunks) over the tensor cores' rates, 989 TFLOP/s for q k^T with bf16
    operands and 495 (TF32) for the products with an f32 operand; the same
    count over 67 TFLOP/s of f32 FMAs beside it.  ``dv`` and ``qk_heads``
    as ``mlstm_in_bytes`` takes them."""
    dv = hd if dv is None else dv
    state = 4 * B * H * (hd * dv + hd + 2)
    in_bytes = mlstm_in_bytes(B, S, H, hd, dtname, dv, qk_heads)
    if not outputs:   # the state update reads no q
        in_bytes -= (B * S * (H if qk_heads is None else qk_heads) * hd
                     * (2 if dtname == "bfloat16" else 4))
    nbytes = (in_bytes                                            # in
              + (B * S * H * dv * 4 if outputs else 0)            # y
              + state * (2 if init else 1))                       # state
    qk, rest = mlstm_ops(B, S, H, hd, PALLAS_MLSTM_CHUNK, dv, init, outputs)
    qk_rate = PEAK_OPS["bfloat16"] if dtname == "bfloat16" else TF32_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (qk / qk_rate + rest / TF32_OPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "fma_floor_ms": (qk + rest) / PEAK_OPS["float32"] * 1e3,
            "bytes": nbytes, "ops": qk + rest, "ops_qk": qk,
            "chunk": PALLAS_MLSTM_CHUNK}


def _mamba_inputs(torch, B, S, H, dq, dv, dtname, gen):
    """Hymba's Mamba-head inputs as its block makes them: C and B rows
    (B, S, dq) in ``dtname``, shared by every head, v (B, S, H, dv), and
    the f32 gates of dt = softplus(x - 2) (dt_bias -2): g = -dt exp(a_log),
    i = log(dt + 1e-9).  Returns (c, b, v, g, i); ``_heads`` broadcasts
    c/b to q/k."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt = getattr(torch, dtname)
    c, b = (0.5 * randn(B, S, dq)).to(dt), (0.5 * randn(B, S, dq)).to(dt)
    v = randn(B, S, H, dv).to(dt)
    dts = F.softplus(randn(B, S, H) - 2.0)
    g = -dts * torch.exp(0.3 * randn(H))
    return c, b, v, g, torch.log(dts + 1e-9)


def _heads(t, H):
    """(B, S, d) -> a (B, S, H, d) view with head stride 0."""
    return t[:, :, None].expand(-1, -1, H, -1)


def _unnorm_oracle(torch, q, k, v, g, i):
    """The unnormalized recurrence position by position: recurrence_step
    from the identity state, the sequential oracle of Hymba's form."""
    from repro_torch.models.ssm import NEG, ScanState, recurrence_step

    B, S, H, dq = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    st = ScanState(loga=torch.zeros((B, H), **f32),
                   m=torch.full((B, H), NEG, **f32),
                   C=torch.zeros((B, H, dq, v.shape[-1]), **f32),
                   n=torch.zeros((B, H, dq), **f32))
    ys = []
    for t in range(S):
        y, st = recurrence_step(st, q[:, t], k[:, t], v[:, t], g[:, t],
                                i[:, t], **HYMBA_FORM)
        ys.append(y)
    return torch.stack(ys, dim=1)


def phase_mlstm(torch):
    """MLSTM_CASES (the xLSTM's normalized form), then MLSTM_HYMBA_CASES
    (Hymba's unnormalized, unequal-width form with q/k broadcast over the
    heads; its sequential oracle is ``_unnorm_oracle``)."""
    from repro_torch.kernels.flash_attention import aligned16
    from repro_torch.kernels.mlstm_chunk import (PATH_KERNELS, choose_path,
                                                 mlstm_chunk)
    from repro_torch.kernels.mlstm_plain import linear_recurrence
    from repro_torch.kernels.ref import reference_mlstm
    from repro_torch.models.ssm import recurrence_step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    side = torch.cuda.Stream()
    results = {}
    cases = ([(name, B, S, H, hd, hd, dtname, gates, path, {})
              for name, B, S, H, hd, dtname, gates, path in MLSTM_CASES]
             + [(name, B, S, H, dq, dv, dtname, "mamba", path, HYMBA_FORM)
                for name, B, S, H, dq, dv, dtname, path in MLSTM_HYMBA_CASES])
    for name, B, S, H, hd, dv, dtname, gates, want_path, form in cases:
        if form:
            c, b, v, g, i = _mamba_inputs(torch, B, S + 1, H, hd, dv,
                                          dtname, gen)
            q, k = _heads(c, H), _heads(b, H)
        else:
            q, k, v, g, i = _mlstm_inputs(torch, B, S + 1, H, hd, dtname,
                                          gates, gen)
        head = [t[:, :S] for t in (q, k, v, g, i)]
        step = [t[:, S] for t in (q, k, v, g, i)]
        path = choose_path(q.dtype, hd, aligned16(*head[:3]), dv=dv,
                           normalize=form.get("normalize", True))
        check(path == want_path, f"mlstm {name}: takes {path}, not "
              f"{want_path}")
        y, st = mlstm_chunk(*head, **form)
        want, pst = linear_recurrence(*head, **form)
        oracle = (_unnorm_oracle(torch, q, k, v, g, i) if form
                  else reference_mlstm(q, k, v, g, i))
        ys, _ = recurrence_step(st, *step, **form)
        ws, _ = recurrence_step(pst, *step, **form)
        torch.cuda.synchronize()
        check(y.shape == (B, S, H, dv) and y.dtype == torch.float32
              and st.C.shape == (B, H, hd, dv) and st.n.shape == (B, H, hd)
              and st.m.shape == (B, H) and st.loga.shape == (B, H),
              f"mlstm {name}: output {tuple(y.shape)} {y.dtype}, state "
              f"{[tuple(t.shape) for t in st]}")
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(ys).all()),
              f"mlstm {name}: non-finite output")
        errs = {}
        for key, got, exp in (("y", y, want), ("step", ys, ws),
                              ("y_oracle", y, oracle[:, :S]),
                              ("step_oracle", ys, oracle[:, S])):
            ex = _allclose_excess(torch, got, exp, MLSTM_TOL, MLSTM_TOL).item()
            check(ex <= MLSTM_TOL, f"mlstm {name}: {key} off by {ex} beyond "
                  f"rtol > {MLSTM_TOL}")
            errs[key] = (got - exp).abs().max().item()
        loga_err = (st.loga - pst.loga).abs().max().item()
        check(loga_err <= MLSTM_TOL * (1 + pst.loga.abs().max().item()),
              f"mlstm {name}: loga off by {loga_err}")

        def kern():
            return mlstm_chunk(*head, **form)

        # the CUDA kernels a call makes, against what its path launches
        per_call = graph_kernels(torch, kern, side)
        expect = set(PATH_KERNELS[path])
        check(set(per_call) == expect
              and all(n == 1 for n in per_call.values()),
              f"mlstm {name}: a call launched {per_call}, not one each of "
              f"{sorted(expect)}")
        times = {}
        for label, fn in (("ms", kern),
                          ("plain_ms",
                           lambda: linear_recurrence(*head, **form))):
            times[label] = device_ms(torch, fn, side)
            times["eager_" + label] = eager_ms(torch, fn)
        rec = {"case": name, "shape": [B, S, H, hd], "dtype": dtname,
               "gates": gates, "path": path, "max_abs_err": errs["y"],
               "step_max_abs_err": errs["step"],
               "oracle_max_abs_err": errs["y_oracle"],
               "step_oracle_max_abs_err": errs["step_oracle"],
               "y_max_abs": oracle[:, :S].abs().max().item(),
               "tol": MLSTM_TOL, **times, "library_ms": None,
               "library": "none: no single PyTorch call computes it",
               **mlstm_bound(B, S, H, hd, dtname, dv,
                             1 if form else None),
               **({"dv": dv, **form, "qk": "broadcast over H"} if form
                  else {}),
               "cuda_kernels_per_call": sum(per_call.values())}
        results[name] = rec
        emit("mlstm_chunk", **rec)
        del q, k, v, g, i, head, step, y, st, want, pst, oracle
    torch.cuda.empty_cache()
    return results


def init_xlstm(torch):
    from repro_torch.configs.base import get_config

    cfg = get_config("xlstm-350m")
    return cfg, init_weights(torch, cfg)


def phase_serve_xlstm(torch, cfg, params_f32):
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    B, S, n_new = 4, 128, 32
    n_mlstm = sum(s.kind == "mlstm" for s in M.layer_specs(cfg))
    params = cast(params_f32, "cuda", torch.bfloat16)
    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    # the prefill of each mLSTM block, no attention
    rec, launches, prof = graph_decode(
        torch, "serve_xlstm", cfg, engine, prompts, n_new,
        {"mlstm_chunk": n_mlstm})

    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    batch = {"tokens": toks,
             "positions": torch.arange(S, device="cuda").expand(B, S)}
    with torch.inference_mode():
        prefill_ms = eager_ms(torch, lambda: M.prefill(cfg, engine.params,
                                                       batch), reps=3,
                              warmup=1)
    gen_ms = rec["generate_ms"]
    n_params = sum(x.numel() for x in tree.leaves(params))
    emit("serve_xlstm", dtype="bfloat16", params=n_params,
         mlstm_layers=n_mlstm, prefill_ms=prefill_ms,
         decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
         tokens_per_s=B * n_new / (gen_ms / 1e3), **rec)
    emit("serve_xlstm_profile", **prof)
    del engine, params
    torch.cuda.empty_cache()
    return launches


def phase_xlstm_parity(torch, cfg_full, params_f32):
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    n_layers = cfg_full.slstm_every   # one 7 mLSTM + 1 sLSTM period
    cfg = dataclasses.replace(cfg_full, n_layers=n_layers, dtype="float32")
    params = dict(params_f32, layers=params_f32["layers"][:n_layers])
    S, n_new = 64, 8
    prompt = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, size=(1, S), dtype=np.int32)
    seconds = {}
    cpu = ServeEngine(cfg, params, max_len=S + n_new, device="cpu")
    gpu = ServeEngine(cfg, cast(params, "cuda", torch.float32),
                      max_len=S + n_new)
    logits, ids = {}, {}
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=eng.device)
        batch = {"tokens": toks,
                 "positions": torch.arange(S, device=eng.device)[None]}
        with torch.inference_mode():
            logits[name] = M.prefill(cfg, eng.params, batch)[0].float().cpu()
        ids[name] = eng.generate(prompt, n_new)
        check_replays(eng, n_new, name)
        seconds[name] = time.perf_counter() - t0
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    same = bool(np.array_equal(ids["cpu"], ids["cuda"]))
    top2 = torch.topk(logits["cpu"][0], 2).values
    emit("serve_xlstm_parity", dtype="float32", layers=n_layers, prompt=S,
         n_new=n_new, logits_max_abs_err=err, tol=PARITY_LOGIT_ATOL,
         logits_max_abs=logits["cpu"].abs().max().item(), ids_equal=same,
         ids_cpu=ids["cpu"][0].tolist(), ids_cuda=ids["cuda"][0].tolist(),
         first_logit_gap=(top2[0] - top2[1]).item(), seconds=seconds)
    check(err <= PARITY_LOGIT_ATOL,
          f"xlstm prefill logits differ by {err} > {PARITY_LOGIT_ATOL}")
    check(same, "xlstm greedy ids differ between the CPU and the card")
    del gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# xLSTM training on the card (mlstm_chunk through its autograd Function)
# and the MoE family (deepseek-moe-16b): served at full depth, trained at
# depth 2 under the DMM cutoff.
# ---------------------------------------------------------------------------

# (name, B, S, H, dq, dv, normalize): train_xlstm's per-worker shape and a
# multi-chunk S; train_hymba's per-worker shape in the Mamba heads' form
MLSTM_GRAD_CASES = [("train_b2_s128", 2, 128, 4, 512, 512, True),
                    ("s300", 2, 300, 4, 512, 512, True),
                    ("hymba_b2_s128", 2, 128, 25, 16, 128, False)]
MLSTM_GRAD_HEADLINE = "train_b2_s128"
# the Function's gradients are the plain recurrence's own on the same
# inputs (its backward recomputes it in f32), each rounded once to its
# input's dtype: held to 1e-6 of their scale against autograd of the plain
# path on f32 copies of the inputs, rounded the same way; y to the
# forward's MLSTM_TOL
MLSTM_GRAD_TOL = 1e-6
# Hymba's C and B rows get the sum over the 25 heads of the Function's
# per-head q/k gradients (the broadcast's backward, in bf16): held to one
# bf16 rounding of that sum against the per-head gradients of the plain
# path rounded the same way (those per-head gradients at MLSTM_GRAD_TOL)
HEAD_SUM_TOL = 4e-3
# train_moe_parity: the first step's gradient (identical params on both
# devices) at train_parity's 1e-4; the second step's, and m which mixes
# the two, at 5e-4.  Adam's first update moves every entry whose gradient
# sits at rounding noise by lr times a sign the devices may disagree on,
# so the second gradient is taken at params up to 2 lr apart.  With the
# weights drawn on the host, layer 0's dense w_up (2048 x 10944) read
# 1.84e-4 of its scale there against 3.9e-6 at the first step; drawn on
# the card as now, 7.7e-5 against 3.6e-6 (PERF.md §6;
# scripts/torch_moe_grad_leaves.py: one step's loss gradient ~4e-6 apart,
# the CPU against itself in another summation order ~3e-6)
MOE_PARITY_TOL = dict(PARITY_TOL, grad_later=5e-4, m=5e-4)
XLSTM_STEPS = 3
MOE_STEPS = 4
MOE_REPLAY = 2


def _dmm_controller(rm):
    """train_dmm's controller on its fitted model: CutoffController(rm,
    k_samples=48) seeded with the trace the model was fitted on."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController

    ctl = CutoffController(rm, k_samples=48)
    ctl.seed_window(ClusterSim(n_workers=8, n_nodes=2, seed=0).run(200))
    return ctl


def mlstm_bwd_bound(B, S, H, hd, dtname, dv=None, qk_heads=None):
    """The least time of the mLSTM's backward (dy -> dq, dk, dv, dg, di),
    in ms, with its basis: q/k/v, the gates and dy read once, the five
    gradients written once, over 3.35 TB/s, against twice the forward's
    operations (each product's gradient is two products of its size) at
    the forward's rates; the f32-FMA floor of the same count beside it.
    The plain backward the Function runs also recomputes the forward (one
    more forward's operations), which the bound leaves out.  ``dv`` and
    ``qk_heads`` as ``mlstm_in_bytes`` takes them."""
    dv = hd if dv is None else dv
    nbytes = (2 * mlstm_in_bytes(B, S, H, hd, dtname, dv, qk_heads)
              + B * S * H * dv * 4)
    qk, rest = mlstm_ops(B, S, H, hd, PALLAS_MLSTM_CHUNK, dv)
    qk_rate = PEAK_OPS["bfloat16"] if dtname == "bfloat16" else TF32_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (qk / qk_rate + rest / TF32_OPS) * 1e3
    return {"bwd_bound_ms": max(t_bytes, t_ops),
            "bwd_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bwd_fma_floor_ms": 2 * (qk + rest) / PEAK_OPS["float32"] * 1e3,
            "bwd_bytes": nbytes, "bwd_ops": 2 * (qk + rest)}


def phase_mlstm_grad(torch):
    """MLSTMChunk (the kernel forward, the plain recurrence's backward) on
    the card against autograd of the plain path on the card, bf16 q/k/v
    and f32 gates: y and the gradients of q, k, v, g, i; the forward's
    device ms (graph replay) and the backward's (the profiler's kernel
    time of one plain recompute-and-differentiate, what the Function's
    backward runs) beside the backward's bound.  Hymba's case feeds q/k as
    views of its C and B rows broadcast over the heads, in the
    unnormalized form: the per-head q/k gradients are held like the
    others, and the rows' gradients (their head sum) at HEAD_SUM_TOL."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk import MLSTMChunk, mlstm_chunk
    from repro_torch.kernels.mlstm_plain import linear_recurrence

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    side = torch.cuda.Stream()
    results = {}
    for name, B, S, H, hd, dv, norm in MLSTM_GRAD_CASES:
        form = {} if norm else HYMBA_FORM
        if norm:
            xs = _mlstm_inputs(torch, B, S, H, hd, "bfloat16", "normal", gen)
        else:
            xs = _mamba_inputs(torch, B, S, H, hd, dv, "bfloat16", gen)
        r = torch.randn((B, S, H, dv), generator=gen, device="cuda")
        leaves = [t.detach().requires_grad_(True) for t in xs]
        # what the Function sees: q/k themselves, or the rows' broadcast
        args = leaves if norm else [_heads(leaves[0], H),
                                    _heads(leaves[1], H), *leaves[2:]]
        build.LAUNCHES.clear()
        y, *_ = MLSTMChunk.apply(*args, *form.values())
        rows = [] if norm else leaves[:2]   # C and B rows of the heads
        got = torch.autograd.grad((y * r).sum(), args + rows)
        got, rows = got[:5], got[5:]
        check(build.LAUNCHES["mlstm_chunk"] == 1,
              f"mlstm_grad {name}: {dict(build.LAUNCHES)} launches")
        # the plain path on f32 copies of the same inputs (q/k per head):
        # its gradients rounded once to each input's dtype are what the
        # Function returns
        plain = [t.detach().float().contiguous().requires_grad_(True)
                 for t in args]
        yp, _ = linear_recurrence(*plain, **form)
        want = torch.autograd.grad((yp * r).sum(), plain)
        torch.cuda.synchronize()
        y_ex = _allclose_excess(torch, y, yp, MLSTM_TOL, MLSTM_TOL).item()
        check(y_ex <= MLSTM_TOL, f"mlstm_grad {name}: y off by {y_ex}")
        errs = {}
        for key, a, b, x in zip("qkvgi", got, want, args):
            check(a.dtype == x.dtype, f"mlstm_grad {name}: d{key} is "
                  f"{a.dtype}, its input {x.dtype}")
            check(bool(torch.isfinite(a).all()),
                  f"mlstm_grad {name}: d{key} not finite")
            errs[key] = _scaled_err(torch, [a.float()],
                                    [b.to(a.dtype).float()])
            check(errs[key] <= MLSTM_GRAD_TOL, f"mlstm_grad {name}: d{key} "
                  f"off by {errs[key]} of its scale")
        if not norm:   # the broadcast's backward: each row's head sum
            for key, a, b in zip(("c", "b"), rows, want[:2]):
                errs[key] = _scaled_err(torch, [a.float()], [
                    b.to(a.dtype).sum(dim=2).float()])
                check(errs[key] <= HEAD_SUM_TOL, f"mlstm_grad {name}: "
                      f"d{key} off by {errs[key]} of its scale")
        fwd_args = [t.detach() for t in args]

        def bwd():
            with torch.enable_grad():
                ls = [t.detach().requires_grad_(True) for t in fwd_args]
                out, _ = linear_recurrence(*(t.float() for t in ls), **form)
                return torch.autograd.grad(out, ls, r)

        qk_heads = None if norm else 1
        fwd_ms = device_ms(torch, lambda: mlstm_chunk(*fwd_args, **form),
                           side)
        bwd_eager = eager_ms(torch, bwd, reps=5, warmup=2)
        prof = device_profile(torch, bwd, n_top=5)
        rec = {"case": name, "shape": [B, S, H, hd], "dv": dv,
               "dtype": "bfloat16", "normalize": norm,
               "y_max_abs_err": (y - yp).abs().max().item(),
               "grad_scaled_err": errs,
               "tol": {"y": MLSTM_TOL, "grad": MLSTM_GRAD_TOL,
                       **({} if norm else {"rows": HEAD_SUM_TOL})},
               "fwd_ms": fwd_ms, "bwd_ms": prof["device_ms"],
               "bwd_eager_ms": bwd_eager,
               "bwd_device_events": prof["device_events"],
               "bwd_top": prof["top"],
               **mlstm_bound(B, S, H, hd, "bfloat16", dv, qk_heads),
               **mlstm_bwd_bound(B, S, H, hd, "bfloat16", dv, qk_heads)}
        results[name] = rec
        emit("mlstm_grad", **rec)
        del xs, r, leaves, args, y, got, rows, plain, yp, want, fwd_args
    torch.cuda.empty_cache()
    return results


def phase_train_xlstm(torch, cfg, params_f32, rm):
    """Full-width xlstm-350m (bf16; the script cuts its depth to
    CUT_DEPTH["train_xlstm"]) trained under train_dmm's DMM controller over
    ClusterSim(8, 2 nodes, seed 7): seq 128 x batch 16, W 8, fused AdamW,
    SP_SSM_PSUM_STEPS psum steps, then one step of the weights path from
    the same state (XLSTM_STEPS in all).  A psum step asserts n_mlstm x 8
    mlstm_chunk launches (every mLSTM block of every worker, forward
    through MLSTMChunk), one masked_grad_agg, one fused_adam, no flash
    launch, a finite loss; the weights step n_mlstm and one fused_adam.
    Returns the launches and the parameters (CPU copies) after the psum
    steps and after the weights step, which train_sp_xlstm must give."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import model as M

    W, S, B = 8, 128, 16
    n_mlstm = sum(s.kind == "mlstm" for s in M.layer_specs(cfg))
    params = cast(params_f32, "cuda", torch.bfloat16)
    tr, opt = _train_setup(torch, cfg, params, n_workers=W, seq=S, batch=B,
                           controller=_dmm_controller(rm),
                           timer=ClusterSim(n_workers=W, n_nodes=2, seed=7))
    want = {"mlstm_chunk": n_mlstm * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals, walls, ref = {}, [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(XLSTM_STEPS):
        agg = "psum" if i < SP_SSM_PSUM_STEPS else "weights"
        if i == SP_SSM_PSUM_STEPS:
            tr.step_fn = make_train_step(cfg, opt, mask_agg="weights")
            tr.mask_agg = "weights"
            want = {"mlstm_chunk": n_mlstm, "fused_adam": 1}
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        check(launches == want, f"train_xlstm step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"train_xlstm step {rec['step']}: loss {rec['loss']}")
        if agg == "psum":
            walls.append(wall * 1e3)
        if i + 1 >= SP_SSM_PSUM_STEPS:
            ref[agg] = _cpu_copy(torch, tr.state["params"])
        emit("train_xlstm", arch=cfg.name, dtype="bfloat16", step=rec["step"],
             mask_agg=agg, wall_ms=wall * 1e3, tokens_per_s=B * S / wall,
             c=rec["c"], n=rec["n"], loss=rec["loss"], clock=rec["clock"],
             launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    n_params = sum(x.numel() for x in tree.leaves(params))
    emit("train_xlstm_summary", params=n_params, layers=cfg.n_layers,
         mlstm_layers=n_mlstm, workers=W, seq=S, batch=B,
         median_wall_ms=float(np.median(walls[1:])), launches=totals,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del tr, opt, params
    gc.collect()
    torch.cuda.empty_cache()
    return totals, ref


def phase_train_xlstm_parity(torch, cfg_full):
    """xlstm-350m at full width, depth 2 with the sLSTM kept (one mLSTM
    and one sLSTM block), f32, W 4, seq 32 x batch 8: the psum step's 2
    steps on the CPU against the card, train_parity's comparisons."""
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg_full, n_layers=2, slstm_every=2,
                              dtype="float32")
    p_cpu = M.init_model(cfg, torch.Generator().manual_seed(SEED + 9),
                         device="cpu", dtype=torch.float32)
    rec, _ = _train_parity(torch, cfg, p_cpu, W=4, S=32, B=8, n_steps=2,
                           cutoff=3)
    emit("train_xlstm_parity", arch=cfg.name,
         kinds=[s.kind for s in M.layer_specs(cfg)], **rec)
    _check_train_parity(rec, "train_xlstm_parity")


class _DropCount:
    """Counts the routed slots the MoE dispatch keeps and drops while it is
    installed (``moe.dispatch_plan`` wrapped; the counts stay on the device
    until read)."""

    def __init__(self, moe):
        self.moe, self.inner, self.kept, self.total = moe, None, [], 0

    def __enter__(self):
        self.inner = self.moe.dispatch_plan

        def counted(topk_i, n_experts, capacity):
            plan = self.inner(topk_i, n_experts, capacity)
            self.kept.append((plan.dst < n_experts * capacity).sum())
            self.total += plan.dst.numel()
            return plan

        self.moe.dispatch_plan = counted
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_plan = self.inner

    def share(self, torch):
        kept = int(torch.stack(self.kept).sum()) if self.kept else 0
        return {"routed_slots": self.total,
                "dropped": self.total - kept,
                "dropped_share": (self.total - kept) / max(self.total, 1)}


def init_on_card(torch, cfg, dtype, seed):
    """A model's weights drawn on the card by a CUDA generator, one weight
    at a time: deepseek-moe-16b in f32 would need 65 GB of host memory,
    and the host's draw of hymba-1.5b's 1.6e9 normals would take seconds
    of its phase."""
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return M.init_model(cfg, gen, device="cuda", dtype=dtype)


def phase_serve_moe(torch, cfg):
    """Full-depth deepseek-moe-16b (28 layers, bf16, weights drawn on the
    card) through ServeEngine.generate: 4 prompts x 128 tokens, 32 greedy
    new tokens; asserts 28 x 33 flash launches and ids in range; prefill
    ms, ms per token, tokens/s, peak memory, and the share of routed slots
    dropped at capacity in a prefill; then the device's busy share of a
    short request."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServeEngine

    B, S, n_new = 4, 128, 32
    t0 = time.perf_counter()
    params = init_on_card(torch, cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.leaves(params))
    check(n_params == cfg.n_params(), f"deepseek-moe-16b: {n_params} "
          f"parameters, want {cfg.n_params()}")
    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(SEED + 10).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    rec, launches, prof = graph_decode(
        torch, "serve_moe", cfg, engine, prompts, n_new,
        {"flash_attention": cfg.n_layers})

    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    batch = {"tokens": toks,
             "positions": torch.arange(S, device="cuda").expand(B, S)}
    with torch.inference_mode():
        prefill_ms = eager_ms(torch, lambda: M.prefill(cfg, engine.params,
                                                       batch), reps=3,
                              warmup=1)
        with _DropCount(moe) as drops:
            M.prefill(cfg, engine.params, batch)
    gen_ms = rec["generate_ms"]
    emit("serve_moe", dtype="bfloat16", params=n_params, init_s=init_s,
         prefill_ms=prefill_ms,
         decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
         tokens_per_s=B * n_new / (gen_ms / 1e3),
         capacity_prefill=moe.capacity_for(cfg, B * S),
         capacity_decode=moe.capacity_for(cfg, B),
         prefill_drops=drops.share(torch), **rec)
    emit("serve_moe_profile", **prof)
    del engine, params, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_moe_parity(torch, cfg_full):
    """deepseek-moe-16b at full width and depth 2 (the dense first layer
    and one MoE layer), f32: prefill logits within PARITY_LOGIT_ATOL and
    equal greedy ids, the CPU (plain path) against the card (kernels)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    params = cast(init_on_card(torch, cfg, torch.float32, SEED + 11), "cpu",
                  torch.float32)
    torch.cuda.empty_cache()
    S, n_new = 64, 8
    prompt = np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab_size, size=(1, S), dtype=np.int32)
    seconds, logits, ids = {}, {}, {}
    cpu = ServeEngine(cfg, params, max_len=S + n_new, device="cpu")
    gpu = ServeEngine(cfg, cast(params, "cuda", torch.float32),
                      max_len=S + n_new)
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=eng.device)
        batch = {"tokens": toks,
                 "positions": torch.arange(S, device=eng.device)[None]}
        with torch.inference_mode():
            logits[name] = M.prefill(cfg, eng.params, batch)[0].float().cpu()
        ids[name] = eng.generate(prompt, n_new)
        check_replays(eng, n_new, name)
        seconds[name] = time.perf_counter() - t0
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    same = bool(np.array_equal(ids["cpu"], ids["cuda"]))
    top2 = torch.topk(logits["cpu"][0], 2).values
    emit("serve_moe_parity", arch=cfg.name, dtype="float32",
         layers=cfg.n_layers, prompt=S, n_new=n_new,
         logits_max_abs_err=err, tol=PARITY_LOGIT_ATOL,
         logits_max_abs=logits["cpu"].abs().max().item(), ids_equal=same,
         ids_cpu=ids["cpu"][0].tolist(), ids_cuda=ids["cuda"][0].tolist(),
         first_logit_gap=(top2[0] - top2[1]).item(), seconds=seconds,
         host_rss=_host_rss())
    check(err <= PARITY_LOGIT_ATOL,
          f"moe prefill logits differ by {err} > {PARITY_LOGIT_ATOL}")
    check(same, "moe greedy ids differ between the CPU and the card")
    del gpu, cpu, params
    gc.collect()
    torch.cuda.empty_cache()


def _trainer_kernel_times(torch, buf, state, label):
    """masked_grad_agg on a trainer's own (W, N) buffer and fused_adam
    over its leaves (bf16 p, random bf16 g, its f32 m and v), at that
    trainer's N: kernel, plain and library device ms beside the bounds,
    emitted as ``{label}_masked_grad_agg`` and ``{label}_fused_adam``.
    The plain masked mean runs over column blocks of 2^27 (one call over
    the whole buffer would need a second (W, N) f32 temporary)."""
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import LeafTable, fused_adam_
    from repro_torch.kernels.masked_grad_agg import masked_grad_agg
    from repro_torch.kernels.ref import reference_adam, reference_masked_agg

    side = torch.cuda.Stream()
    W, N = buf.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mask = _agg_masks(torch, W, gen)["bits"]
    cols = 1 << 27
    blocks = [(a, min(a + cols, N)) for a in range(0, N, cols)]
    got = masked_grad_agg(buf, mask)
    err = max((got[a:b] - reference_masked_agg(
        buf[:, a:b], mask.reshape(-1, 1))[0]).abs().max().item()
        for a, b in blocks)
    del got
    check(err <= AGG_TOL["float32"], f"masked_grad_agg on {label}'s "
          f"({W}, N) buffer: off by {err}")
    m2 = mask.reshape(1, W)
    c = torch.clamp(mask.sum(), min=1.0)
    agg = {"W": W, "N": N, "max_abs_err": err,
           "ms": device_ms(torch, lambda: masked_grad_agg(buf, mask), side,
                           reps=5),
           "plain_ms": device_ms(torch, lambda: [reference_masked_agg(
               buf[:, a:b], mask.reshape(-1, 1)) for a, b in blocks], side,
               reps=2),
           "library_ms": device_ms(torch, lambda: (m2 @ buf) / c, side,
                                   reps=5)}
    nbytes = W * N * 4 + N * 4 + 4 * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * W * N / PEAK_OPS["float32"] * 1e3
    agg.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, plain_blocks=len(blocks))
    emit(f"{label}_masked_grad_agg", **agg)

    ps = tree.leaves(state["params"])
    ms, vs = tree.leaves(state["opt"]["m"]), tree.leaves(state["opt"]["v"])
    gs = [(torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
           ).to(p.dtype) for p in ps]
    scal = ops.adam_scalars(10, 3e-4, 0.9, 0.999)
    table = LeafTable()
    n_params = sum(p.numel() for p in ps)
    adam = {"leaves": len(ps), "params": n_params,
            "ms": device_ms(torch, lambda: fused_adam_(
                ps, gs, ms, vs, scal, wd=0.01, table=table), side, reps=5),
            "plain_ms": device_ms(torch, lambda: [
                reference_adam(p, g, m, v, scal, wd=0.01)
                for p, g, m, v in zip(ps, gs, ms, vs)], side, reps=2)}
    lib_params = [p.detach().clone() for p in ps]
    for lp, g in zip(lib_params, gs):
        lp.grad = g
    lib = torch.optim.AdamW(lib_params, lr=3e-4, weight_decay=0.01,
                            fused=True, capturable=True)
    adam["library_ms"] = device_ms(torch, lib.step, side, reps=5)
    adam["library"] = ("torch.optim.AdamW(fused=True, capturable=True), "
                       "bf16 params, grads and moments")
    pe = ps[0].element_size()
    nbytes = n_params * (2 * pe + pe + 2 * 4 * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * n_params / PEAK_OPS["float32"] * 1e3
    adam.update(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)
    emit(f"{label}_fused_adam", **adam)
    del gs, lib_params, lib, table
    return agg, adam


def phase_train_moe(torch, cfg_full, rm):
    """deepseek-moe-16b at full width and depth 2 (layer 0 dense, layer 1
    MoE; bf16, weights drawn on the card) trained by the psum step under
    train_dmm's DMM controller over ClusterSim(8, 2 nodes, seed 7): seq
    128 x batch 16, W 8, fused AdamW.  A first run of MOE_REPLAY steps
    (the dropped share counted), then a second run from the same state,
    controller, timer and data that must give the same losses and
    parameters bit for bit over those steps (the dispatch writes no
    buffer by a scatter-add) and goes on to MOE_STEPS steps, each
    asserting its launches (flash 2 x 8, masked_grad_agg 1, fused_adam 1),
    a finite loss and aux.  The two runs share one step function: one
    (8, N) buffer.  Then the kernels at this N on the trainer's own
    buffer and state."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import moe
    from repro_torch.optim import adamw, cosine_schedule

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    W, S, B = 8, 128, 16
    t0 = time.perf_counter()
    p0 = cast(init_on_card(torch, cfg, torch.bfloat16, SEED + 13), "cpu",
              torch.bfloat16)
    n_params = sum(x.numel() for x in tree.leaves(p0))
    check(n_params == cfg.n_params(), f"depth-2 deepseek-moe-16b: "
          f"{n_params} parameters, want {cfg.n_params()}")
    opt = adamw(cosine_schedule(3e-4, 2, 20), fused=True)
    step_fn = make_train_step(cfg, opt, mask_agg="psum")
    setup_s = time.perf_counter() - t0

    def trainer(mets):
        return _train_setup(
            torch, cfg, cast(p0, "cuda", torch.bfloat16), n_workers=W,
            seq=S, batch=B, controller=_dmm_controller(rm),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7),
            metrics_out=mets, opt=opt, step_fn=step_fn)[0]

    # run 1: the replayed steps, with the dropped slots counted
    mets1 = []
    tr = trainer(mets1)
    with _DropCount(moe) as drops:
        hist1 = [dict(h) for h in tr.run(MOE_REPLAY)]
    after1 = _cpu_copy(torch, tr.state["params"])
    drop_share = drops.share(torch)
    aux1 = [float(m["aux"]) for m in mets1]
    del tr
    gc.collect()

    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    mets = []
    tr = trainer(mets)
    totals, walls, steps = {}, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(MOE_STEPS):
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        aux = float(mets[-1]["aux"])
        check(launches == want, f"train_moe step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])) and np.isfinite(aux)
              and aux > 0.0, f"train_moe step {rec['step']}: loss "
              f"{rec['loss']}, aux {aux}")
        if i + 1 == MOE_REPLAY:
            replay = {
                "losses_equal": [h["loss"] for h in hist1]
                == [h["loss"] for h in tr.history],
                "cutoffs_equal": [h["c"] for h in hist1]
                == [h["c"] for h in tr.history],
                "aux_equal": aux1 == [float(m["aux"]) for m in mets],
                "params_equal": _bit_equal(
                    torch, after1, _cpu_copy(torch, tr.state["params"]))}
            check(all(replay.values()), f"train_moe: the replay of "
                  f"{MOE_REPLAY} steps differs: {replay}")
            del after1
        walls.append(wall * 1e3)
        steps.append({"step": rec["step"], "c": rec["c"], "n": rec["n"],
                      "loss": rec["loss"], "aux": aux,
                      "clock": rec["clock"], "wall_ms": wall * 1e3})
        emit("train_moe", arch=cfg.name, dtype="bfloat16", **steps[-1],
             tokens_per_s=B * S / wall, launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    # the device's busy share of one more step
    wall = []

    def one_step():
        t0 = time.perf_counter()
        tr.run(1)
        wall.append((time.perf_counter() - t0) * 1e3)

    prof = device_profile(torch, one_step)
    emit("train_moe_profile", wall_ms=wall[0],
         device_busy_share=prof["device_ms"] / wall[0], **prof)
    check(len(step_fn.buffers) == 1, f"train_moe: {len(step_fn.buffers)} "
          f"worker buffers, want the one (8, N)")
    buf = next(iter(step_fn.buffers.values())).buf
    agg, adam = _trainer_kernel_times(torch, buf, tr.state, "train_moe")
    emit("train_moe_summary", params=n_params, layers=cfg.n_layers,
         workers=W, seq=S, batch=B, setup_s=setup_s,
         median_wall_ms=float(np.median(walls[1:])), launches=totals,
         max_memory_allocated=peak, replay=replay,
         replay_losses=[h["loss"] for h in hist1], replay_aux=aux1,
         capacity=moe.capacity_for(cfg, (B // W) * S),
         dropped=drop_share)
    del tr, buf, step_fn, opt, p0
    gc.collect()
    torch.cuda.empty_cache()
    return totals, agg, adam


def phase_train_moe_parity(torch, cfg_full):
    """deepseek-moe-16b at full width and depth 2, f32, W 2 (one worker
    dropped), seq 32 x batch 4, fused AdamW, 2 steps: the card against the
    CPU, train_parity's comparisons at MOE_PARITY_TOL and the aux of every
    step; the host's resident bytes (the CPU run holds the model's f32
    state and gradients: ~46 GB at its peak)."""
    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    # drawn on the card, then copied: the CPU's draw of 1.09e9 normals
    # would take seconds of the phase
    p_cpu = cast(init_on_card(torch, cfg, torch.float32, SEED + 14), "cpu",
                 torch.float32)
    torch.cuda.empty_cache()
    rec, aux = _train_parity(torch, cfg, p_cpu, W=2, S=32, B=4, n_steps=2,
                             cutoff=1)
    aux_err = max(abs(a - b) for a, b in zip(aux["cpu"], aux["cuda"]))
    rec["tol"] = MOE_PARITY_TOL
    emit("train_moe_parity", arch=cfg.name, aux_cpu=aux["cpu"],
         aux_cuda=aux["cuda"], aux_max_abs_err=aux_err,
         host_rss=_host_rss(), **rec)
    _check_train_parity(rec, "train_moe_parity", MOE_PARITY_TOL)
    check(aux_err <= MOE_PARITY_TOL["loss"], f"train_moe_parity: aux "
          f"differs by {aux_err}")


# ---------------------------------------------------------------------------
# Hymba (hymba-1.5b): attention and Mamba heads in parallel in every layer,
# served at full depth with a prompt past the 1024-token window, trained
# at depth 4 under the DMM cutoff.
# ---------------------------------------------------------------------------

# the reference's own tree (jax.eval_shape of repro.models.model.init_model):
# ArchConfig.n_params() leaves out the Mamba sublayer (ROADMAP, known gaps)
HYMBA_PARAMS = 1_642_503_200
# layer 0 global, the rest windowed (the 1024-token window is wider than
# the training rows: no mask differs); the (8, N) buffer at full depth is
# 52.6 GB; depth 24 took 47-63 s of the script, 16 paid for train_dp
# (31.6 s of a 795.8 s run on an H100 80GB HBM3 at 700 W), 4 pays for
# train_zero3 (20.5 s of that run)
HYMBA_TRAIN_DEPTH = 4
HYMBA_TRAIN_PARAMS = 294_917_100
HYMBA_STEPS = 3
# the first run's steps, also train_sp_hymba's psum steps
HYMBA_REPLAY = SP_SSM_PSUM_STEPS
# depth 2 in f32: the CPU and the card sum in other orders; the xLSTM's
# and MoE's parity runs (24 and 8 layers) hold 1e-3
HYMBA_PARITY_LOGIT_ATOL = 1e-4
# train_hymba_parity: MOE_PARITY_TOL's bars, for its reason.  The first
# step's gradient (identical params) at 1e-4; the second's, and m which
# mixes it in, at 5e-4: after Adam's first step the params differ by up
# to 2 lr where |g| sits at noise.  scripts/torch_hymba_step2_grad.py
# (PERF.md §6): the second gradients 1.13e-4 of their scale apart (layer
# 0's mlp w_gate), the CPU's at the card's step-1 params 3.1e-6 from the
# card's, and 1.12e-4 from the CPU's own: the params' divergence alone
HYMBA_PARITY_TOL = dict(PARITY_TOL, grad_later=5e-4, m=5e-4)


def phase_serve_hymba(torch, cfg):
    """Full-depth hymba-1.5b (32 layers, bf16, weights drawn on the card)
    through ServeEngine.generate: 4 prompts x 1280 tokens (the 29 windowed
    layers' 1024-token window binds), 32 greedy new tokens; asserts 32 x
    33 flash launches, 32 mlstm_chunk launches (each layer's Mamba
    prefill) and ids in range; prefill ms, ms per token, tokens/s, peak
    memory; then the device's busy share of a short request."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    B, S, n_new = 4, 1280, 32
    windows = [s.window for s in M.layer_specs(cfg)]
    check(S > cfg.sliding_window and windows.count(0) == 3,
          f"hymba serve: prompt {S}, windows {windows}")
    t0 = time.perf_counter()
    params = init_on_card(torch, cfg, torch.bfloat16, SEED + 15)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.leaves(params))
    check(n_params == HYMBA_PARAMS, f"hymba-1.5b: {n_params} parameters, "
          f"want {HYMBA_PARAMS}")
    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(SEED + 16).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    rec, launches, prof = graph_decode(
        torch, "serve_hymba", cfg, engine, prompts, n_new,
        {"flash_attention": cfg.n_layers, "mlstm_chunk": cfg.n_layers})

    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    batch = {"tokens": toks,
             "positions": torch.arange(S, device="cuda").expand(B, S)}
    with torch.inference_mode():
        prefill_ms = eager_ms(torch, lambda: M.prefill(cfg, engine.params,
                                                       batch), reps=3,
                              warmup=1)
    gen_ms = rec["generate_ms"]
    emit("serve_hymba", dtype="bfloat16", params=n_params,
         windowed_layers=cfg.n_layers - windows.count(0),
         window=cfg.sliding_window, init_s=init_s, prefill_ms=prefill_ms,
         decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
         tokens_per_s=B * n_new / (gen_ms / 1e3), **rec)
    emit("serve_hymba_profile", **prof)
    del engine, params, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_hymba_parity(torch, cfg_full):
    """hymba-1.5b at full width and depth 2 (layer 0 global, layer 1
    windowed), f32, 2 prompts of 1100 tokens (past the window), 8 greedy
    new tokens: prefill logits within HYMBA_PARITY_LOGIT_ATOL and equal
    ids, the CPU (plain path) against the card (kernels)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    windows = [s.window for s in M.layer_specs(cfg)]
    B, S, n_new = 2, 1100, 8
    check(windows == [0, cfg.sliding_window] and S > cfg.sliding_window,
          f"hymba parity: windows {windows}, prompt {S}")
    params = cast(init_on_card(torch, cfg, torch.float32, SEED + 17), "cpu",
                  torch.float32)
    torch.cuda.empty_cache()
    prompt = np.random.default_rng(SEED + 18).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    seconds, logits, ids = {}, {}, {}
    cpu = ServeEngine(cfg, params, max_len=S + n_new, device="cpu")
    gpu = ServeEngine(cfg, cast(params, "cuda", torch.float32),
                      max_len=S + n_new)
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=eng.device)
        batch = {"tokens": toks,
                 "positions": torch.arange(S, device=eng.device).expand(B, S)}
        with torch.inference_mode():
            logits[name] = M.prefill(cfg, eng.params, batch)[0].float().cpu()
        ids[name] = eng.generate(prompt, n_new)
        check_replays(eng, n_new, name)
        seconds[name] = time.perf_counter() - t0
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    same = bool(np.array_equal(ids["cpu"], ids["cuda"]))
    top2 = torch.topk(logits["cpu"], 2, dim=-1).values
    emit("serve_hymba_parity", arch=cfg.name, dtype="float32",
         layers=cfg.n_layers, windows=windows, batch=B, prompt=S,
         n_new=n_new, logits_max_abs_err=err, tol=HYMBA_PARITY_LOGIT_ATOL,
         logits_max_abs=logits["cpu"].abs().max().item(), ids_equal=same,
         ids_cpu=ids["cpu"].tolist(), ids_cuda=ids["cuda"].tolist(),
         first_logit_gap=(top2[:, 0] - top2[:, 1]).min().item(),
         seconds=seconds)
    check(err <= HYMBA_PARITY_LOGIT_ATOL, f"hymba prefill logits differ "
          f"by {err} > {HYMBA_PARITY_LOGIT_ATOL}")
    check(same, "hymba greedy ids differ between the CPU and the card")
    del gpu, cpu, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_hymba(torch, cfg_full, rm):
    """hymba-1.5b at full width and depth 4 (layer 0 global, the rest
    windowed; bf16, weights drawn on the card) trained by the psum
    step under train_dmm's DMM controller over ClusterSim(8, 2 nodes, seed
    7): seq 128 x batch 16, W 8, fused AdamW.  A first run of HYMBA_REPLAY
    steps and then a weights step (the parameters after each are
    train_sp_hymba's references), then a second run from the same state,
    controller, timer and data that must give the first run's losses,
    cutoffs and parameters bit for bit over its HYMBA_REPLAY steps and
    goes on to HYMBA_STEPS, each asserting its launches (flash and
    mlstm_chunk 4 x 8, masked_grad_agg 1, fused_adam 1) and a finite loss.
    The two runs share one step function: one (8, N) buffer.  Then the
    device's busy share of one more step.  Returns the launches, the
    kernels' times, the weights (a CPU copy) and the references."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, cosine_schedule

    cfg = dataclasses.replace(cfg_full, n_layers=HYMBA_TRAIN_DEPTH)
    windows = [s.window for s in M.layer_specs(cfg)]
    W, S, B = 8, 128, 16
    t0 = time.perf_counter()
    p0 = cast(init_on_card(torch, cfg, torch.bfloat16, SEED + 19), "cpu",
              torch.bfloat16)
    n_params = sum(x.numel() for x in tree.leaves(p0))
    check(n_params == HYMBA_TRAIN_PARAMS, f"depth-{cfg.n_layers} "
          f"hymba-1.5b: {n_params} parameters, want {HYMBA_TRAIN_PARAMS}")
    opt = adamw(cosine_schedule(3e-4, 2, 20), fused=True)
    step_fn = make_train_step(cfg, opt, mask_agg="psum")
    setup_s = time.perf_counter() - t0

    def trainer():
        return _train_setup(
            torch, cfg, cast(p0, "cuda", torch.bfloat16), n_workers=W,
            seq=S, batch=B, controller=_dmm_controller(rm),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7), opt=opt,
            step_fn=step_fn)[0]

    tr = trainer()
    hist1 = [dict(h) for h in tr.run(HYMBA_REPLAY)]
    after1 = _cpu_copy(torch, tr.state["params"])
    # one weights step from there: what train_sp_hymba's must give
    tr.step_fn = make_train_step(cfg, opt, mask_agg="weights")
    tr.mask_agg = "weights"
    build.LAUNCHES.clear()
    check(bool(np.isfinite(tr.run(1)[-1]["loss"])), "train_hymba: the "
          "weights step's loss")
    want_w = {"flash_attention": cfg.n_layers, "mlstm_chunk": cfg.n_layers,
              "fused_adam": 1}
    check(dict(build.LAUNCHES) == want_w, f"train_hymba weights step: "
          f"launches {dict(build.LAUNCHES)}, want {want_w}")
    sp_ref = {"psum": after1, "weights": _cpu_copy(torch, tr.state["params"])}
    del tr
    gc.collect()

    want = {"flash_attention": cfg.n_layers * W,
            "mlstm_chunk": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    tr = trainer()
    totals, walls, steps = {}, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(HYMBA_STEPS):
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        check(launches == want, f"train_hymba step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"train_hymba step {rec['step']}: loss {rec['loss']}")
        if i + 1 == HYMBA_REPLAY:
            replay = {
                "losses_equal": [h["loss"] for h in hist1]
                == [h["loss"] for h in tr.history],
                "cutoffs_equal": [h["c"] for h in hist1]
                == [h["c"] for h in tr.history],
                "params_equal": _bit_equal(
                    torch, after1, _cpu_copy(torch, tr.state["params"]))}
            check(all(replay.values()), f"train_hymba: the replay of "
                  f"{HYMBA_REPLAY} steps differs: {replay}")
            del after1
        walls.append(wall * 1e3)
        steps.append({"step": rec["step"], "c": rec["c"], "n": rec["n"],
                      "loss": rec["loss"], "clock": rec["clock"],
                      "wall_ms": wall * 1e3})
        emit("train_hymba", arch=cfg.name, dtype="bfloat16", **steps[-1],
             tokens_per_s=B * S / wall, launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    wall = []

    def one_step():
        t0 = time.perf_counter()
        tr.run(1)
        wall.append((time.perf_counter() - t0) * 1e3)

    prof = device_profile(torch, one_step)
    emit("train_hymba_profile", wall_ms=wall[0],
         device_busy_share=prof["device_ms"] / wall[0], **prof)
    check(len(step_fn.buffers) == 1, f"train_hymba: {len(step_fn.buffers)} "
          f"worker buffers, want the one (8, N)")
    buf = next(iter(step_fn.buffers.values())).buf
    agg, adam = _trainer_kernel_times(torch, buf, tr.state, "train_hymba")
    del buf
    emit("train_hymba_summary", params=n_params, layers=cfg.n_layers,
         global_layers=[li for li, w in enumerate(windows) if w == 0],
         workers=W, seq=S, batch=B, setup_s=setup_s,
         median_wall_ms=float(np.median(walls[1:])), launches=totals,
         max_memory_allocated=peak, replay=replay,
         replay_losses=[h["loss"] for h in hist1])
    del tr, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    return totals, agg, adam, p0, sp_ref


def phase_train_hymba_parity(torch, cfg_full):
    """hymba-1.5b at full width and depth 2 (a global and a windowed
    layer), f32, W 2 (one worker dropped), seq 32 x batch 4, fused AdamW,
    2 steps: train_parity's comparisons at HYMBA_PARITY_TOL, CPU against
    the card."""
    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    p_cpu = cast(init_on_card(torch, cfg, torch.float32, SEED + 20), "cpu",
                 torch.float32)
    torch.cuda.empty_cache()
    rec, _ = _train_parity(torch, cfg, p_cpu, W=2, S=32, B=4, n_steps=2,
                           cutoff=1)
    rec["tol"] = HYMBA_PARITY_TOL
    emit("train_hymba_parity", arch=cfg.name, host_rss=_host_rss(), **rec)
    _check_train_parity(rec, "train_hymba_parity", HYMBA_PARITY_TOL)


# ---------------------------------------------------------------------------
# whisper-base (encoder-decoder: the flash kernel non-causally in the
# encoder and in cross-attention) and qwen2-vl-7b (M-RoPE over three
# position streams, patch embeddings merged into the token stream), each
# served at full depth and trained under the DMM cutoff.  Both frontends
# are stubs in both packages, so the frames and patches are drawn from
# seeds.
# ---------------------------------------------------------------------------

# the reference's own trees (jax.eval_shape of repro.models.model
# .init_model; tests/test_torch_archs.py holds the port's tree to them):
# ArchConfig.n_params() leaves out whisper's encoder, cross-attention and
# position tables (ROADMAP, known gaps)
WHISPER_PARAMS = 114_813_952
QWEN2VL_PARAMS = 7_615_616_512
QWEN2VL_TRAIN_DEPTH = 2        # the (8, N) f32 buffer at full depth: 244 GB
QWEN2VL_TRAIN_PARAMS = 1_556_113_920
QWEN2VL_TRAIN_W = 4            # (4, N) f32: 24.9 GB
QWEN2VL_FIT_STEPS = 100        # its 4-worker DMM's fit
MEDIA_STEPS = 3
MEDIA_REPLAY = 2
# whisper's parity at full depth (12 blocks) and qwen2-vl's at depth 2,
# f32: Hymba's bar (1e-4) on logits and on the cross caches
MEDIA_PARITY_ATOL = 1e-4
# the qwen2-vl image run: an 8 x 8 grid of patches from this position
IMAGE_AT, IMAGE_GRID = 32, 8


def image_run(s):
    """(first position, grid side) of the image run in s tokens: an
    IMAGE_GRID x IMAGE_GRID grid from IMAGE_AT, smaller where s is
    short (the parity runs' seq 32: a 4 x 4 grid from 8)."""
    at = min(IMAGE_AT, s // 4)
    return at, min(IMAGE_GRID, math.isqrt(s // 2))


def vision_inputs(cfg, n, s, rng):
    """qwen2-vl's stubbed frontend for an (n, s) batch: seeded patch
    embeddings (f32, the embedding table's scale) on an image run
    (``image_run``), its mask, and (3, n, s) M-RoPE
    positions whose stream t is 0..s-1 (the masks' positions) and whose
    h/w streams walk the patch grid inside the run and follow t
    outside it."""
    at, grid = image_run(s)
    k = grid * grid
    t = np.broadcast_to(np.arange(s, dtype=np.int64), (n, s))
    h, w = t.copy(), t.copy()
    run = slice(at, at + k)
    h[:, run] = at + np.arange(k) // grid
    w[:, run] = at + np.arange(k) % grid
    mask = np.zeros((n, s), bool)
    mask[:, run] = True
    return {"positions": np.stack([t, h, w]),
            "patch_embeds": 0.02 * rng.standard_normal(
                (n, s, cfg.d_model), dtype=np.float32),
            "image_mask": mask}


def audio_frames(cfg, n, rng):
    """whisper's stubbed frontend: (n, encoder_seq_len, d_model) f32."""
    return 0.5 * rng.standard_normal((n, cfg.encoder_seq_len, cfg.d_model),
                                     dtype=np.float32)


class MediaTokens:
    """SyntheticTokens' batches with the stubbed frontend's inputs added,
    drawn from (seed, step): whisper's frames, or qwen2-vl's patches,
    image mask and (3, B, S) positions.  The Trainer takes any data with
    ``.batch(step)``."""

    def __init__(self, cfg, seq_len, global_batch, seed=SEED):
        from repro_torch.data.pipeline import SyntheticTokens

        self.cfg, self.seed = cfg, seed
        self.base = SyntheticTokens(vocab_size=cfg.vocab_size,
                                    seq_len=seq_len,
                                    global_batch=global_batch, seed=seed)

    def batch(self, step):
        b = dict(self.base.batch(step))
        rng = np.random.default_rng((self.seed, step, 17))
        n, s = b["tokens"].shape
        if self.cfg.is_encoder_decoder:
            b["frames"] = audio_frames(self.cfg, n, rng)
        if self.cfg.mrope_sections:
            b.update(vision_inputs(self.cfg, n, s, rng))
        return b


def _media_batch(torch, cfg, prompt, rng, device):
    """A prefill batch on ``device`` for ``prompt`` (numpy (B, S)): its
    frames or its patches and M-RoPE positions."""
    B, S = prompt.shape
    b = {"tokens": torch.as_tensor(prompt, dtype=torch.int64,
                                   device=device),
         "positions": torch.arange(S, device=device).expand(B, S)}
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = audio_frames(cfg, B, rng)
    if cfg.mrope_sections:
        extra.update(vision_inputs(cfg, B, S, rng))
    b.update({k: torch.as_tensor(v, device=device) for k, v in extra.items()})
    return b


def _count_syncs(torch, fn, messages=None):
    """``fn()`` under torch.cuda.set_sync_debug_mode("warn"): its result
    and the synchronizing calls it made (their warnings' text appended to
    ``messages`` when given)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if _is_sync(w)]
    if messages is not None:
        messages.extend(f"{w.filename}:{w.lineno}: {str(w.message)[:300]}"
                        for w in syncs)
    return out, len(syncs)


def _serve_media(torch, label, cfg, params, *, B, S, n_new, seed, want,
                 frames=None):
    """ServeEngine.generate at (B, S) + n_new greedy tokens through the
    decode graph (:func:`graph_decode`, prefill's launches against
    ``want``), prefill ms (eager, 3 calls), ms per token, tokens/s, peak
    memory and the device's busy share of a request."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    engine = ServeEngine(cfg, params, max_len=S + n_new)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    rec, _, prof = graph_decode(torch, label, cfg, engine, prompts, n_new,
                                want, frames=frames)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device="cuda"),
             "positions": torch.arange(S, device="cuda").expand(B, S)}
    if cfg.mrope_sections:
        batch["positions"] = batch["positions"].expand(3, B, S)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.as_tensor(frames, device="cuda")
    with torch.inference_mode():
        prefill_ms = eager_ms(torch, lambda: M.prefill(cfg, engine.params,
                                                       batch), reps=3,
                              warmup=1)
    gen_ms = rec["generate_ms"]
    rec.update(dtype="bfloat16", prefill_ms=prefill_ms,
               decode_ms_per_token=(gen_ms - prefill_ms) / n_new,
               tokens_per_s=B * n_new / (gen_ms / 1e3),
               device_busy_share=prof["device_ms"] / prof["wall_ms"],
               profile_top=prof["top"][:5])
    del engine
    return rec


def phase_serve_whisper(torch, cfg):
    """Full-width, full-depth whisper-base (6 encoder + 6 decoder blocks,
    bf16, weights drawn on the card) through ServeEngine.generate: 4
    prompts of 32 tokens over seeded frames (4, 1536, 512), 16 greedy new
    tokens; asserts 18 flash launches a prefill (the encoder's 6
    non-causal, the decoder's 6 causal and 6 cross) and 12 a decode step
    (6 self, 6 cross over the cached 1536 frames), ids in range, no
    synchronizing call in the decode loop; prefill ms, ms per token,
    tokens/s, peak memory."""
    from repro_torch import tree

    B, S, n_new = 4, 32, 16
    L = cfg.n_layers + cfg.n_encoder_layers
    params = init_on_card(torch, cfg, torch.bfloat16, SEED + 21)
    n_params = sum(x.numel() for x in tree.leaves(params))
    check(n_params == WHISPER_PARAMS, f"whisper-base: {n_params} "
          f"parameters, want {WHISPER_PARAMS}")
    frames = audio_frames(cfg, B, np.random.default_rng(SEED + 22))
    # prefill's: the encoder's, the decoder's causal and cross calls
    want = {"flash_attention": L + cfg.n_layers}
    rec = _serve_media(torch, "serve_whisper", cfg, params, B=B, S=S,
                       n_new=n_new, seed=SEED + 23, want=want,
                       frames=frames)
    emit("serve_whisper", params=n_params, frames=cfg.encoder_seq_len,
         encoder_layers=cfg.n_encoder_layers, **rec)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec["launches"]


def _media_parity(torch, label, cfg, *, B, S, n_new, seed, sampled=False):
    """``cfg`` in f32 (weights drawn on the card, copied to the host):
    one prefill of a media batch (frames, or patches and M-RoPE
    positions) and greedy ids of ServeEngine.generate (and, ``sampled``,
    ids at SAMPLE_T), the CPU (plain path) against the card (kernels).
    Logits and every cache leaf of the prefill within MEDIA_PARITY_ATOL,
    ids equal."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeEngine

    params = cast(init_on_card(torch, cfg, torch.float32, seed), "cpu",
                  torch.float32)
    torch.cuda.empty_cache()
    prompt = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    frames = (audio_frames(cfg, B, np.random.default_rng(seed + 2))
              if cfg.is_encoder_decoder else None)
    seconds, logits, caches, ids, ids_t = {}, {}, {}, {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params if dev == "cpu" else
                          cast(params, "cuda", torch.float32),
                          max_len=S + n_new, device=dev)
        batch = _media_batch(torch, cfg, prompt,
                             np.random.default_rng(seed + 2), dev)
        with torch.inference_mode():
            lg, cc = M.prefill(cfg, eng.params, batch)
        logits[dev] = lg.float().cpu()
        caches[dev] = [x.cpu() for x in tree.leaves(cc)]
        ids[dev] = eng.generate(prompt, n_new, frames=frames)
        if sampled:
            ids_t[dev] = eng.generate(prompt, n_new, temperature=SAMPLE_T,
                                      seed=SAMPLE_SEED, frames=frames)
        check_replays(eng, n_new, f"{label} {dev}")
        seconds[dev] = time.perf_counter() - t0
        del eng, batch, lg, cc
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    cache_err = max((a - b).abs().max().item()
                    for a, b in zip(caches["cpu"], caches["cuda"]))
    same = bool(np.array_equal(ids["cpu"], ids["cuda"]))
    same_t = (bool(np.array_equal(ids_t["cpu"], ids_t["cuda"])) if sampled
              else None)
    top2 = torch.topk(logits["cpu"], 2, dim=-1).values
    emit(label, arch=cfg.name, dtype="float32", layers=cfg.n_layers,
         batch=B, prompt=S, n_new=n_new, logits_max_abs_err=err,
         cache_max_abs_err=cache_err, cache_leaves=len(caches["cpu"]),
         tol=MEDIA_PARITY_ATOL,
         logits_max_abs=logits["cpu"].abs().max().item(), ids_equal=same,
         ids_cpu=ids["cpu"].tolist(), ids_cuda=ids["cuda"].tolist(),
         sampled_ids_equal=same_t,
         sampled_ids={d: x.tolist() for d, x in ids_t.items()},
         first_logit_gap=(top2[:, 0] - top2[:, 1]).min().item(),
         seconds=seconds)
    check(err <= MEDIA_PARITY_ATOL, f"{label}: prefill logits differ by "
          f"{err} > {MEDIA_PARITY_ATOL}")
    check(cache_err <= MEDIA_PARITY_ATOL, f"{label}: prefill caches differ "
          f"by {cache_err} > {MEDIA_PARITY_ATOL}")
    check(same, f"{label}: greedy ids differ between the CPU and the card")
    check(same_t is not False, f"{label}: ids at temperature {SAMPLE_T} "
          f"differ between the CPU and the card")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_whisper_parity(torch, cfg_full):
    """whisper-base at full width and depth in f32, 2 prompts of 32 tokens
    over seeded frames, 8 new tokens greedy and at SAMPLE_T: prefill
    logits, the self and cross caches (k, v, ck, cv of every block) within
    MEDIA_PARITY_ATOL, equal ids; CPU against the card."""
    cfg = dataclasses.replace(cfg_full, dtype="float32")
    _media_parity(torch, "serve_whisper_parity", cfg, B=2, S=32, n_new=8,
                  seed=SEED + 24, sampled=True)


def _train_media(torch, label, cfg, p0, controller_fn, *, W, S, B, want):
    """The psum step (fused AdamW, ClusterSim(W, 2 nodes, seed 7),
    MediaTokens) under ``controller_fn()``'s DMM controller: MEDIA_REPLAY
    steps, then a second trainer from the same state, controller, timer
    and data that must match them bit for bit (losses, cutoffs,
    parameters) and goes on to MEDIA_STEPS steps, each asserting its
    launches against ``want`` and a finite loss; the two runs share one
    step function (one (W, N) buffer).  Then the device's busy share of
    one more step and the kernels timed on the trainer's own buffer and
    state."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import adamw, cosine_schedule

    opt = adamw(cosine_schedule(3e-4, 2, 20), fused=True)
    step_fn = make_train_step(cfg, opt, mask_agg="psum")

    def trainer():
        return _train_setup(
            torch, cfg, cast(p0, "cuda", torch.bfloat16), n_workers=W,
            seq=S, batch=B, controller=controller_fn(),
            timer=ClusterSim(n_workers=W, n_nodes=2, seed=7), opt=opt,
            step_fn=step_fn, data=MediaTokens(cfg, S, B))[0]

    tr = trainer()
    hist1 = [dict(h) for h in tr.run(MEDIA_REPLAY)]
    after1 = _cpu_copy(torch, tr.state["params"])
    del tr
    gc.collect()
    tr = trainer()
    totals, walls, replay = {}, [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(MEDIA_STEPS):
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rec = tr.run(1)[-1]        # drains the loss: ends in a device sync
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        check(launches == want, f"{label} step {rec['step']}: launches "
              f"{launches}, want {want}")
        check(bool(np.isfinite(rec["loss"])),
              f"{label} step {rec['step']}: loss {rec['loss']}")
        if i + 1 == MEDIA_REPLAY:
            replay = {
                "losses_equal": [h["loss"] for h in hist1]
                == [h["loss"] for h in tr.history],
                "cutoffs_equal": [h["c"] for h in hist1]
                == [h["c"] for h in tr.history],
                "params_equal": _bit_equal(
                    torch, after1, _cpu_copy(torch, tr.state["params"]))}
            check(all(replay.values()), f"{label}: the replay of "
                  f"{MEDIA_REPLAY} steps differs: {replay}")
            del after1
        walls.append(wall * 1e3)
        emit(label, arch=cfg.name, dtype="bfloat16", step=rec["step"],
             c=rec["c"], n=rec["n"], loss=rec["loss"], clock=rec["clock"],
             wall_ms=wall * 1e3, tokens_per_s=B * S / wall,
             launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    wall = []

    def one_step():
        t0 = time.perf_counter()
        tr.run(1)
        wall.append((time.perf_counter() - t0) * 1e3)

    prof = device_profile(torch, one_step)
    emit(f"{label}_profile", wall_ms=wall[0],
         device_busy_share=prof["device_ms"] / wall[0], **prof)
    check(len(step_fn.buffers) == 1, f"{label}: {len(step_fn.buffers)} "
          f"worker buffers, want the one ({W}, N)")
    buf = next(iter(step_fn.buffers.values())).buf
    agg, adam = _trainer_kernel_times(torch, buf, tr.state, label)
    summary = {"workers": W, "seq": S, "batch": B,
               "median_wall_ms": float(np.median(walls[1:])),
               "launches": totals, "max_memory_allocated": peak,
               "replay": replay,
               "replay_losses": [h["loss"] for h in hist1],
               "busy_share": prof["device_ms"] / wall[0]}
    del tr, buf, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    return totals, agg, adam, summary


def phase_train_whisper(torch, cfg, rm):
    """whisper-base at full width and depth (bf16, weights drawn on the
    card) trained by the psum step under train_dmm's DMM controller: seq
    128 x batch 16 with seeded frames, W 8; each step asserts 8 x 18 flash
    launches (every worker's 6 encoder, 6 decoder and 6 cross calls), 1
    masked_grad_agg and 1 fused_adam; a bit-equal replay."""
    from repro_torch import tree

    W, S, B = 8, 128, 16
    t0 = time.perf_counter()
    p0 = cast(init_on_card(torch, cfg, torch.bfloat16, SEED + 25), "cpu",
              torch.bfloat16)
    n_params = sum(x.numel() for x in tree.leaves(p0))
    check(n_params == WHISPER_PARAMS, f"whisper-base: {n_params} "
          f"parameters, want {WHISPER_PARAMS}")
    per_worker = cfg.n_encoder_layers + 2 * cfg.n_layers
    want = {"flash_attention": per_worker * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals, agg, adam, summary = _train_media(
        torch, "train_whisper", cfg, p0, lambda: _dmm_controller(rm), W=W,
        S=S, B=B, want=want)
    emit("train_whisper_summary", params=n_params,
         setup_s=time.perf_counter() - t0, **summary)
    return totals, agg, adam


def _train_media_parity(torch, label, cfg, seed):
    """``cfg`` in f32 (weights drawn on the card), W 2 (one worker
    dropped), seq 32 x batch 2 with MediaTokens, fused AdamW, 2 steps:
    train_parity's comparisons at HYMBA_PARITY_TOL, CPU against the
    card."""
    p_cpu = cast(init_on_card(torch, cfg, torch.float32, seed), "cpu",
                 torch.float32)
    torch.cuda.empty_cache()
    rec, _ = _train_parity(torch, cfg, p_cpu, W=2, S=32, B=2, n_steps=2,
                           cutoff=1, data=MediaTokens(cfg, 32, 2))
    rec["tol"] = HYMBA_PARITY_TOL
    emit(label, arch=cfg.name, host_rss=_host_rss(), **rec)
    _check_train_parity(rec, label, HYMBA_PARITY_TOL)


def phase_train_whisper_parity(torch, cfg_full):
    """whisper-base at full width and depth, f32: the key biases'
    gradients (0 by construction) held at ZERO_GRAD_ATOL."""
    _train_media_parity(
        torch, "train_whisper_parity",
        dataclasses.replace(cfg_full, dtype="float32"), SEED + 26)


def phase_serve_qwen2vl(torch, cfg):
    """Full-depth qwen2-vl-7b (28 layers, bf16, weights drawn on the
    card): one M.prefill of 4 x 256 tokens whose positions 32..95 take
    seeded patch embeddings (an 8 x 8 grid), with M-RoPE positions whose
    h/w streams walk the grid (stream t 0..255): 28 flash launches,
    finite logits, and logits that the patches moved; then
    ServeEngine.generate on a text prompt (as the reference's engine
    serves), 4 x 256 + 16 greedy new tokens: 28 x 17 flash launches, ids
    in range; prefill ms, ms per token, tokens/s, peak memory."""
    from repro_torch import tree
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    B, S, n_new = 4, 256, 16
    t0 = time.perf_counter()
    params = init_on_card(torch, cfg, torch.bfloat16, SEED + 27)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.leaves(params))
    check(n_params == QWEN2VL_PARAMS, f"qwen2-vl-7b: {n_params} "
          f"parameters, want {QWEN2VL_PARAMS}")
    prompt = np.random.default_rng(SEED + 28).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    batch = _media_batch(torch, cfg, prompt,
                         np.random.default_rng(SEED + 29), "cuda")
    check(not torch.equal(batch["positions"][0], batch["positions"][1]),
          "serve_qwen2vl: the h stream equals t")
    build.LAUNCHES.clear()
    with torch.inference_mode():
        lg, _ = M.prefill(cfg, params, batch)
        text, _ = M.prefill(cfg, params, dict(
            batch, image_mask=torch.zeros_like(batch["image_mask"])))
    image_launches = build.LAUNCHES.get("flash_attention", 0)
    check(image_launches == 2 * cfg.n_layers, f"serve_qwen2vl: "
          f"{image_launches} flash launches in two prefills")
    check(bool(torch.isfinite(lg).all()) and lg.shape == (B, cfg.vocab_size),
          f"serve_qwen2vl: prefill logits {tuple(lg.shape)}")
    moved = (lg.float() - text.float()).abs().max().item()
    check(moved > 0, "serve_qwen2vl: the patches left the logits as they "
          "were")
    del lg, text, batch
    want = {"flash_attention": cfg.n_layers}
    rec = _serve_media(torch, "serve_qwen2vl", cfg, params, B=B, S=S,
                       n_new=n_new, seed=SEED + 30, want=want)
    emit("serve_qwen2vl", params=n_params, init_s=init_s,
         image_run=[image_run(S)[0], image_run(S)[0] + image_run(S)[1] ** 2],
         patch_logit_shift=moved, **rec)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": rec["launches"]["flash_attention"]
            + image_launches}


def phase_serve_qwen2vl_parity(torch, cfg_full):
    """qwen2-vl-7b at full width and depth 2 in f32, 2 x 128 tokens with
    the image run and M-RoPE positions of serve_qwen2vl, 8 greedy new
    tokens: prefill logits and caches within MEDIA_PARITY_ATOL, equal
    ids; CPU against the card."""
    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    _media_parity(torch, "serve_qwen2vl_parity", cfg, B=2, S=128, n_new=8,
                  seed=SEED + 31)


def phase_train_qwen2vl(torch, cfg_full):
    """qwen2-vl-7b at full width and depth 2 (bf16, 1,556,113,920
    parameters) trained by the psum step at W 4 under a DMM fitted on the
    card as train_dmm fits its own (RuntimeModel(4, lag 20) on
    ClusterSim(4, 2 nodes, seed 0).run(200), QWEN2VL_FIT_STEPS steps):
    CutoffController(rm, 48); seq 128 x batch 16 whose batches carry
    patches, the image mask and (3, B, S) positions through the
    per-worker split; each step 2 x 4 flash, 1 masked_grad_agg, 1
    fused_adam; a bit-equal replay."""
    from repro_torch import tree
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core.controller import CutoffController
    from repro_torch.core.runtime_model.api import RuntimeModel

    W, S, B = QWEN2VL_TRAIN_W, 128, 16
    cfg = dataclasses.replace(cfg_full, n_layers=QWEN2VL_TRAIN_DEPTH)
    t0 = time.perf_counter()
    trace = ClusterSim(n_workers=W, n_nodes=2, seed=0).run(200)
    rm = RuntimeModel(n_workers=W, lag=20, device="cuda").init(0)
    fit = rm.fit(trace, steps=QWEN2VL_FIT_STEPS, batch=8)
    fit_s = time.perf_counter() - t0

    def controller():
        ctl = CutoffController(rm, k_samples=48)
        ctl.seed_window(trace)
        return ctl

    p0 = cast(init_on_card(torch, cfg, torch.bfloat16, SEED + 32), "cpu",
              torch.bfloat16)
    n_params = sum(x.numel() for x in tree.leaves(p0))
    check(n_params == QWEN2VL_TRAIN_PARAMS, f"depth-{cfg.n_layers} "
          f"qwen2-vl-7b: {n_params} parameters, want "
          f"{QWEN2VL_TRAIN_PARAMS}")
    want = {"flash_attention": cfg.n_layers * W, "masked_grad_agg": 1,
            "fused_adam": 1}
    totals, agg, adam, summary = _train_media(
        torch, "train_qwen2vl", cfg, p0, controller, W=W, S=S, B=B,
        want=want)
    emit("train_qwen2vl_summary", params=n_params, layers=cfg.n_layers,
         fit_seconds=fit_s, fit_loss_first_last=[fit[0], fit[-1]],
         setup_s=time.perf_counter() - t0, **summary)
    del p0, rm
    gc.collect()
    torch.cuda.empty_cache()
    return totals, agg, adam


def phase_train_qwen2vl_parity(torch, cfg_full):
    """qwen2-vl-7b at full width and depth 2, f32."""
    _train_media_parity(
        torch, "train_qwen2vl_parity",
        dataclasses.replace(cfg_full, n_layers=2, dtype="float32"),
        SEED + 33)


def timed(seconds, name, fn, *args):
    """Run one phase and keep its wall time under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[name] = time.perf_counter() - t0
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import tree
    from repro_torch.configs.base import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)

    sec = {"start": time.perf_counter() - t_start}
    timed(sec, "build", phase_build)
    flash = timed(sec, "flash_attention", phase_flash, torch)
    flash_len = timed(sec, "flash_len", phase_flash_len, torch)
    mlstm = timed(sec, "mlstm_chunk", phase_mlstm, torch)
    timed(sec, "capture_audit", phase_capture_audit, torch)
    cfg = get_config("qwen2-0.5b")
    params_f32 = timed(sec, "init_weights", init_weights, torch, cfg)
    serve_launches = timed(sec, "serve", phase_serve, torch, cfg, params_f32)
    timed(sec, "serve_parity", phase_parity, torch, cfg, params_f32)
    agg, agg_err, agg_sum_err = timed(sec, "masked_grad_agg",
                                      phase_masked_agg, torch)
    agg_shard = agg.pop("shard_major")
    shapes = [tuple(x.shape) for x in tree.leaves(params_f32)]
    adam, adam_err = timed(sec, "fused_adam", phase_fused_adam, torch, shapes)
    adam_shard = adam.pop("shard_views")
    train_launches, firstk_clocks, train_ref = timed(
        sec, "train", phase_train, torch, cfg, params_f32)
    dp_launches, dp_rec = timed(sec, "train_dp", phase_train_dp, torch, cfg,
                                params_f32, train_ref)
    z3_launches, z3_rec = timed(sec, "train_zero3", phase_train_zero3, torch,
                                cfg, params_f32, train_ref)
    sp_launches, sp_rec, sp_flash = timed(sec, "train_sp", phase_train_sp,
                                          torch, cfg, params_f32, train_ref)
    del train_ref
    timed(sec, "train_parity", phase_train_parity, torch, cfg)
    timed(sec, "dmm", phase_dmm, torch)
    timed(sec, "ps", phase_ps, torch)
    timed(sec, "cnn", phase_cnn, torch)
    supervised_launches = timed(sec, "supervised", phase_supervised, torch)
    dmm_launches, rm = timed(sec, "train_dmm", phase_train_dmm, torch, cfg,
                             params_f32, firstk_clocks)

    def cut(phase):   # full width, CUT_DEPTH[phase] layers
        n = CUT_DEPTH[phase]
        return (dataclasses.replace(cfg, n_layers=n),
                dict(params_f32, layers=params_f32["layers"][:n]))

    obs_launches = timed(sec, "obs", phase_obs, torch, *cut("obs"), rm)
    policy_launches = timed(sec, "train_policies", phase_train_policies,
                            torch, *cut("train_policies"), rm)
    elastic_launches, agg_w6 = timed(sec, "train_elastic",
                                     phase_train_elastic, torch,
                                     *cut("train_elastic"))
    del params_f32
    multi_launches, agg_w4 = timed(
        sec, "train_multi_job", phase_train_multi_job, torch,
        dataclasses.replace(cfg, n_layers=CUT_DEPTH["train_multi_job"]))
    xcfg, xparams = timed(sec, "init_xlstm", init_xlstm, torch)
    xlstm_launches = timed(sec, "serve_xlstm", phase_serve_xlstm, torch,
                           xcfg, xparams)
    timed(sec, "serve_xlstm_parity", phase_xlstm_parity, torch, xcfg,
          xparams)
    mlstm_grad = timed(sec, "mlstm_grad", phase_mlstm_grad, torch)
    sp_mlstm = timed(sec, "sp_mlstm", _sp_mlstm, torch)
    n_x = CUT_DEPTH["train_xlstm"]
    xcut = dataclasses.replace(xcfg, n_layers=n_x)
    xparams = dict(xparams, layers=xparams["layers"][:n_x])
    xtrain_launches, xref = timed(sec, "train_xlstm", phase_train_xlstm,
                                  torch, xcut, xparams, rm)
    xsp_launches = timed(
        sec, "train_sp_xlstm", phase_train_sp_ssm, torch, "train_sp_xlstm",
        xcut, lambda: cast(xparams, "cuda", torch.bfloat16), xref,
        lambda: _dmm_controller(rm))
    del xparams, xref
    timed(sec, "train_xlstm_parity", phase_train_xlstm_parity, torch, xcfg)
    mcfg = get_config("deepseek-moe-16b")
    moe_serve_launches = timed(sec, "serve_moe", phase_serve_moe, torch, mcfg)
    timed(sec, "serve_moe_parity", phase_serve_moe_parity, torch, mcfg)
    moe_train_launches, agg_moe, adam_moe = timed(
        sec, "train_moe", phase_train_moe, torch, mcfg, rm)
    timed(sec, "train_moe_parity", phase_train_moe_parity, torch, mcfg)
    hcfg = get_config("hymba-1.5b")
    hymba_serve_launches = timed(sec, "serve_hymba", phase_serve_hymba,
                                 torch, hcfg)
    timed(sec, "serve_hymba_parity", phase_serve_hymba_parity, torch, hcfg)
    hymba_train_launches, agg_hymba, adam_hymba, hp0, href = timed(
        sec, "train_hymba", phase_train_hymba, torch, hcfg, rm)
    hsp_launches = timed(
        sec, "train_sp_hymba", phase_train_sp_ssm, torch, "train_sp_hymba",
        dataclasses.replace(hcfg, n_layers=HYMBA_TRAIN_DEPTH),
        lambda: cast(hp0, "cuda", torch.bfloat16), href,
        lambda: _dmm_controller(rm))
    del hp0, href
    timed(sec, "train_hymba_parity", phase_train_hymba_parity, torch, hcfg)
    wcfg = get_config("whisper-base")
    whisper_serve_launches = timed(sec, "serve_whisper", phase_serve_whisper,
                                   torch, wcfg)
    timed(sec, "serve_whisper_parity", phase_serve_whisper_parity, torch,
          wcfg)
    whisper_train_launches, agg_whisper, adam_whisper = timed(
        sec, "train_whisper", phase_train_whisper, torch, wcfg, rm)
    del rm
    timed(sec, "train_whisper_parity", phase_train_whisper_parity, torch,
          wcfg)
    vcfg = get_config("qwen2-vl-7b")
    vl_serve_launches = timed(sec, "serve_qwen2vl", phase_serve_qwen2vl,
                              torch, vcfg)
    timed(sec, "serve_qwen2vl_parity", phase_serve_qwen2vl_parity, torch,
          vcfg)
    vl_train_launches, agg_vl, adam_vl = timed(
        sec, "train_qwen2vl", phase_train_qwen2vl, torch, vcfg)
    timed(sec, "train_qwen2vl_parity", phase_train_qwen2vl_parity, torch,
          vcfg)
    emit("seconds", **sec, total=time.perf_counter() - t_start)

    def launches(name):
        by_path = {"serve": serve_launches.get(name, 0),
                   "train_psum_steps": train_launches.get(name, 0),
                   "train_dp": dp_launches.get(name, 0),
                   "train_zero3": z3_launches.get(name, 0),
                   "train_sp": sp_launches.get(name, 0),
                   "train_dmm": dmm_launches.get(name, 0),
                   "obs": obs_launches.get(name, 0),
                   "train_policies": policy_launches.get(name, 0),
                   "train_elastic": elastic_launches.get(name, 0),
                   "train_multi_job": multi_launches.get(name, 0),
                   "serve_xlstm": xlstm_launches.get(name, 0),
                   "supervised": supervised_launches.get(name, 0),
                   "train_xlstm": xtrain_launches.get(name, 0),
                   "train_sp_xlstm": xsp_launches.get(name, 0),
                   "serve_moe": moe_serve_launches.get(name, 0),
                   "train_moe": moe_train_launches.get(name, 0),
                   "serve_hymba": hymba_serve_launches.get(name, 0),
                   "train_hymba": hymba_train_launches.get(name, 0),
                   "train_sp_hymba": hsp_launches.get(name, 0),
                   "serve_whisper": whisper_serve_launches.get(name, 0),
                   "train_whisper": whisper_train_launches.get(name, 0),
                   "serve_qwen2vl": vl_serve_launches.get(name, 0),
                   "train_qwen2vl": vl_train_launches.get(name, 0)}
        return sum(by_path.values()), by_path

    def worst(cases, head):
        """max_abs_err over a grid of cases, the case that gave it (with the
        output's largest magnitude there, where recorded) and the headline
        case's own error."""
        w = max(cases.values(), key=lambda r: r["max_abs_err"])
        out = {"max_abs_err_case": w["case"],
               "case_max_abs_err": cases[head]["max_abs_err"]}
        if "y_max_abs" in w:
            out["max_abs_err_y_max_abs"] = w["y_max_abs"]
        return w["max_abs_err"], out

    flash_err, flash_extra = worst(flash, HEADLINE_CASE)
    mlstm_err, mlstm_extra = worst(mlstm, MLSTM_HEADLINE)
    hymba_mlstm = mlstm[MLSTM_HYMBA_HEADLINE]
    head = flash[HEADLINE_CASE]
    agg_head, adam_head = agg[AGG_HEADLINE], adam[ADAM_HEADLINE]
    rows = []
    # max_abs_err is the largest over each kernel's checked grid
    for name, replaces, err, rec, case, extra in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:93",
             flash_err, head, HEADLINE_CASE, flash_extra),
            ("masked_grad_agg", "src/repro/kernels/masked_grad_agg.py:32",
             agg_err, agg_head, AGG_HEADLINE,
             {f"{w}_{k}": agg[k] for w, agg in (
                 ("w6", agg_w6), ("w4", agg_w4), ("moe_w8", agg_moe),
                 ("hymba_w8", agg_hymba), ("whisper_w8", agg_whisper),
                 ("qwen2vl_w4", agg_vl))
              for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "max_abs_err")}
             | {f"{w}_N": agg["N"] for w, agg in (
                 ("moe_w8", agg_moe), ("hymba_w8", agg_hymba),
                 ("whisper_w8", agg_whisper), ("qwen2vl_w4", agg_vl))}),
            ("fused_adam", "src/repro/kernels/fused_adam.py:40", adam_err,
             adam_head, ADAM_HEADLINE,
             {f"{w}_{k}": adam[k] for w, adam in (
                 ("moe", adam_moe), ("hymba", adam_hymba),
                 ("whisper", adam_whisper), ("qwen2vl", adam_vl))
              for k in ("params", "ms", "plain_ms", "library_ms",
                        "bound_ms")} | {"shard_views": adam_shard}),
            ("mlstm_chunk", "src/repro/kernels/mlstm_chunk.py:87",
             mlstm_err, mlstm[MLSTM_HEADLINE], MLSTM_HEADLINE,
             {**mlstm_extra,
              **{k: mlstm[MLSTM_HEADLINE][k]
                 for k in ("path", "fma_floor_ms",
                           "cuda_kernels_per_call")},
              "bwd_case": MLSTM_GRAD_HEADLINE,
              **{k: mlstm_grad[MLSTM_GRAD_HEADLINE][k]
                 for k in ("fwd_ms", "bwd_ms", "bwd_bound_ms",
                           "bwd_bound_by")},
              "fwd_bound_ms": mlstm_grad[MLSTM_GRAD_HEADLINE]["bound_ms"],
              "fwd_bound_by": mlstm_grad[MLSTM_GRAD_HEADLINE]["bound_by"],
              "hymba_case": MLSTM_HYMBA_HEADLINE,
              **{f"hymba_{k}": hymba_mlstm[k]
                 for k in ("path", "ms", "plain_ms", "bound_ms", "bound_by",
                           "max_abs_err", "y_max_abs")}})):
        total, by_path = launches(name)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": total,
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "case": case, **extra})
    # the sum mode: a data-parallel rank's share of the combine (train_dp)
    sum_head = agg[AGG_SUM_HEADLINE]
    total, by_path = launches("masked_grad_agg_sum")
    rows.insert(2, {
        "name": "masked_grad_agg_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_grad_agg.cu",
        "replaces": "src/repro/kernels/masked_grad_agg.py:32",
        "launches": total, "launches_by_path": by_path,
        "max_abs_err": agg_sum_err, "ms": sum_head["ms"],
        "plain_ms": sum_head["plain_ms"], "bound_ms": sum_head["bound_ms"],
        "bound_by": sum_head["bound_by"],
        "library_ms": sum_head["library_ms"], "case": AGG_SUM_HEADLINE,
        "mode": "sum (mean=False: the masked sum, undivided)",
        **{f"train_dp_{k}": dp_rec[k] for k in (
            "all_reduce_psum_ms", "all_reduce_weights_ms", "broadcast_ms",
            "psum_wall_ms", "all_reduce_share_of_psum_step")},
        **{f"train_zero3_{k}": z3_rec[k] for k in (
            "gathers_per_forward_ms", "reduce_ms", "reduce_scatter_ms",
            "piece_all_gather_ms")},
        **{f"train_zero3_{part}_{k}": z3_rec[part][k]
           for part in ("zero1_off", "zero1_on")
           for k in ("psum_wall_ms", "collectives_share_of_psum_step")},
        **{f"train_sp_{k}": sp_rec[k] for k in (
            "psum_wall_ms", "weights_wall_ms", "max_memory_allocated")},
        "shard_major": agg_shard})
    # the serve decode's call: the key count on the device (graph decode)
    dec = flash_len[FLASH_LEN_HEADLINE]
    rows[0].update({"decode_case": FLASH_LEN_HEADLINE,
                    "decode_ms": dec["ms"],
                    "decode_library_ms": dec["library_ms"],
                    "decode_bound_ms": dec["bound_ms"]})
    rows[0]["device_length_cases"] = {
        c: {k: flash_len[c][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "rel_err", "short_rel_err", "replay_max_abs_err",
            "path", "splits")}
        for c in flash_len}
    rows[0]["slice_cases"] = {
        c: {k: flash[c][k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "max_abs_err",
                                     "max_abs_want", "rel_err",
                                     "dropped_tile_rel_err", "path")}
        for c in SLICE_FLASH_CASES}
    # train_sp's per-shard shapes (causal ranks, the halo, the encoder)
    rows[0]["sp_cases"] = {
        c: {k: sp_flash[c][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "rel_err", "grad_rel_err")}
        for c in sp_flash}
    # train_sp's per-rank shapes with the prefix carried (mlstm_chunk)
    next(r for r in rows if r["name"] == "mlstm_chunk")["sp_cases"] = {
        c: {k: sp_mlstm[c][k] for k in (
            "shape", "dv", "path", "ms", "state_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "state_bound_ms",
            "state_bound_by", "max_abs_err", "final_scaled_err",
            "grad_scaled_err")}
        for c in sp_mlstm}
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
