"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):
  1. the card's name and power limit; the three kernel libraries, built at
     once (one nvcc each) from ray_tpu_torch/csrc/flash_fwd.cu,
     flash_bwd.cu and flash_stats.cu, what ptxas reported (registers and
     spills per kernel), and each kernel's count of HGMMA (tensor-core
     wgmma) instructions in the SASS that cuobjdump shows: the bf16
     forward, stats and backward (dK/dV and dQ) kernels must have some and
     spill nothing;
  2. the forward kernel against its plain PyTorch version on the same bf16
     inputs at the serving shapes (the output and the rows' log-sum-exp),
     with its time, the plain version's, that of torch's
     scaled_dot_product_attention (a yardstick only; the port never calls
     it) and the least time the card could take; at the prefill shape
     also the kernel's and sdpa's device time (device_ms);
  3. a small fp32 model on the card: logits through the kernel against the
     plain path on the CPU, and engine tokens against generate_greedy; the
     paged engine's tokens against generate_greedy (a roomy pool and one
     that preempts), a prefix-cache hit against its cold run, int8 pages
     against the same engine on the CPU, and speculative tokens against
     generate_greedy (a random draft and truncated_draft(., 1)) under
     torch.cuda.set_sync_debug_mode("error") outside the sanctioned reads;
     then LLAMA_DEBUG (head_dim 16, which the kernels decline) through
     flash_attention's dense route: logits, loss and gradients, the same
     through the sp = 4 ring's auto gate, and engine tokens against the
     CPU, with dense routes counted and no kernel launched;
  4. the serving main path at Llama-3-8B full width and depth with random
     weights: forward over [1, 1024] tokens, then an LLMServer answering
     six concurrent requests (one streamed) that hit every prefill bucket.
     The forward kernel's launch count is reset just before and read just
     after, and must equal n_layers x (forwards + prefills);
 4b. the paged and speculative main path on the same weights: a paged
     LLMServer (page 16, 129 pages, prefix cache) answers the six requests
     and two that share a 256-token prefix, with launches held to
     n_layers x cold prefills and the answers to the dense ones by a
     near-tie rule; the six again through int8 pages; a speculative server
     (truncated_draft(., 4), k = 4) answers prompts of 40 and 200 tokens,
     launches held to 2 x (n_layers + 4), timed beside generate_greedy;
  5. where the serving time goes: the warm forward time and a
     torch.profiler window over decode steps with every slot busy, on the
     dense engine and on the paged one. The 8B weights and the servers are
     freed after it;
  6. the backward kernels (dK/dV and dQ) against their plain version on
     the same bf16 inputs at the training shape, D = 128, a ragged L and a
     full mask, and once in fp32, with each kernel's device time, the whole
     backward's time and device time, di's plain reduction on its own, the
     plain version's time, that of scaled_dot_product_attention's backward
     (a yardstick only) by events and its device time, and the bounds; two
     backward calls on the same inputs must give the same bits; also at
     the calls a rank of phase 12 makes ([2, 2048, 16/4, 64] at fsdp = 2 x
     tp = 2, [1, 2048, 32/8, 64] at fsdp = 4), and at each microbatch's
     call of phases 16 and 12 (f)/(g) (pipeline_bwd_shapes: [2, 2048,
     32/8, 64] and [1, 2048, 16/4, 64]). At the training shape also
     the forward with lse, timed and profiled beside sdpa's;
  7. a small fp32 model trained on the card: the loss and every gradient
     through the kernels against the plain path on the CPU, dense and with
     remat and chunked vocab, then 3 AdamW steps against the same steps on
     the CPU;
  8. the training main path: Llama-3.2-1B (LLAMA3_1B) at full width and
     depth, bf16, random weights, tokens [4, 2048], AdamW(3e-4, weight
     decay 0.1), the same tokens every step: dense loss without remat (1
     warm-up and 5 timed steps), then remat with the chunked-vocab loss
     (3 steps) from the same weights. Every launch count is reset just
     before each run and read just after; the run prints step time,
     tokens/s, MFU, peak memory and a torch.profiler breakdown of a step;
  9. the stats kernel (ring attention's block step) against its plain
     version on the same bf16 inputs at the ring shard shape of phase 11
     (B=1, Lq=Lk=2048, 32/8 heads, D=64) for every key visible, the
     diagonal block, none and a ragged pattern, then D=128 with Lq != Lk,
     and once in fp32 with a stride-0 visible and a strided q, and in fp32
     at a rank's blocks in phase 12 (c) (2/1 heads); rows that
     see no key must give m == NEG_INF. With its time, the plain
     version's, the bound and torch's flash attention with its row
     log-sum-exp (a yardstick only; the port never calls it), and for
     every key visible both device times (device_ms);
 10. a small fp32 model: the loss and every gradient through the sp = 4
     ring (flash block step) on the card, against the same on the CPU
     through the plain versions and against the card's flash_attention;
     and parallel.sharded_loss_fn with remat and the chunked loss, card
     against CPU;
 11. the sequence-parallel main path: LLAMA3_1B at full width and depth,
     bf16, phase 8's tokens as one [1, 8192] sequence, the sp = 4 ring
     (flash) with its ranks in lockstep on this card, AdamW, the dense
     loss without remat: 1 warm-up and 3 timed steps, the stats kernel's
     launches held to n_layers x 16 x 4, then a profiled step. From the
     same weights 1 warm-up and 2 timed steps through flash_attention (K2)
     and as many through sp = 4 Ulysses (K1/K2), each with a profiled
     step; the three first losses agree within 1e-3. Then the ring's
     output and gradients at one layer's shape, held per element to
     flash_attention's, and its forward and backward timed beside them;
 12. sharded training (FSDP and TP): 4 processes on this card in one
     process group, their mesh built with backend="gloo" (every
     collective staged through host memory). (c) a small fp32 model (head
     dim 64, 4/2 heads) on tp = 2 x sp = 2 through the ring (K3 at 2/1
     heads a rank) and on fsdp = 2 x tp = 2 through flash_attention (K2)
     with remat and the chunked loss: loss and every gathered gradient
     against the same model on the CPU. (a) LLAMA3_1B at full width and
     depth on fsdp = 2 x tp = 2, dense loss, and (b) on fsdp = 4 with
     remat and the chunked loss: phase 8's weights (seed 7) cut to each
     rank's shards, phase 8's tokens and AdamW, one step, then the
     updated shards' loss from a forward under no_grad; the first
     loss within 1e-2 and the first global gradient norm within 1% of
     phase 8's same recipe, the later loss below the first, each rank's
     launches at phase 8's rate, and per rank its ms per step, peak
     memory and the bytes each collective moved in a step. (d) the
     dryrun's launcher, dryrun_multichip(4), on gloo, in a thread while
     the ranks run (its processes beside theirs). (e) phase 14's
     Mixtral on ep = 4 (make_ep_moe_ffn, capacity factor E / k, so
     nothing is dropped), phase 14's weights and tokens, one step and
     the forward as in (a):
     first loss and its CE part within 1e-2 and first gradient norm
     within 1% of phase 14's, launches at its rate, 12 all-to-alls of an
     fp32 [E, C, D] buffer a rank and step; and in (c) a small fp32
     Mixtral on ep = 2 x tp = 2 and fsdp = 2 x ep = 2 against the CPU.
     The pipeline over pp (make_pipelined_loss, GPipe, remat): (f) pp = 2
     x tp = 2 with 4 microbatches and (g) pp = 2 x fsdp = 2 with 2,
     LLAMA3_1B at full width and depth from phase 8's weights and tokens,
     one step and the forward as in (a), held to phase 8's dense run as
     phase 16 holds it, each
     rank's launches at the schedule's count, its hops (2 (M + S) - 3 a
     step) and FSDP gathers (once a step) counted in bytes; in (c)
     a 4-layer small fp32 Llama on pp = 4 (M = 4) and pp = 2 x tp = 2 (M =
     2) against the CPU; and (d) also runs the dryrun's pipeline (pp = 2 x
     tp = 2) and MoE (ep = 2 x tp = 2) parts, its multi-host part (two
     launcher processes of two ranks each on the card, meeting at a TCP
     address over gloo: 2.5 across them), its MPMD part (three
     stage actors of the runtime sharing the card, 8 microbatches, 1F1B,
     against the single program's loss) and its two 8B certificate
     lines, reckoned for this card's memory; (h) ViT-B/16 at full width and
     depth on fsdp = 2 x tp = 2 (sharded_vit_loss_fn under VIT_RULES, the
     patch embed and head gathered over tp), phase 15's weights, images
     and labels, AdamW, one step and the forward as in (a): the first
     loss within VIT_RTOL and the first gradient norm within 1% of phase
     15's, each rank's K2 launches 12 forward and 12 backward a step, the
     later loss below the first, and per rank its ms per step, peak
     memory and the bytes of each collective;
 13. Mixtral serving: Mixtral-8x7B's widths at 16 of its 32 layers (all
     32 do not fit the card), random weights, mixtral_generate_greedy on
     prompts of 40, 200 and 1024 tokens, 32 new tokens each (K1 launches
     16 a prefill), the tokens held at every step to the argmax of a
     teacher-forced forward on the decode's experts by phase 4's near-tie
     rule, its router at every position and layer to ROUTER_DRIFT and
     ROUTER_TIE, and a decode with a planted cache fault refused;
     prefill and decode times, the decode step's device busy share and
     the MoE's share of it, peak memory. Then a small fp32
     Mixtral (head dim 64) against the CPU: logits, aux, loss and every
     gradient, launches counted;
 14. Mixtral training on the one card: the same widths at 2 layers, bf16,
     tokens [4, 2048], remat, AdamW(3e-4, weight decay 0.1), 1 + 2 steps
     through the dense MoE; ms/step, tokens/s, peak memory, busy share,
     MFU by the active parameters and by every expert's FLOPs; K2 launches
     4 forward and 2 backward a step;
 15. ViT-B/16 at full width and depth: 128 random images, 1 + 2 AdamW
     steps (K2 at [128, 197, 12/12, 64] non-causal, 12 + 12 launches a
     step), the first loss and each leaf's gradient norm held to the
     same step through dense_attention by VIT_RTOL and VIT_LEAF_RTOL, a
     planted key-mask fault refused; the forward under no_grad (K1,
     12 launches); a small fp32 ViT against the CPU;
 16. the pipeline's main path: LLAMA3_1B at full width and depth, phase
     8's weights and tokens, its layers pipelined over a one-device pp =
     4 mesh (the 4 stages in lockstep on this card, 4 layers each) by
     make_pipelined_loss (remat), M = 4 and M = 2, 1 + 2 AdamW steps
     each: K2's launches at the schedule's count (every stage on every
     one of the M + S - 1 ticks, forward, recompute and backward), the
     first loss and whole gradient norm within 1e-2 of phase 8's dense
     run and each group's norm (embedding, final norm, head, each stage's
     layers) within GROUP_RTOL; ms per step beside phase 8's, the
     bubble's share, peak memory;
 17. the runtime's trainer: ray_tpu_torch.init(num_cpus=4, num_gpus=1),
     then TorchTrainer trains LLAMA3_1B at full width and depth (phase
     8's weights and tokens, the tokens through ray_tpu_torch.put) in
     worker actors the runtime pins to the card: (a) one worker, 3 steps,
     each loss held to phase 8's within RUNTIME_LOSS_RTOL and each step's
     K2 launches to phase 8's rate, get_gpu_ids() == ["0"]; (b) in the
     same run, a checkpoint of the parameters and AdamW state after step
     2, a planted exit just after it and FailureConfig(max_failures=1):
     step 3, on the restored worker, held to phase 8's bit for bit; (c)
     two workers at num_gpus=0.5 on gloo, half the batch each, gradients
     summed by allreduce_grads, one step, the first loss and gradient
     norm within 1e-2 of (a)'s (phase 12's rules) and within
     RUNTIME_DP_LOSS_RTOL and RUNTIME_DP_NORM_RTOL, then the updated
     weights' loss from a forward under no_grad below the first, both
     pinned to the card. Worker start, fit() to the first report,
     ms/step against phase 8's, the checkpoint's GB and seconds, the
     restart's seconds and the workers' peak memory are printed; the
     cluster is shut down at the end, failures included;
 18. the Serve runtime: ray_tpu_torch.init(num_cpus=4, num_gpus=1), then
     (a) serve.run of one LLMServer replica with ray_actor_options
     {"num_gpus": 1} (phase 4's max_slots and max_len) that draws
     LLAMA3_8B on the card from a seed, answering phase 4's six requests
     (one streamed) over the DeploymentHandle, the RPC ingress and, where
     aiohttp is installed, the HTTP proxy: the replica pinned to ["0"],
     each route's K1 launches n_layers x 6 in the replica, every response
     full length in the vocabulary, and each route's tokens held by
     phase 4's near-tie rule to an in-process LLMServer on the same
     weights, run after the replica is gone; time from serve.run to the
     replica ready, each route's client-side TTFT of the streamed request
     and tokens/s are printed; (b) one LLAMA3_1B replica on the card takes
     new weights, put once in the object store, by reconfigure({
     "weights_ref": ref}) through its handle: weights_version 2 and its
     greedy tokens held to an in-process server on the new weights by the
     near-tie rule; the refresh's seconds and GB/s are printed. Serve and
     the cluster are shut down at the end, failures included;
 19. the data ingest path: its own ray_tpu_torch.init(num_cpus=4,
     num_gpus=1); the driver first runs phase 8's dense step from seed 7
     on INGEST_ROWS rows of 2048 int32 tokens (numpy, INGEST_SEED), four
     batches of INGEST_BATCH in order; then (a) TorchTrainer(datasets=
     {"train": ds}) trains LLAMA3_1B in one worker with the card, ds
     being from_numpy over INGEST_BLOCKS blocks of those rows and a
     map_batches task: the loop takes train.get_dataset_shard("train")
     .iter_torch_batches(batch_size=INGEST_BATCH, dtypes={"tokens":
     torch.int64}, drop_last=True), device "auto" for steps 1-2 and
     train.torch.get_device() for 3-4, every batch equal to its rows on
     cuda:0 as int64, get_device() cuda:0, each loss within
     RUNTIME_LOSS_RTOL of the driver's, K2 n_layers launches a step
     forward and backward; (b) two workers at num_gpus=0.5 on gloo over
     DDP_ROWS rows of x: float32[16], y and id in DDP_BLOCKS blocks: the
     shards' ids disjoint and covering, prepare_model's DDP on cuda:0
     with device_ids [0], the averaged gradients of one step on each
     rank's first DDP_BATCH rows within DDP_GRAD_RTOL of the driver's
     over those rows, prepare_data_loader's indices disjoint and
     covering; (c) 1 GiB of int32 tokens RATE_SHAPE in RATE_BLOCKS
     blocks through a numpy map_batches and the driver's
     iter_torch_batches(RATE_BATCH, int64, device="cuda"), every batch's
     sum on the card equal to numpy's, with the wall time, GB/s into the
     card and the median ms a batch; then the same stream as numpy
     batches (no copy) and the driver's first and second read of 256
     MiB that a task wrote into the store, in GB/s. The card must be
     free after each trainer; the cluster is shut down at the end,
     failures included;
 20. the MPMD pipeline: its own ray_tpu_torch.init(num_cpus=4,
     num_gpus=1, object_store_memory=8 << 30); MPMDPipeline trains
     LLAMA3_1B at full width and depth (phase 8's weights, seed 7, and
     tokens) as MPMD_STAGES stage actors of 8 layers, each at the
     default placement's num_gpus=0.5 on the one card (no stage_options),
     MPMD_MICROBATCHES microbatches of one row, 1F1B,
     the activations and cotangents hopping between the actors through
     the compiled DAG: (a) one grad_check_step, then 1 + 2 AdamW steps:
     each stage's get_gpu_ids() ["0"], the first loss within 1e-2 and the
     whole gradient norm within 1% of phase 8's dense run and each
     group's norm within GROUP_RTOL, the later losses below the first,
     live_vjp_counts() [0, 0] and the store's used bytes back at their
     level after every step (the hops ride the actors' connections, so
     this holds the stages' argument trees and results, not the hops),
     and each stage's K2 launches at
     mpmd_expect's count (its layers x microbatches x passes, forward,
     remat's recompute and backward); ms/step beside phase 8's and phase
     16's, the bubble fraction, each stage's busy seconds, the bytes of
     a hop as the stages sent them and each stage's peak memory (their
     probe()) are printed; (b) the same
     pipeline (formed as gang MPMD_GANG, with save_checkpoint after (a)'s
     step 1 and stage 1's mpmd.boundary.send armed through stage_env to
     kill its process at its first send after (a)'s passes): the next
     step must fail with PipelineMemberLost stamped with the pipeline's
     generation within MPMD_DETECT_S; from_checkpoint under the same gang
     lands at generation + 1 and its step 2 loss equals (a)'s bit for
     bit. The card must be free after each pipeline; the cluster is shut
     down at the end, failures included;
 21. Tune and workflow: its own ray_tpu_torch.init(num_cpus=8,
     num_gpus=1); (a) a Tuner over TorchTrainer(ScalingConfig(num_workers=
     1, use_gpu=True, resources_per_worker={"GPU": 0.5})) trials of
     LLAMA3_1B at full width and depth (phase 8's weights, seed 7, and
     tokens, remat and the chunked loss, AdamW at the trial's rate, a
     report a step) over the rates TUNE_LRS, ASHAScheduler(max_t 3, grace
     period 2, reduction factor 2), two trials at a time: every trial on
     ["0"] and cuda:0, its first loss and the 3e-4 trial's losses 1-3
     within RUNTIME_LOSS_RTOL of phase 8's remat + chunked run, K2 at
     phase 8's remat rate a step, the first trial through 3 iterations and
     the last two stopped at iteration 2, the best result the finished
     trial with the lowest last loss; (b) PopulationBasedTraining over three
     ViT-B/16 Trainable trials with_resources {"GPU": 0.25} (phase 15's
     weights, images and labels, 4 iterations, a checkpoint of the
     parameters and AdamW state through save_pytree every iteration): every
     trial on ["0"], each original trial's first loss within VIT_RTOL of
     phase 15's, at least one exploit, the clone's parameters and AdamW
     state after load_checkpoint equal to the donor checkpoint's by each
     leaf's float64 sum, K2 12 + 12 a step; (c) workflow.run of a two-step
     DAG: the evaluation of (b)'s best checkpoint on the card (a task with
     num_gpus=0.5: ViT-B/16's loss under no_grad, K1 12 launches), then a
     step that fails while a planted marker exists; the workflow FAILED,
     resumed without running the evaluation again, its loss equal to the
     driver's forward of the checkpoint within VIT_RTOL, and get_output
     after the cluster restarts over the same storage. Each trial's start,
     first report, ms/step, peak memory, the checkpoints' GB and seconds
     and each part's seconds are printed; the card must be free after each
     part; the cluster is shut down and tune's storage removed at the end,
     failures included;
 22. runtime_env, jobs, the dashboard and the CLI: `python -m
     ray_tpu_torch start --head --num-cpus 4 --num-gpus 1` (its status
     "0/1 GPU"); a local wheel of JOB_PROBE written with zipfile; the
     phase's driver connects and starts the dashboard (where aiohttp is
     installed; else the jobs go through `job submit` and `job logs`);
     (a) a job posted to POST /api/jobs with runtime_env working_dir (its
     script, phase 8's tokens, its config) and env_vars, whose
     entrypoint connects through RAY_TPU_TORCH_ADDRESS and starts one
     actor with num_gpus=1 and runtime_env {"pip": the wheel, no index,
     no deps; "py_modules": [the JOB_STEP_PACKAGE dir]}: the actor runs
     in the venv's interpreter, imports the probe and the shipped step
     and trains phase 8's dense LLAMA3_1B step from seed 7 on phase 8's
     tokens, JOB_STEPS (1 warm-up, 2 timed): get_gpu_ids() ["0"] and
     CUDA_VISIBLE_DEVICES "0", its losses within RUNTIME_LOSS_RTOL of
     phase 8's, K2 n_layers a step forward and backward, read in the
     actor; the entrypoint's driver inherits no pin and opens no CUDA
     context (and is not on the card's process list); (b) a second job
     whose actor finds the same venv built (its marker unchanged) and
     holds the card's lease (no torch, no CUDA context), stopped by `job
     stop`: the card's share back within JOB_STOP_S. Submit to RUNNING, the venv's build, the actors' start
     (`import torch` in an env worker, which is not forked from the
     worker template), start to the first step, ms/step against phase
     8's and peak memory are printed; `stop` then leaves no process and
     no rtpt_ arena of the cluster;
 23. the autoscaler, a ray:// driver, an ActorPool and a C++ caller: a
     head with no GPU and a TCP port (HeadNode(num_gpus=0, port=)), the
     port's Autoscaler in this process over LocalNodeProvider with one
     node type "h100" (AUTOSCALE_TYPE, min 0, max 1, idle timeout
     AUTOSCALE_IDLE_S); the C++ caller (POOL_CPP) built with g++ against
     ray_tpu_torch/native/cpp_client while the cluster starts. A driver
     subprocess (POOL_DRIVER) connects with
     ray_tpu_torch.client("ray://...").connect() and asks for two named
     actors lm0, lm1 with num_gpus=0.5, a demand that makes the
     autoscaler start the node; each draws LLAMA3_1B in bf16 on the card
     from phase 8's seed 7 and answers next_tokens with the argmax of the
     last position's logits (a forward under no_grad, K1 in every layer)
     as numpy; util.ActorPool maps POOL_BATCHES prompt batches [4, 512]
     (seed 23) through them; POOL_FN, registered with
     cross_language.register_function, forwards to lm0, and the C++
     caller sends it batch 0 over the head's TCP port; the actors are
     killed. Held: the pool's and the C++ call's tokens equal this
     process's forward of the same weights and batches; each actor on
     ["0"]; K1 n_layers x the batches each actor served, n_layers more in
     lm0 for the C++ call (144 in all); no torch in the driver; the node
     terminated within AUTOSCALE_IDLE_S + AUTOSCALE_DOWN_S of the actors'
     end, the GPU gone from cluster_resources and no process of the node
     left; nothing of the cluster left after the head stops. Demand to
     node registered, registered to both actors ready, ms a batch and
     prompts/s through the pool, the C++ round trip, g++'s seconds, idle
     to terminated and the phase's seconds are printed;
 24. rl/'s learner stack and the Podracer tier: the pixel module at
     ViT-B/16's widths (RL_PIXEL) on CatchEnv(RL_IMAGE) pixels, 17 tokens
     and 12 heads of 64, fp32. First K2 at the learner's [512, 17, 12,
     64] (forward with lse and backward) and K1 at a runner's [16, 17, 12,
     64], each against its plain version, timed beside it and sdpa with
     the fp32 bound. Then ray_tpu_torch.init(num_cpus=8, num_gpus=1),
     whose worker template imports torch while (a) runs in this
     process: a VtraceMeshLearner (4 ranks on
     the card) from seed RL_SEED takes one update on RL_T x RL_B steps
     that an EnvRunnerImpl on the card collected past an episode's end:
     12 forward and 12 backward launches, dense_routes unchanged, its
     stats within RL_STATS_RTOL and its parameters within RL_PARAM_ATOL
     (but RL_PARAM_FLIP_SHARE of them, all within 2 lr) of the same update
     through flash_attention_plain; then the runner's sample function on
     RL_RUNNER_OBS observations, 12 launches, its logits and values held
     to the plain attention's. ms an update, images/s, ms an env step and
     peak GiB are printed. (b) On that cluster:
     PodracerConfig(...).learners(use_gpu=True).build(), 2 runners x 4
     envs on the CPU, fragments of 8, agg_fanin 2, broadcast_interval 2,
     the mesh of 4: RL_UPDATES or more updates, every loss finite, the
     learner's lease ["0"] and the runners' none in util.state's actor
     rows, staleness recorded, weight_bcast_puts equal to the publishes;
     each publish's seconds (the learner to the driver, the driver's put),
     each runner's pulls and ms an env step are printed. (c) On the same
     cluster once the card is free: one PPO iteration,
     learners(num_learners=1, use_gpu=True), two CPU runners on
     FlatCatch(8): the learner on ["0"], finite stats, get_state through
     save_checkpoint and restore_from_path (and load_pytree) bit for bit.
 25. rl/'s second half on phase 24's cluster, before it shuts down; no
     attention runs, and the kernels' counters must not move. (a) In this
     process: DreamerV3 at DreamerConfig's defaults (obs 64, 3 actions)
     on one [48, 8] batch that a DreamerEnvRunner on the card collected
     from FlatCatch(8); CQL at its defaults on obs 3 / act 1 at batch
     256; BC and MARWIL (beta 2.0) one epoch over 2048 logged rows
     through episodes_to_rows and data.from_items: each card update held
     to the same update on the CPU from the same weights and draws (stats
     within RL_STATS_RTOL, parameters as in phase 24), then timed. (b)
     DQN, learners(use_gpu=True), 2 CPU runners x 4 envs of FlatCatch(8),
     fragments of 32, prioritized replay, 16 updates of 64 an iteration,
     learning_starts 64, the target synced every 16 updates; (c) SAC at
     its defaults on chip_smoke's NumpyPendulum (gymnasium's Pendulum-v1
     in numpy), learning_starts 256: each 2 iterations, the learner on
     ["0"] and the runners on none, finite stats, the DQN target equal to
     the online weights after a sync, SAC's alpha moved from 1.0,
     get_state/set_state bit for bit; ms an update through the learner
     actor and ms an env step of a CPU runner printed. (d) DreamerV3Algo,
     one CPU runner x 8 envs, 2 iterations: an update on the card and
     finite episode returns. (e) `python -m ray_tpu_torch check
     ray_tpu_torch/rl` against ray_tpu_torch/raylint_baseline.json exits
     0 with no findings, and a process that decorates a get-in-loop
     remote under RAY_TPU_TORCH_STATIC_CHECKS=1 warns RTL002.
 26. the 8B pipeline stages, after phase 5 frees the servers and before
     phase 1's LLAMA3_8B weights go: tokens [1, 8192] from seed 26; (a)
     the unsplit loss_fn (remat, chunked vocab 16384) under no_grad; (b)
     split_llama_params(params, 4), the boundary activations from the
     stage forwards under no_grad, then one build_stage_step step a
     stage (AdamW 3e-4, weight decay 0.1, its first moment fp32) on a
     clone of the stage's weights, last to first, each taking the next
     stage's activation gradient: the last stage's loss within 2e-3 of
     (a)'s, each other stage's output within 1e-2 (max-relative) of the
     chained forward's, everything finite, each stage's state freed
     before the next; (c) each stage's peak memory over what was
     allocated before it, at or under stage_hbm_budget's worst case
     for one card (batch 1, seq 8192, one microbatch, this card's
     memory); (d) the last stage two more steps on the same input, its
     loss falling over the three; ms a stage step (from the second
     step where there is one); (e) K2's launches 2 x 8 forward and 8
     backward a stage step, 32 and 24 forwards for (a) and (b)'s
     boundaries, no stats kernel and no dense route; (f) the dryrun's
     two 8B certificate lines for this card, which phase 12 (d) prints
     (its tracing beside that phase's ranks); (g) K2's forward with lse
     and its backward at the stage's call [1, 8192, 32/8, 128] causal
     against their plain versions, with device times beside sdpa's and
     the bounds.
Phases 2 and 6 also hold the kernels at ViT's call (128, 197, 12/12, 64,
non-causal), phase 2 at each of phase 13's prefills (1, L, 32/8, 128)
and phase 6 at an ep rank's (1, 2048, 32/8, 128). Phases run
in the order 1-5, 26, 13, 6-8, 16, 9-11, 14, 15, 12, 17, 18, 19, 20, 21,
22, 23, 24, 25; phases 12, 15 and 17-26 print the seconds they took.
The last three lines are a JSON object describing each kernel, the
card's name and power limit again, and the device record.
"""

from __future__ import annotations

import asyncio
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak
# bf16 outputs are held per element to |got - want| <= ATOL + RTOL * |want|:
# both sides round to bf16 once after fp32 sums taken in different orders,
# so they may differ by a rounding step, which is under 2**-7 = 7.8e-3 of
# the value; RTOL allows two, and ATOL covers outputs near zero.
BF16_ATOL = 4e-3
BF16_RTOL = 1.6e-2
FP32_TOL = 1e-4
# The rows' log-sum-exp is fp32 (values of 5 to 10) from the same inputs on
# both sides, summed in another order.
LSE_TOL = 1e-4
# A gradient element is held to |got - want| <= A * max|want| + R * |want|.
# bf16: both sides sum in fp32 from the same bf16 inputs and round once to
# bf16, so they may differ by two rounding steps (R); near zero the fp32
# sums over up to 4 x 2048 terms in another order leave an error that
# scales with the gradient tensor's magnitude, not the element's (A).
BF16_GRAD_RULE = (1e-3, BF16_RTOL)
# fp32: only the order of the sums differs.
FP32_GRAD_RULE = (1e-4, 1e-3)
LR = 3e-4


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    """Least time in ms for work that moves ``nbytes`` at the card's memory
    rate and does ``flops`` at its bf16 peak; the larger one bounds."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(B, L, H, Hkv, D, causal, itemsize=2):
    """Least time for the attention: q, k, v read once and o written once
    at the card's memory rate, against the products this mask needs at
    its bf16 peak; the larger one bounds."""
    nbytes = itemsize * (2 * B * L * H * D + 2 * B * L * Hkv * D)
    pairs = L * (L + 1) // 2 if causal else L * L
    return bound(nbytes, 4 * B * H * D * pairs)


def bwd_bounds(B, L, H, Hkv, D, causal, itemsize=2):
    """Bounds of the whole backward and of each kernel. Per visible (query,
    key) pair and head, each product of the forward's size does 2 D
    operations: the backward needs five (S, dP, dV, dK, dQ), the dK/dV
    kernel's function four (S, dP, dV, dK), the dQ kernel's three
    (S, dP, dQ). Bytes: each tensor the function reads or writes, once;
    the rows' lse and di are fp32 [B, H, L]."""
    pairs = L * (L + 1) // 2 if causal else L * L
    per_product = 2 * B * H * D * pairs
    q_like, kv_like, stat = B * L * H * D, B * L * Hkv * D, 4 * B * H * L
    whole = bound(itemsize * (4 * q_like + 4 * kv_like) + stat,
                  5 * per_product)       # q o dO dq; k v dk dv; lse
    dkdv = bound(itemsize * (2 * q_like + 4 * kv_like) + 2 * stat,
                 4 * per_product)        # q dO; k v dk dv; lse di
    dq = bound(itemsize * (3 * q_like + 2 * kv_like) + 2 * stat,
               3 * per_product)          # q dO dq; k v; lse di
    return whole, dkdv, dq


def hold(got, want, atol, rtol, what):
    """Hold each element to |got - want| <= atol + rtol * |want|; returns
    the max abs error and the worst element's share of its limit."""
    diff = (got.float() - want.float()).abs()
    share = float((diff / (atol + rtol * want.float().abs())).max())
    err = float(diff.max())
    if not share <= 1.0:
        raise AssertionError(f"{what}: max_abs_err {err}, {share} of the "
                             f"limit")
    return err, share


def hold_grad(got, want, rule, what):
    """A gradient against its reference by ``rule`` = (A, R): each element
    within A * max|want| + R * |want|."""
    a, r = rule
    return hold(got, want, a * float(want.float().abs().max()), r, what)


# A profiler window's lead-in on the device: torch.cuda._sleep's spin
# kernel, about 10 ms at the H100's clock, before the recorded calls.
LEAD_IN_CYCLES = 20_000_000
LEAD_IN_KERNEL = "spin_kernel"


def device_profile(fn, reps: int, pad_s: float = 0.0):
    """Run ``fn`` ``reps`` times under torch.profiler; returns the device
    time per rep in ms and the kernels as (ms per rep, calls per rep, name),
    longest first. Ranges that code annotates on the device's timeline
    (``Optimizer.step#AdamW.step``) cover kernels listed on their own and
    are left out. ``pad_s`` of idle host time more stands before and after
    the recorded calls (see PROFILE_RETRY_S)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    # The trace has been seen to start late: a window lost the kernels
    # that ran in its first millisecond or so (all of a first backward call
    # but its last kernel; every kernel of five di reductions; on one
    # machine the first call's di and dK/dV in three windows running). So
    # one warm-up call is traced and dropped, the recorded reps start 50 ms
    # of idle host time after the record step begins, and behind a spin
    # kernel of LEAD_IN_CYCLES on the device, which is left out below.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.05 + pad_s)
        torch.cuda._sleep(LEAD_IN_CYCLES)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    kernels = sorted(((e.self_device_time_total / reps / 1e3,
                       e.count / reps, e.key)
                      for e in device if LEAD_IN_KERNEL not in e.key),
                     reverse=True)
    if not kernels:
        log(f"profiler window with a pad of {pad_s} s held no recorded "
            f"kernel; its lead-in kernel was "
            f"{'traced' if device else 'not traced either'}")
    return sum(k[0] for k in kernels), kernels


def _two_windows(measure, what: str):
    """``measure()`` (a tuple of ms) over two profiler windows, the longer
    of the two for each entry: the profiler has been seen to return a
    window's trace without some of the kernels that ran in it, which only
    ever shortens a window. A disagreement of more than 10% is logged."""
    first, second = measure(), measure()
    if any(max(a, b) > 1.1 * min(a, b) for a, b in zip(first, second)):
        log(f"profiler windows disagree on {what}: {first} and {second} "
            f"ms; the longer is taken")
    return tuple(max(a, b) for a, b in zip(first, second))


# Windows a reading may take before it raises. Even with the warm-up call
# and the wait, a window has been seen to lose kernels now and then (all
# of five backward calls but the last dQ, once in a whole run), to lose
# the first kernels of window after window on some machines (pads up to
# 1 s, whole at 2 s), and, minutes into the run, to hold no kernel at all
# window after window (phase 9's first readings, in four whole runs of
# eight). One explanation, not confirmed: the trace keeps only what falls
# inside its window by the host's clock, so a short window loses its
# kernels once the device's timestamps have drifted from it by more than
# the idle time around them. So each retry doubles a pad of idle host time
# around the recorded calls, from PROFILE_RETRY_S.
PROFILE_TRIES = 8
PROFILE_RETRY_S = 0.25
# Lead-ins device_ms may try, each four times the last, from
# LEAD_IN_CYCLES.
QUEUE_TRIES = 4


def device_ms(fn, reps: int, floor_ms: float = 0.0):
    """Device time per call of ``fn``, without the host's gaps between
    launches that CUDA events around a run of short calls also count:
    the ``reps`` calls are queued behind a spin kernel (the lead-in), and
    CUDA events after the lead-in and after the last call time them. A
    reading counts only if the lead-in was still running when the host
    had queued every call (the start event not yet reached), so the card
    ran them back to back; otherwise the lead-in is made four times
    longer, up to QUEUE_TRIES readings, and then the reading is None ("not
    measured": a call that waits on the card itself cannot be queued).
    No profiler window is involved, so no kernel can be left out. A
    reading below ``floor_ms``, the call's roofline bound where it has
    one, cannot be right and raises."""
    fn()
    torch.cuda.synchronize()
    cycles = LEAD_IN_CYCLES
    for _ in range(QUEUE_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            ms = start.elapsed_time(end) / reps
            if not ms >= floor_ms:
                raise AssertionError(f"device time {ms} ms per call, below "
                                     f"its bound {floor_ms} ms")
            return ms
        log(f"the card reached the calls before the host had queued them "
            f"all behind a lead-in of {cycles} cycles; lengthening it")
        cycles *= 4
    log(f"device time not measured: {reps} calls could not be queued "
        f"ahead of the card")
    return None


def profiled_kernels_ms(fn, reps: int, names):
    """Device ms per rep of each kernel in ``names``, each launched once a
    call of ``fn``, over ``reps`` runs of ``fn`` under torch.profiler, the
    longer of two windows (``_two_windows``). A window whose trace does not
    show each kernel ``reps`` times is profiled again, up to PROFILE_TRIES
    windows, each retry logged with the window's kernels; if none shows
    them all it raises, so a kernel the profiler dropped from a window
    never gives a short reading."""
    def launches(kernels):
        return [round(sum(n * reps for _, n, key in kernels if name in key))
                for name in names]

    def measure():
        pad = 0.0
        for _ in range(PROFILE_TRIES):
            _, kernels = device_profile(fn, reps, pad)
            if launches(kernels) == [reps] * len(names):
                return tuple(kernel_ms(kernels, n) for n in names)
            log(f"profiler trace with a pad of {pad} s shows "
                f"{launches(kernels)} launches of {names} in {reps} calls; "
                f"profiling again. Its kernels:")
            log_top(kernels, 12)
            pad = max(PROFILE_RETRY_S, 2 * pad)
        raise AssertionError(
            f"profiler trace shows {launches(kernels)} launches of {names} "
            f"in {reps} calls, {PROFILE_TRIES} windows running")

    return _two_windows(measure, str(names))


def kernel_ms(kernels, name: str) -> float:
    """Device ms per rep of the kernel whose name contains ``name``."""
    found = [t for t, _, key in kernels if name in key]
    if len(found) != 1:
        raise AssertionError(f"profiler shows {len(found)} kernels named "
                             f"{name}")
    return found[0]


def log_top(kernels, n=10):
    for t, calls, name in kernels[:n]:
        log(f"  {t} ms/step in {calls} calls: {name[:100]}")


# Each kernel's route, by dtype, for the kernels line.
ROUTES = {
    "flash_fwd": "bf16: wgmma tensor-core tiles fed by cp.async "
                 "(csrc/flash_tc.cuh); fp32: CUDA cores",
    "flash_bwd": "bf16: wgmma tensor-core tiles fed by cp.async "
                 "(csrc/flash_tc.cuh, csrc/flash_tc_bwd.cuh), P and dS as "
                 "bf16 hi + lo; fp32: CUDA cores",
    "flash_stats": "bf16: wgmma tensor-core tiles fed by cp.async "
                   "(csrc/flash_tc.cuh), P V as bf16 p_hi + p_lo; fp32: "
                   "CUDA cores",
}
# The bf16 kernels that must run on the tensor cores.
TENSOR_CORE_KERNELS = ("flash_fwd_tc_kernel", "flash_stats_tc_kernel",
                       "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")


def _short_name(mangled: str) -> str:
    """``flash_fwd_tc_kernel<64>`` from a kernel's mangled name."""
    found = re.search(r"\d+(flash_\w+?kernel)I(.*?)EEv", mangled)
    if not found:
        return mangled
    args = [{"13__nv_bfloat16": "bf16", "f": "float"}.get(a.group(0))
            or a.group(1) for a in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f",
                                               found.group(2))]
    return f"{found.group(1)}<{','.join(args)}>"


def kernel_report(libs):
    """Per kernel of each built library: ptxas's registers and spill
    bytes, and the HGMMA instructions in its SASS (``cuobjdump -sass``).
    Raises if a bf16 tensor-core kernel has no HGMMA or spills."""
    from torch.utils.cpp_extension import CUDA_HOME

    report = {}
    for lib in libs:
        name = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                name = _short_name(found.group(1))
                report[name] = {}
            elif name and "spill stores" in line:
                report[name]["spill_bytes"] = sum(
                    int(n) for n in re.findall(r"(\d+) bytes spill", line))
            elif name and "Used" in line and "registers" in line:
                report[name]["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
        sass = subprocess.run(
            [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
            capture_output=True, text=True, check=True).stdout
        name = None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                name = _short_name(found.group(1))
                report.setdefault(name, {})["hgmma"] = 0
            elif name and "HGMMA" in line:
                report[name]["hgmma"] += 1
    for name, rec in sorted(report.items()):
        log(f"kernel {name}: {json.dumps(rec)}")
    for name, rec in report.items():
        if name.startswith(TENSOR_CORE_KERNELS) and not (
                rec.get("hgmma", 0) > 0 and rec.get("spill_bytes") == 0):
            raise AssertionError(f"{name} is not a tensor-core kernel "
                                 f"without spills: {rec}")
    if not all(any(n.startswith(k) for n in report)
               for k in TENSOR_CORE_KERNELS):
        raise AssertionError(f"a tensor-core kernel is missing from "
                             f"{sorted(report)}")
    return report


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def check_kernel(attention, gen):
    """Kernel vs plain version at the serving shapes; returns the rows."""
    import torch.nn.functional as F

    shapes = [  # (B, L, H, Hkv, D, causal)
        (1, 16, 32, 8, 128, True), (1, 64, 32, 8, 128, True),
        (1, 256, 32, 8, 128, True), (1, 1024, 32, 8, 128, True),
        (1, 200, 32, 8, 128, True), (1, 256, 32, 8, 64, True),
        (1, 256, 32, 8, 128, False), (2, 256, 32, 8, 128, True),
        (128, 197, 12, 12, 64, False),  # ViT-B/16: ragged, full, H = Hkv
    ]
    shapes += [s for s in ((1, n, 32, 8, 128, True)  # Mixtral's prefills
                           for n in MIXTRAL_PROMPTS) if s not in shapes]
    rows = []
    for B, L, H, Hkv, D, causal in shapes:
        q = torch.randn(B, L, H, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, L, Hkv, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, L, Hkv, D, generator=gen, device="cuda").bfloat16()
        got = attention.flash_attention(q, k, v, causal=causal)
        got_o, got_lse = attention.flash_attention_fwd(q, k, v, causal)
        want, want_lse = attention.flash_attention_plain(
            q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        where = f"flash_fwd at B={B} L={L} D={D} causal={causal}"
        # worst share of the per-element limit; above 1 fails
        err, worst = hold(got, want, BF16_ATOL, BF16_RTOL, where)
        lse_err, _ = hold(got_lse, want_lse, LSE_TOL, 0.0, where + " lse")
        if not torch.equal(got_o, got):
            raise AssertionError(f"{where}: writing lse changed o")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(lambda: attention.flash_attention(q, k, v, causal),
                     20)
        plain_ms = time_ms(
            lambda: attention.flash_attention_plain(q, k, v, causal), 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        bound_ms, bound_by = attention_bound(B, L, H, Hkv, D, causal)
        row = dict(B=B, L=L, H=H, Hkv=Hkv, D=D, causal=causal,
                   max_abs_err=err, share_of_limit=worst, atol=BF16_ATOL,
                   rtol=BF16_RTOL, lse_max_abs_err=lse_err, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        if L == 1024:  # the prefill of the serving main path
            row["device_ms"] = device_ms(
                lambda: attention.flash_attention(q, k, v, causal), 20,
                bound_ms)
            row["library_device_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), 20,
                bound_ms)
        rows.append(row)
        log("kernel_check", json.dumps(row))
    # fp32 inputs take the same kernel in its fp32 instantiation.
    q, k, v = (torch.randn(1, 200, 4, 64, generator=gen, device="cuda")
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    err, _ = hold(attention.flash_attention(q, k, v, True),
                  attention.flash_attention_plain(q, k, v, True),
                  FP32_TOL, 0.0, "fp32 flash kernel")
    log(f"kernel_check fp32 L=200 D=64 GQA: max_abs_err={err} "
        f"tol={FP32_TOL}")
    return rows


def _tree_map(fn, tree):
    """A tree of dicts and lists with ``fn`` applied to each leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _host_copy(params):
    """A copy of a parameter tree on the CPU, sharing no storage."""
    return _tree_map(lambda t: t.detach().to("cpu", copy=True), params)


def check_small_model(models, gen):
    """fp32 on the card against the plain path on the CPU."""
    cfg = models.LlamaConfig(vocab_size=512, d_model=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=512,
                             dtype=torch.float32)
    params = models.init_params(cfg, gen, device="cuda")
    cpu_params = _host_copy(params)
    tokens = torch.randint(0, 512, (2, 100), generator=gen, device="cuda")
    got = models.forward(params, tokens, cfg)
    want = models.forward(cpu_params, tokens.cpu(), cfg)
    err = float((got.cpu() - want).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"small model logits differ from the CPU "
                             f"path by {err}")
    prompts = {"a": [1, 2, 3, 4], "b": list(range(10, 30)), "c": [7] * 70}
    eng = models.GenerationEngine(params, cfg, max_slots=2, max_len=128)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_new_tokens=10)
    out = eng.run_to_completion()
    for rid, p in prompts.items():
        ref = models.generate_greedy(params, torch.tensor([p], device="cuda"),
                                     cfg, max_new=10)[0].tolist()
        if out[rid] != ref:
            raise AssertionError(f"engine tokens {out[rid]} != greedy {ref}")
    log(f"small_model fp32: logits max_abs_err vs CPU plain path={err} "
        f"(tol 1e-3); engine tokens == generate_greedy for "
        f"{len(prompts)} prompts")


# test_paged_matches_greedy's four requests: (prompt, new tokens)
PAGED_REQS = {"a": ([1, 2, 3, 4], 12), "b": ([7, 8], 5),
              "c": ([10, 11, 12, 13, 14, 15], 9), "d": ([20, 21], 7)}


def _paged_run(models, params, cfg, reqs, device="cuda", **kw):
    eng = models.PagedEngine(params, cfg, device=device, **kw)
    for rid, (p, n) in reqs.items():
        eng.submit(rid, p, max_new_tokens=n)
    return eng.run_to_completion(), eng


def check_small_paged_and_spec(models, gen):
    """Phase 3, the paged engine and speculative decoding on a small fp32
    model on the card: PagedEngine tokens equal generate_greedy's (a roomy
    pool, then one small enough to preempt), a prefix-cache hit reproduces
    its cold run, int8 pages agree with the same engine on the CPU at >= 0.6
    (the JAX package's rule), and speculative tokens equal
    generate_greedy's with a random weak draft and with truncated_draft(.,
    1), under torch.cuda.set_sync_debug_mode("error") outside the reads
    that speculative._device_fetch makes."""
    from ray_tpu_torch.models import speculative

    cfg = models.LlamaConfig(vocab_size=512, d_model=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=512,
                             dtype=torch.float32)
    params = models.init_params(cfg, gen, device="cuda")

    def greedy(prompt, n):
        return models.generate_greedy(
            params, torch.tensor([prompt], device="cuda"), cfg,
            max_new=n)[0].tolist()

    want = {rid: greedy(p, n) for rid, (p, n) in PAGED_REQS.items()}
    for kw in (dict(max_slots=3, num_pages=24, page_size=8, max_len=64),
               dict(max_slots=3, num_pages=6, page_size=4, max_len=32)):
        got, eng = _paged_run(models, params, cfg, PAGED_REQS, **kw)
        if got != want:
            raise AssertionError(f"paged tokens {got} != greedy {want} "
                                 f"({kw})")
        if (eng.preemptions > 0) != (kw["num_pages"] == 6):
            raise AssertionError(f"{eng.preemptions} preemptions with {kw}")
        log(f"small_model paged {kw}: tokens == generate_greedy for "
            f"{len(got)} requests; {eng.preemptions} preemptions")
    prefix = list(range(100, 112))  # 3 full pages of 4
    eng = models.PagedEngine(params, cfg, max_slots=2, num_pages=32,
                             page_size=4, max_len=64,
                             enable_prefix_cache=True, device="cuda")
    runs = []
    for rid in ("cold", "hit"):
        eng.submit(rid, prefix + [20], max_new_tokens=8)
        runs.append(eng.run_to_completion()[rid])
    if runs[0] != runs[1] or runs[0] != greedy(prefix + [20], 8) or \
            (eng.prefix_hits, eng.prefix_misses) != (1, 1):
        raise AssertionError(f"prefix cache: cold {runs[0]}, hit {runs[1]}"
                             f", hits {eng.prefix_hits}")
    log(f"small_model paged prefix cache: the hit reproduces the cold run "
        f"and generate_greedy ({runs[0]})")
    int8 = dict(max_slots=2, num_pages=24, page_size=4, max_len=64,
                kv_dtype="int8")
    card, eng = _paged_run(models, params, cfg, PAGED_REQS, **int8)
    host, _ = _paged_run(models, _host_copy(params), cfg, PAGED_REQS,
                         device="cpu", **int8)
    for rid, (_, n) in PAGED_REQS.items():
        agree = sum(a == b for a, b in zip(card[rid], host[rid])) / n
        if len(card[rid]) != n or not agree >= 0.6 or \
                eng.pools_k[0].dtype != torch.int8:
            raise AssertionError(f"int8 KV {rid}: {card[rid]} against the "
                                 f"CPU's {host[rid]}")
    log(f"small_model paged int8 KV: card {card} CPU {host}")

    dcfg = models.LlamaConfig(vocab_size=512, d_model=128, n_layers=1,
                              n_heads=2, n_kv_heads=1, d_ff=256,
                              dtype=torch.float32)
    drafts = {"weak": (models.init_params(dcfg, gen, device="cuda"), dcfg),
              "truncated": models.truncated_draft(params, cfg, 1)}
    prompt = torch.randint(0, 512, (1, 6), generator=gen, device="cuda")
    ref = models.generate_greedy(params, prompt, cfg, max_new=20).cpu()
    real = speculative._device_fetch
    reads = []

    def sanctioned(t):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(t.shape)
            return real(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    for name, (dparams, dc) in drafts.items():
        for k in (1, 4):
            reads.clear()
            speculative._device_fetch = sanctioned
            torch.cuda.set_sync_debug_mode("error")
            try:
                out, stats = models.generate_speculative(
                    params, dparams, prompt, cfg, dc, max_new=20, k=k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                speculative._device_fetch = real
            if out.tolist() != ref.tolist() or not \
                    len(reads) == stats["host_fetches"] == stats["rounds"] + 1:
                raise AssertionError(f"speculative {name} k={k}: {out} != "
                                     f"{ref}, or reads {len(reads)} against "
                                     f"{stats}")
            log(f"small_model speculative {name} draft k={k} under the sync "
                f"guard: tokens == generate_greedy; {json.dumps(stats)}")


def check_debug_routes(models, parallel, attention, gen):
    """Phase 3, shapes the kernels decline: LLAMA_DEBUG (head_dim 16, fp32)
    on the card, where flash_attention takes the dense route, against the
    plain path on the CPU: logits at FP32_TOL, one loss and backward
    (every gradient by FP32_GRAD_RULE), the same through the sp = 4 ring
    whose auto gate takes the dense block step, and engine tokens against
    generate_greedy on the CPU. dense_routes must rise and no kernel may
    launch."""
    cfg = models.LLAMA_DEBUG
    params = models.init_params(cfg, gen, device="cuda")
    cpu_params = _host_copy(params)
    leaves, cpu_leaves = (models.trainable(params),
                          models.trainable(cpu_params))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    before = {c: getattr(attention, c) for c in COUNTERS + ("dense_routes",)}
    with torch.no_grad():
        err = hold(models.forward(params, tokens, cfg).cpu(),
                   models.forward(cpu_params, tokens.cpu(), cfg),
                   FP32_TOL, FP32_TOL, "LLAMA_DEBUG logits")[0]
    mesh = {d: parallel.make_mesh(parallel.MeshSpec(sp=4), device=d)
            for d in ("cuda", "cpu")}
    for name, attn in (("flash_attention", {"cuda": None, "cpu": None}),
                       ("sp=4 ring auto", {d: parallel.make_ring_attention(
                           m) for d, m in mesh.items()})):
        losses = {}
        for dev, tree, ls, tok in (("cuda", params, leaves, tokens),
                                   ("cpu", cpu_params, cpu_leaves,
                                    tokens.cpu())):
            for t in ls:
                t.grad = None
            loss = models.loss_fn(tree, {"tokens": tok}, cfg, remat=False,
                                  attn_impl=attn[dev])
            loss.backward()
            losses[dev] = loss.item()
        if not abs(losses["cuda"] - losses["cpu"]) <= FP32_TOL * \
                abs(losses["cpu"]):
            raise AssertionError(f"LLAMA_DEBUG {name} loss {losses}")
        worst = max(hold_grad(g.grad.cpu(), w.grad, FP32_GRAD_RULE,
                              f"LLAMA_DEBUG {name} grad {i}")[1]
                    for i, (g, w) in enumerate(zip(leaves, cpu_leaves)))
        log(f"LLAMA_DEBUG (head_dim {cfg.head_dim}) {name}: loss "
            f"{losses['cuda']} (CPU {losses['cpu']}), worst gradient element "
            f"{worst} of rule {FP32_GRAD_RULE}")
    prompts = {"a": [1, 2, 3, 4], "b": list(range(10, 50))}
    eng = models.GenerationEngine(params, cfg, max_slots=2, max_len=128,
                                  device="cuda")
    for rid, p in prompts.items():
        eng.submit(rid, p, max_new_tokens=8)
    out = eng.run_to_completion()
    for rid, p in prompts.items():
        ref = models.generate_greedy(cpu_params, torch.tensor([p]), cfg,
                                     max_new=8)[0].tolist()
        if out[rid] != ref:
            raise AssertionError(f"LLAMA_DEBUG engine {out[rid]} != CPU {ref}")
    after = {c: getattr(attention, c) for c in before}
    routed = after.pop("dense_routes") - before.pop("dense_routes")
    if routed <= 0 or after != before:
        raise AssertionError(f"LLAMA_DEBUG: {routed} dense routes, kernel "
                             f"launches {before} -> {after}")
    log(f"LLAMA_DEBUG on the card: logits max_abs_err {err} (tol "
        f"{FP32_TOL}), engine tokens == CPU greedy; {routed} dense routes, "
        f"no kernel launched")


# Greedy tokens of two bf16 paths (the dense cache against the paged one,
# the flash kernel's prefill against the cache attention's, one decode row
# against k + 1 verify rows) are held to each other up to the first step
# whose reference top-two logits lie within NEAR_TIE_ULPS bf16 steps of the
# top logit. The paths round K/V, attention outputs and the residual stream
# to bf16 at different places through 32 layers, which moves a bf16 logit by
# a few of its own steps, so at such a step either token may win, and from
# there the two sequences part.
NEAR_TIE_ULPS = 4


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def near_tie_agreement(models, params, cfg, prompt, want, got, what):
    """How many leading tokens of ``got`` equal ``want``, the reference
    path's greedy tokens after ``prompt``; both must be full length. Where
    they part, the reference's logits at that step (one forward over
    prompt + want up to it) must have their top two within NEAR_TIE_ULPS
    bf16 steps. Returns (agreement length, that margin or None)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tokens, want {len(want)}")
    n = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             len(want))
    if n == len(want):
        return n, None
    with torch.no_grad():
        seq = torch.tensor([prompt + want[:n]], device="cuda")
        top = models.forward(params, seq, cfg)[0, -1].float().topk(2)
    first, second = top.values.tolist()
    limit = NEAR_TIE_ULPS * bf16_step(first)
    if not first - second <= limit:
        raise AssertionError(f"{what}: parts from the reference at step {n} "
                             f"where its top two logits {first}, {second} "
                             f"differ by more than {limit}")
    return n, first - second


def serve_paged_and_speculative(models, attention, params, cfg, requests,
                                dense_outs):
    """Phase 4b, the slice's main path at Llama-3-8B full width and depth
    (phase 4's weights): a paged LLMServer (page 16, 129 pages: half the
    dense cache's 256 plus the scratch page, prefix cache on) answers phase
    4's six requests, then two that share a 256-token prefix (the second a
    prefix hit). The forward kernel's launch count is reset just before and
    read just after, and must equal n_layers x cold prefills: a hit runs
    its suffix through the cache attention. The six answers are held to
    phase 4's dense tokens and the two to generate_greedy's by the near-tie
    rule. The six again through int8 pages, their agreement logged. Then a
    speculative server (truncated_draft(., 4), k = 4) answers prompts of 40
    and 200 tokens with 32 new tokens each: launches 2 x (n_layers + 4),
    one target and one draft prefill each, held to generate_greedy by the
    same rule, timed beside it. Returns the paged server and the counts."""
    from ray_tpu_torch.serve import LLMServer

    gen = torch.Generator().manual_seed(3)
    prefix = torch.randint(0, cfg.vocab_size, (256,), generator=gen).tolist()
    shared = [{"prompt": prefix + torch.randint(
        0, cfg.vocab_size, (n,), generator=gen).tolist(),
        "max_new_tokens": 16} for n in (10, 5)]
    pages = dict(max_slots=4, max_len=1024, kv_cache="paged", page_size=16,
                 num_pages=129, enable_prefix_cache=True, device="cuda")
    paged = LLMServer(lambda: (params, cfg), **pages)
    eng = paged.engine

    # ---- the main path: counts reset just before, read just after
    attention.launches = 0
    t0 = time.perf_counter()
    outs, _ = asyncio.run(serve_requests(paged, requests))
    shared_outs = [asyncio.run(paged(body))["tokens"] for body in shared]
    torch.cuda.synchronize()
    paged_s = time.perf_counter() - t0
    paged_launches = attention.launches
    # ---- end of the main path

    cold = eng.prefills - eng.prefix_hits
    expected = cfg.n_layers * cold
    if eng.prefix_hits != 1 or cold != len(requests) + 1 or \
            eng.preemptions or paged_launches != expected:
        raise AssertionError(
            f"paged server: {eng.prefix_hits} prefix hits, {cold} cold "
            f"prefills, {eng.preemptions} preemptions; flash_fwd launched "
            f"{paged_launches} times, expected {expected}")
    n_tok = sum(map(len, outs)) + sum(map(len, shared_outs))
    log(f"serve paged LLAMA3_8B: {len(requests)} + 2 requests, {n_tok} "
        f"tokens in {paged_s} s = {n_tok / paged_s} tokens/s; prefills "
        f"{eng.prefills} ({eng.prefix_hits} prefix hit); flash_fwd "
        f"launches {paged_launches} == {cfg.n_layers} x {cold} cold "
        f"prefills; {len(eng.free_pages)} free pages")
    agree = [near_tie_agreement(models, params, cfg, body["prompt"], want,
                                got, f"paged request {i}")
             for i, (body, want, got) in enumerate(zip(requests, dense_outs,
                                                       outs))]
    for body, got in zip(shared, shared_outs):
        want = models.generate_greedy(
            params, torch.tensor([body["prompt"]], device="cuda"), cfg,
            max_new=16)[0].tolist()
        agree.append(near_tie_agreement(models, params, cfg, body["prompt"],
                                        want, got, "prefix request"))
    log(f"paged against dense (six) and generate_greedy (prefix pair): "
        f"agreement lengths and near-tie margins {agree} (rule: "
        f"{NEAR_TIE_ULPS} bf16 steps)")

    int8 = LLMServer(lambda: (params, cfg), kv_dtype="int8", **pages)
    int8_outs, _ = asyncio.run(serve_requests(int8, requests))
    if int8.engine.pools_k[0].dtype != torch.int8 or \
            [len(t) for t in int8_outs] != [len(t) for t in outs]:
        raise AssertionError("int8 KV server: pools not int8 or responses "
                             "short")
    share = [sum(a == b for a, b in zip(x, y)) / len(x)
             for x, y in zip(outs, int8_outs)]
    lead = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
            for x, y in zip(outs, int8_outs)]
    log(f"serve paged int8 KV: full length; tokens equal to bf16 paged "
        f"{share} of the time, leading agreement {lead}")
    del int8, int8_outs

    spec = LLMServer(lambda: (params, cfg), max_slots=4, max_len=1024,
                     device="cuda", draft_factory=lambda p, c: models.truncated_draft(p, c,
                                                                       4),
                     draft_k=4)
    _, _, dparams, dcfg, k = spec._spec
    bodies = [{"prompt": requests[i]["prompt"], "max_new_tokens": 32,
               "speculative": True} for i in (1, 2)]  # 40 and 200 tokens
    # ---- the main path: counts reset just before, read just after
    attention.launches = 0
    answers = [asyncio.run(spec(body)) for body in bodies]
    torch.cuda.synchronize()
    spec_launches = attention.launches
    # ---- end of the main path
    if spec_launches != len(bodies) * (cfg.n_layers + dcfg.n_layers):
        raise AssertionError(f"speculative server: flash_fwd launched "
                             f"{spec_launches} times, expected "
                             f"{len(bodies)} x ({cfg.n_layers} + "
                             f"{dcfg.n_layers})")
    rows = []
    for body, ans in zip(bodies, answers):
        prompt = torch.tensor([body["prompt"]], device="cuda")
        times = {}
        for name, fn in (
                ("greedy", lambda: models.generate_greedy(params, prompt, cfg,
                                                          max_new=32)),
                ("speculative", lambda: models.generate_speculative(
                    params, dparams, prompt, cfg, dcfg, max_new=32, k=k))):
            fn()  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3 / 32
            if name == "greedy":
                want = res[0].tolist()
        n, margin = near_tie_agreement(models, params, cfg, body["prompt"],
                                       want, ans["tokens"],
                                       "speculative request")
        stats = ans["speculative_stats"]
        rows.append(dict(prompt_len=len(body["prompt"]), agreement=n,
                         margin=margin, ms_per_token=times["speculative"],
                         greedy_ms_per_token=times["greedy"], **stats))
        log("serve speculative LLAMA3_8B", json.dumps(rows[-1]))
    log(f"speculative server: flash_fwd launches {spec_launches} == "
        f"{len(bodies)} x ({cfg.n_layers} + {dcfg.n_layers}); stats "
        f"{json.dumps(spec._admin({'_admin': 'stats'}))}")
    del spec
    return paged, {"serve_paged": paged_launches,
                   "serve_speculative": spec_launches}


def where_time_goes(models, params, cfg, server, tokens, paged_server):
    """After the main paths: the warm forward time, and a profile of decode
    steps with every slot busy (kernel time by name, device busy share),
    on the dense engine and on the paged one."""
    with torch.no_grad():
        fwd_ms = time_ms(lambda: models.forward(params, tokens, cfg), 3)
    log(f"forward LLAMA3_8B [1, 1024] warm: {fwd_ms} ms per call")
    for name, eng in (("decode", server.engine),
                      ("decode paged", paged_server.engine)):
        decode_profile(eng, cfg, name)


def decode_profile(eng, cfg, name):
    gen = torch.Generator().manual_seed(2)
    for i in range(eng.S):
        eng.submit(f"profile{i}", torch.randint(
            0, cfg.vocab_size, (200,), generator=gen).tolist(),
            max_new_tokens=48)
    for _ in range(4):  # the admitting step (4 prefills), then warm steps
        eng.step()
    torch.cuda.synchronize()
    steps, profiled = 16, 8
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    busy_ms, kernels = device_profile(eng.step, profiled)
    log(f"{name}: {eng.S} slots at ~200 tokens of context: "
        f"{step_s * 1e3} ms/step over {steps} steps = {eng.S / step_s} "
        f"tokens/s; over {profiled} profiled steps the device ran "
        f"{busy_ms} ms/step, {busy_ms / 1e3 / step_s} of the unprofiled "
        f"step, in {sum(n for _, n, _ in kernels)} kernels/step")
    log_top(kernels)
    eng.run_to_completion()


# Phase 13: Mixtral-8x7B's widths, 16 of its 32 layers (all 32 take 93.4
# GB in bf16, more than the card holds); prompts and new tokens a request.
MIXTRAL_SERVE_LAYERS = 16
MIXTRAL_PROMPTS = (40, 200, 1024)
MIXTRAL_NEW = 32
# The cached decode against a teacher-forced forward over the same tokens
# that takes, at every position and layer, the experts the decode took:
# the two then compute one function and differ only where they round to
# bf16, so every layer's router probabilities at every position (prefill
# rows and steps) agree to ROUTER_DRIFT, the decode's experts are the
# reference's top k but where the reference's k-th probability passes the
# least of them by at most ROUTER_TIE (a near tie rounding may flip), and
# at every step the decode's token is the reference's argmax or within
# NEAR_TIE_ULPS bf16 steps of it. Read on an H100 80GB HBM3 (700 W): the
# three prompts drift 9.9e-3 to 1.10e-2 and take ties of up to 6.2e-3; a
# decode whose layer 8 loses its cache writes (planted_cache_fault) drifts
# 6.8e-2 and takes a tie of 4.5e-2.
ROUTER_DRIFT = 2.5e-2
ROUTER_TIE = 1.5e-2


class Refused(AssertionError):
    """A hold's verdict that an output parts from its reference."""


def router_rows(models, run):
    """Run ``run()`` under no_grad and return its result and, for each
    dense MoE call in order, the router probabilities [T, E] of its input's
    rows (a decode loop's calls: each layer of the prefill, T the prompt's
    length, then each layer of each step, T = 1)."""
    from ray_tpu_torch.parallel import moe

    rows = []
    real = models.mixtral.moe_ffn_dense

    def record(x, router, experts, k):
        rows.append(moe.router_probs(x, router)[0])
        return real(x, router, experts, k)

    models.mixtral.moe_ffn_dense = record
    try:
        with torch.no_grad():
            out = run()
    finally:
        models.mixtral.moe_ffn_dense = real
    return out, rows


def forced_forward(models, params, cfg, seq, experts):
    """A teacher-forced forward over ``seq`` [1, T] whose MoE routes each
    position of layer i to ``experts[i]`` [T, k], its gates renormalised
    from its own probabilities, as ``top_k_gates`` does. Returns the
    logits [T, V] and each layer's router probabilities [T, E]."""
    from ray_tpu_torch.parallel import moe

    real, probs = moe.top_k_gates, []

    def forced(p, k):
        idx = experts[len(probs)][None]
        probs.append(p[0])
        vals = p.gather(-1, idx)
        return vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), idx

    moe.top_k_gates = forced
    try:
        with torch.no_grad():
            logits, _ = models.mixtral.forward(params, seq, cfg)
    finally:
        moe.top_k_gates = real
    return logits[0], probs


def moe_agreement(models, params, cfg, prompt, got, what):
    """Phase 13's hold of ``got``, the cached greedy tokens after
    ``prompt``: the decode run again (the same shapes, so the same bits: it
    must give ``got`` again) records each layer's router probabilities and
    experts at every position, and a forced_forward over prompt + got[:-1]
    with those experts is the reference (see ROUTER_DRIFT). Raises Refused
    where the decode parts from it; returns the readings: the largest
    drift, the largest tie taken and how many, the steps whose token is
    not the reference's argmax and the largest margin among them."""
    from ray_tpu_torch.parallel import moe

    P, L, k = len(prompt), cfg.n_layers, cfg.top_k
    again, rows = router_rows(models, lambda: models.mixtral_generate_greedy(
        params, torch.tensor([prompt], device="cuda"), cfg,
        max_new=len(got)))
    if again[0].tolist() != got:
        raise AssertionError(f"{what}: a second decode gave other tokens")
    probs = [torch.cat(rows[i::L]) for i in range(L)]  # [P + len - 1, E]
    experts = [moe.top_k_gates(p, k)[1] for p in probs]
    logits, ref = forced_forward(models, params, cfg, torch.tensor(
        [prompt + got[:-1]], device="cuda"), experts)
    drift = max(float((a - b).abs().max()) for a, b in zip(ref, probs))
    ties = [r.sort(-1, descending=True).values[:, k - 1]
            - r.gather(-1, e).amin(-1) for r, e in zip(ref, experts)]
    tie = max(float(t.max()) for t in ties)
    n_ties = sum(int((t > 0).sum()) for t in ties)
    step = logits[P - 1:].float()
    top = step.amax(-1).tolist()
    mine = step.gather(-1, torch.tensor(got, device="cuda")[:, None])
    margins = [(s, t - m) for s, (t, m) in
               enumerate(zip(top, mine[:, 0].tolist())) if t > m]
    over = [(s, m) for s, m in margins
            if m > NEAR_TIE_ULPS * bf16_step(top[s])]
    reading = dict(drift=drift, tie=tie, ties=n_ties,
                   parted=[s for s, _ in margins],
                   margin=max((m for _, m in margins), default=0.0))
    log(f"{what}: against the reference on the decode's experts: "
        f"{json.dumps(reading)} (ROUTER_DRIFT {ROUTER_DRIFT}, ROUTER_TIE "
        f"{ROUTER_TIE}, NEAR_TIE_ULPS {NEAR_TIE_ULPS})")
    if not (drift <= ROUTER_DRIFT and tie <= ROUTER_TIE and not over):
        raise Refused(f"{what}: parts from the reference: {reading}, steps "
                      f"beyond a near tie {over}")
    return reading


def planted_cache_fault(models, params, cfg, prompt):
    """moe_agreement's negative control: the greedy tokens after ``prompt``
    from a decode whose layer n_layers // 2 loses each cache write after
    the prefill (a step attends to its own K and V, but later steps find
    zeros there), which moe_agreement must refuse. Returns the refusal."""
    from ray_tpu_torch.models import llama

    real, bad = llama._decode_step, cfg.n_layers // 2

    def lossy(params, tokens, caches, start, cfg, cos, sin, ffn=None):
        if start == 0:
            return real(params, tokens, caches, start, cfg, cos, sin, ffn)
        kept = [c[:, start].clone() for c in caches[bad]]
        logits, caches = real(params, tokens, caches, start, cfg, cos, sin,
                              ffn)
        for c, old in zip(caches[bad], kept):
            c[:, start] = old
        return logits, caches

    what = f"planted fault: layer {bad} loses its cache writes"
    llama._decode_step = lossy
    try:
        with torch.no_grad():
            got = models.mixtral_generate_greedy(
                params, torch.tensor([prompt], device="cuda"), cfg,
                max_new=MIXTRAL_NEW)[0].tolist()
        try:
            moe_agreement(models, params, cfg, prompt, got, what)
        except Refused as refusal:
            return str(refusal)
    finally:
        llama._decode_step = real
    raise AssertionError(f"{what}: moe_agreement took its tokens")


def moe_host_waits(ffn, params, x, cfg):
    """Why five calls of the dense MoE (``ffn`` over every layer) could
    not be queued ahead of the card (C4). One call under
    torch.cuda.set_sync_debug_mode("warn"): the lines whose ops made the
    host wait for the card, and the caching allocator's retries, cudaMalloc
    and cudaFree calls and segments. Then layer calls are queued one by one
    behind a spin kernel of 64 x LEAD_IN_CYCLES (about 0.65 s): the host
    time of each, and how many went in before one waited for the card,
    which a full launch queue makes it do."""
    import traceback
    import warnings

    sites = {}

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost frame of the port's code on the stack
        frames = [f for f in traceback.extract_stack()
                  if "ray_tpu_torch" in f.filename]
        site = (f"{os.path.relpath(frames[-1].filename)}:{frames[-1].lineno}"
                if frames else f"{filename}:{lineno}")
        sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.no_grad():
                for layer in params["layers"]:
                    ffn(layer, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = torch.cuda.memory_stats()
    layers = params["layers"]
    enqueue_ms = []
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda._sleep(64 * LEAD_IN_CYCLES)
        for i in range(5 * len(layers)):
            t0 = time.perf_counter()
            ffn(layers[i % len(layers)], x, cfg)
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    queued = next((i for i, ms in enumerate(enqueue_ms) if ms > 50.0),
                  len(enqueue_ms))
    return {"host_waits": sum(sites.values()), "sites": sites, **{
        k: after.get(k, 0) - before.get(k, 0)
        for k in ("num_alloc_retries", "num_device_alloc",
                  "num_device_free")},
        "segments": [before.get("segment.all.current", 0),
                     after.get("segment.all.current", 0)],
        "layer_calls_queued_before_a_wait": queued,
        "enqueue_ms_median": sorted(enqueue_ms[:queued])[queued // 2]
        if queued else None,
        "longest_enqueue_ms": max(enqueue_ms)}


def serve_mixtral(models, attention):
    """Phase 13, Mixtral serving: MIXTRAL_8X7B's widths at
    MIXTRAL_SERVE_LAYERS layers, random weights from a seed, bf16;
    mixtral_generate_greedy on MIXTRAL_PROMPTS with MIXTRAL_NEW new tokens
    each (the main path: K1 launches n_layers a prefill), the tokens held
    to a teacher-forced forward (moe_agreement); then the prefill and
    decode step timed, the decode step profiled, and the MoE's share of
    its device time. Frees the weights on return."""
    cfg = replace(models.MIXTRAL_8X7B, n_layers=MIXTRAL_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = models.mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(13), device="cuda")
    torch.cuda.synchronize()
    log(f"init Mixtral-8x7B widths, {cfg.n_layers} layers: "
        f"{cfg.param_count()} params ({cfg.active_param_count()} active) in "
        f"{time.perf_counter() - t0} s, "
        f"{torch.cuda.memory_allocated() / 2**30} GiB allocated")
    prompt_gen = torch.Generator().manual_seed(14)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=prompt_gen).tolist()
               for n in MIXTRAL_PROMPTS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts reset just before, read just after
    for c in COUNTERS + ("dense_routes",):
        setattr(attention, c, 0)
    outs, secs = [], []
    for p in prompts:
        t0 = time.perf_counter()
        out = models.mixtral_generate_greedy(
            params, torch.tensor([p], device="cuda"), cfg,
            max_new=MIXTRAL_NEW)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out[0].tolist())
    counts = {c: getattr(attention, c) for c in COUNTERS + ("dense_routes",)}
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    expect = {"launches": cfg.n_layers * len(prompts), "bwd_launches": 0,
              "stats_launches": 0, "dense_routes": 0}
    if counts != expect:
        raise AssertionError(f"Mixtral serving: launches {counts}, expected "
                             f"{expect}")
    for p, got in zip(prompts, outs):
        if len(got) != MIXTRAL_NEW or \
                not all(0 <= t < cfg.vocab_size for t in got):
            raise AssertionError(f"bad Mixtral tokens {got}")
    agree = [moe_agreement(models, params, cfg, p, got,
                           f"Mixtral prompt of {len(p)}")
             for p, got in zip(prompts, outs)]
    log(f"Mixtral serving: prompts {list(MIXTRAL_PROMPTS)}, {MIXTRAL_NEW} "
        f"new tokens each in {secs} s; launches {counts}; peak memory "
        f"{peak / 2**30} GiB")
    refusal = planted_cache_fault(models, params, cfg, prompts[0])
    log(f"Mixtral serving, the hold's negative control refused: {refusal}")

    # Where the time goes: the longest prompt's prefill, then decode steps
    # on its cache.
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.quant import tree_leaves

    prompt = torch.tensor([prompts[-1]], device="cuda")
    ffn = models.mixtral._moe_decode_ffn
    with torch.no_grad():
        prefill_ms = time_ms(lambda: llama._prefill(
            params, prompt, cfg, MIXTRAL_NEW, ffn=ffn), 3)
        logits, caches, L, cos, sin = llama._prefill(
            params, prompt, cfg, MIXTRAL_NEW, ffn=ffn)
        tok = logits[:, -1].argmax(-1)[:, None]

        def step():
            return models.mixtral._decode_step(params, tok, caches, L, cfg,
                                               cos, sin)

        step_ms = time_ms(step, 10)
        busy_ms, kernels = device_profile(step, 5)
        x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator(
            device="cuda").manual_seed(15), device="cuda").to(cfg.dtype)
    waits = moe_host_waits(ffn, params, x, cfg)
    log(f"Mixtral decode, the dense MoE over {cfg.n_layers} layers (C4): "
        f"{json.dumps(waits)}; the decode step launches "
        f"{sum(k[1] for k in kernels)} kernels")
    with torch.no_grad():
        # one call a reading: five calls' launches overflow the card's
        # launch queue (above), so they cannot all be queued ahead of it
        moe_ms = device_ms(lambda: [ffn(layer, x, cfg)
                                    for layer in params["layers"]], 1)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    bound_ms = weights / H100_BYTES_PER_S * 1e3
    moe_share = None if moe_ms is None or not busy_ms else moe_ms / busy_ms
    log(f"Mixtral decode [1, 1] at {L} tokens of context: {step_ms} ms/step "
        f"(bound {bound_ms} ms: {weights / 1e9} GB of weights at "
        f"{H100_BYTES_PER_S / 1e12} TB/s); the device ran {busy_ms} ms, "
        f"{busy_ms / step_ms} of the step; the MoE of its {cfg.n_layers} "
        f"layers {moe_ms} ms of device time, {moe_share} of it; "
        f"prefill [1, {L}] {prefill_ms} ms")
    log_top(kernels)
    out = dict(launches=counts["launches"], seconds=secs, peak_gib=peak /
               2**30, agreement=agree, prefill_ms=prefill_ms,
               decode_ms=step_ms, decode_busy_share=busy_ms / step_ms,
               moe_share=moe_share, decode_bound_ms=bound_ms,
               planted_fault=refusal, moe_host_waits=waits)
    del params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


BWD_SHAPES = [  # (B, L, H, Hkv, D, causal): why
    (4, 2048, 32, 8, 64, True),    # the training shape (LLAMA3_1B)
    (1, 1024, 32, 8, 128, True),   # D = 128
    (1, 200, 32, 8, 64, True),     # ragged L
    (1, 256, 32, 8, 64, False),    # full mask
    (1, 8192, 8, 2, 64, True),     # a Ulysses rank's call: 64-key dK/dV
    (4, 2048, 32, 8, 128, True),   # D = 128 with 128-key dK/dV blocks
    (2, 2048, 16, 4, 64, True),    # a rank's call at fsdp = 2 x tp = 2
    (1, 2048, 32, 8, 64, True),    # a rank's call at fsdp = 4
    (128, 197, 12, 12, 64, False),  # ViT-B/16: ragged, full mask, H = Hkv
    (1, 2048, 32, 8, 128, True),   # Mixtral's call at an ep = 4 rank
]
# Phase 8's tokens, whose rows phases 11, 12 and 16 split.
TRAIN_TOKENS = (4, 2048)


def pipeline_bwd_shapes():
    """K2's calls in phases 16 and 12 (f)/(g): a microbatch's rows of
    TRAIN_TOKENS (split over the batch axes, then into M), LLAMA3_1B's
    32/8 heads of 64 split over tp; the rows BWD_SHAPES lacks."""
    runs = [(dict(pp=LOCKSTEP_PP), m) for m in LOCKSTEP_RUNS.values()]
    runs += [(sizes, micro) for sizes, *_, micro in SHARDED_RUNS.values()
             if micro]
    out = []
    for sizes, m in runs:
        rows = TRAIN_TOKENS[0] // math.prod(
            sizes.get(a, 1) for a in ("dp", "fsdp", "ep")) // m
        tp = sizes.get("tp", 1)
        shape = (rows, TRAIN_TOKENS[1], 32 // tp, 8 // tp, 64, True)
        if shape not in BWD_SHAPES + out:
            out.append(shape)
    return out


def check_bwd(attention, gen):
    """Phase 6: the backward kernels against their plain version, on the
    same inputs (the kernel forward's o and lse feed both), and against
    themselves: a second call must give the same bits. Returns a row per
    shape, the first at the training shape."""
    import torch.nn.functional as F

    rows = []
    for B, L, H, Hkv, D, causal in BWD_SHAPES + pipeline_bwd_shapes():
        q = torch.randn(B, L, H, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, L, Hkv, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, L, Hkv, D, generator=gen, device="cuda").bfloat16()
        do = torch.randn(B, L, H, D, generator=gen, device="cuda").bfloat16()
        where = f"B={B} L={L} D={D} causal={causal}"
        o, lse = attention.flash_attention_fwd(q, k, v, causal)
        want_o, want_lse = attention.flash_attention_plain(
            q, k, v, causal=causal, return_lse=True)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, causal)
        want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   causal=causal)
        torch.cuda.synchronize()
        hold(o, want_o, BF16_ATOL, BF16_RTOL, f"flash_fwd {where}")
        lse_err, _ = hold(lse, want_lse, LSE_TOL, 0.0, f"lse {where}")
        row = dict(B=B, L=L, H=H, Hkv=Hkv, D=D, causal=causal,
                   lse_max_abs_err=lse_err, rule=BF16_GRAD_RULE)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, share = hold_grad(g, w, BF16_GRAD_RULE, f"{name} {where}")
            row[name] = dict(max_abs_err=err, share_of_limit=share,
                             max_abs_want=float(w.float().abs().max()))

        def bwd():
            return attention.flash_attention_bwd(q, k, v, o, lse, do, causal)

        again = bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{where}: two backward calls differ")
        whole, dkdv, dq = bwd_bounds(B, L, H, Hkv, D, causal)
        row["bound_ms"], row["bound_by"] = whole
        row["dkdv_bound_ms"], row["dkdv_bound_by"] = dkdv
        row["dq_bound_ms"], row["dq_bound_by"] = dq
        row["bwd_ms"] = time_ms(bwd, 10)
        row["bwd_device_ms"] = device_ms(bwd, 5, row["bound_ms"])
        row["dkdv_ms"], row["dq_ms"] = profiled_kernels_ms(
            bwd, 5, ("flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel"))
        row["di_ms"] = time_ms(lambda: attention.bwd_di(o, do), 10)
        row["di_device_ms"] = device_ms(lambda: attention.bwd_di(o, do), 5)
        log(f"bwd_di {where}: the plain reduction di = rowsum(o dO) "
            f"{row['di_ms']} ms, device {row['di_device_ms']} ms")
        row["plain_ms"] = time_ms(lambda: attention.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal), 2)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)

        row["library_ms"] = time_ms(
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), 10) - \
            time_ms(sdpa, 10)
        # The backward alone: the graph is built once, then only its
        # gradient runs under the profiler.
        graph = sdpa()
        row["library_device_ms"] = device_ms(
            lambda: torch.autograd.grad(graph, (qt, kt, vt), dot,
                                        retain_graph=True), 5,
            row["bound_ms"])
        del graph
        if not rows:  # the forward with lse at the training shape
            row["fwd_ms"] = time_ms(
                lambda: attention.flash_attention_fwd(q, k, v, causal), 10)
            row["fwd_plain_ms"] = time_ms(
                lambda: attention.flash_attention_plain(
                    q, k, v, causal=causal, return_lse=True), 2)
            def sdpa_fwd():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=True)

            row["fwd_library_ms"] = time_ms(sdpa_fwd, 10)
            row["fwd_bound_ms"], row["fwd_bound_by"] = attention_bound(
                B, L, H, Hkv, D, causal)
            row["fwd_device_ms"] = device_ms(
                lambda: attention.flash_attention_fwd(q, k, v, causal), 10,
                row["fwd_bound_ms"])
            row["fwd_library_device_ms"] = device_ms(sdpa_fwd, 10,
                                                     row["fwd_bound_ms"])
        rows.append(row)
        log("bwd_check", json.dumps(row))
    # fp32 inputs take the fp32 instantiations; q is a slice of a wider
    # buffer and dO a transposed view without a unit-stride head dim, as
    # autograd may hand one over.
    q = torch.randn(1, 200, 4, 128, generator=gen, device="cuda")[..., :64]
    do = torch.randn(1, 200, 64, 4, generator=gen,
                     device="cuda").transpose(2, 3)
    k, v = (torch.randn(1, 200, 2, 64, generator=gen, device="cuda")
            for _ in range(2))
    o, lse = attention.flash_attention_fwd(q, k, v, True)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    errs = [hold_grad(g, w, FP32_GRAD_RULE, f"fp32 {name}")[0]
            for name, g, w in zip(("dq", "dk", "dv"), got, want)]
    log(f"bwd_check fp32 L=200 D=64 GQA, strided q and dO: max_abs_err dq, "
        f"dk, dv = {errs}, rule {FP32_GRAD_RULE}")
    return rows


# The stats kernel's outputs are fp32 on both sides, from the same inputs,
# with sums taken in another order: its o and l are held to
# A * max(1, max|want|) + R * |want| with A = R = 1e-4 (the scores differ
# by a few fp32 steps, which exp carries into each term; the floor of 1 is
# the scale of a single term, for outputs that are all 0), and its m, a
# row max of scores of magnitude up to ~30, to 1e-4 absolute.
STATS_RULE = (1e-4, 1e-4)
STATS_M_TOL = 1e-4
# The ring shard of the main path: LLAMA3_1B at [1, 8192] over sp = 4.
STATS_SHAPE = (1, 2048, 2048, 32, 8, 64)  # B, Lq, Lk, H, Hkv, D


def stats_bound(q, k, v, visible):
    """Least time for the stats step on these inputs: the bytes it must
    move at the card's memory rate, against 4 D operations for each
    visible (query, key) pair of each query head at its bf16 peak. It must
    read visible (its distinct elements: a stride-0 axis is one), write o
    (fp32), m and l, read the q rows that see a key, and read the K/V rows
    up to the largest count among their kv head's rows; a pattern with
    nothing visible reads no q, K or V."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    vis = visible.expand(B, H, Lq).clamp(0, Lk)
    q_rows = int((vis > 0).sum())
    kv_rows = int(vis.reshape(B, Hkv, -1).amax(dim=-1).sum())
    vis_elems = math.prod(n for n, st in zip(visible.shape, visible.stride())
                          if st)
    nbytes = (q_rows * D * q.element_size()
              + kv_rows * D * (k.element_size() + v.element_size())
              + 4 * vis_elems + 4 * B * Lq * H * D + 8 * B * H * Lq)
    return bound(nbytes, 4 * D * float(vis.sum()))


def hold_stats(attention, got, want, visible, where):
    """The kernel's (o, m, l) against the plain version's; rows that see
    no key must carry m == NEG_INF (and o = l = 0). Returns the max abs
    errors of o, m and l."""
    (go, gm, gl), (wo, wm, wl) = got, want
    a, r = STATS_RULE
    err_o = hold(go, wo, a * max(1.0, float(wo.abs().max())), r,
                 f"o {where}")[0]
    err_l = hold(gl, wl, a * max(1.0, float(wl.abs().max())), r,
                 f"l {where}")[0]
    err_m = hold(gm, wm, STATS_M_TOL, 0.0, f"m {where}")[0]
    dark = visible.expand(gm.shape) <= 0
    if dark.any() and not (bool((gm[dark] == attention.NEG_INF).all())
                           and not gl[dark].any()
                           and not go.transpose(1, 2)[dark].any()):
        raise AssertionError(f"{where}: a row that sees no key does not "
                             f"give m == NEG_INF, l == 0, o == 0")
    return err_o, err_m, err_l


def check_stats(attention, gen):
    """Phase 9: the stats kernel against its plain version on the same
    bf16 inputs at the ring shard shape of the main path, for the visible
    patterns a causal ring gives (every key, the diagonal block, none)
    and a ragged one; then D = 128 with Lq != Lk, and fp32 with a stride-0
    visible and a strided q. Returns a row per bf16 case."""
    B, Lq, Lk, H, Hkv, D = STATS_SHAPE
    q = torch.randn(B, Lq, H, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, Lk, Hkv, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, Lk, Hkv, D, generator=gen, device="cuda").bfloat16()
    row_of = {  # the ring's per-row counts, broadcast over B and H
        "all": torch.full((Lq,), Lk, device="cuda"),
        "diagonal": torch.arange(1, Lq + 1, device="cuda"),
        "none": torch.zeros(Lq, device="cuda"),
    }
    patterns = {name: r.int()[None, None].expand(B, H, Lq)
                for name, r in row_of.items()}
    patterns["ragged"] = torch.randint(0, Lk + 1, (B, H, Lq), generator=gen,
                                       device="cuda", dtype=torch.int32)
    rows = []
    for name, vis in patterns.items():
        rows.append(_stats_case(attention, q, k, v, vis, name))
    # D = 128 (Llama-3-8B heads), Lq != Lk and a ragged tile edge: the
    # last 1000 queries of 2048 keys under a causal mask.
    q2 = torch.randn(1, 1000, 32, 128, generator=gen, device="cuda").bfloat16()
    k2, v2 = (torch.randn(1, 2048, 8, 128, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    vis2 = (torch.arange(1000, device="cuda") + 1049).int()[None, None] \
        .expand(1, 32, 1000)
    rows.append(_stats_case(attention, q2, k2, v2, vis2, "causal offset"))
    # fp32: q a slice of a wider buffer, visible a ragged row (its first
    # rows seeing nothing) broadcast with stride 0 over B and H.
    q3 = torch.randn(2, 200, 4, 128, generator=gen, device="cuda")[..., :64]
    k3, v3 = (torch.randn(2, 300, 2, 64, generator=gen, device="cuda")
              for _ in range(2))
    vis_row = torch.randint(0, 301, (200,), generator=gen, device="cuda",
                            dtype=torch.int32)
    vis_row[:7] = 0
    vis3 = vis_row[None, None].expand(2, 4, 200)
    errs = hold_stats(attention, attention.flash_attention_stats(
        q3, k3, v3, vis3), attention.flash_attention_stats_plain(
        q3, k3, v3, vis3), vis3, "fp32 strided")
    log(f"stats_check fp32 B=2 Lq=200 Lk=300 D=64 GQA, strided q, stride-0 "
        f"visible: max_abs_err o, m, l = {list(errs)}")
    # fp32 at a rank's ring blocks in phase 12 (c): tp = 2 x sp = 2 leaves
    # each rank 2/1 of the small model's 4/2 heads and 64 of 128 positions.
    q4 = torch.randn(2, 64, 2, 64, generator=gen, device="cuda")
    k4, v4 = (torch.randn(2, 64, 1, 64, generator=gen, device="cuda")
              for _ in range(2))
    for name, row in (("all", torch.full((64,), 64, device="cuda")),
                      ("diagonal", torch.arange(1, 65, device="cuda")),
                      ("none", torch.zeros(64, device="cuda"))):
        vis4 = row.int()[None, None].expand(2, 2, 64)
        errs = hold_stats(attention, attention.flash_attention_stats(
            q4, k4, v4, vis4), attention.flash_attention_stats_plain(
            q4, k4, v4, vis4), vis4, f"fp32 2/1 heads {name}")
        log(f"stats_check fp32 B=2 Lq=Lk=64 H=2 Hkv=1 D=64 {name}: "
            f"max_abs_err o, m, l = {list(errs)}")
    return rows


def _stats_case(attention, q, k, v, vis, name):
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    where = f"flash_stats {name} B={B} Lq={Lq} Lk={Lk} D={D}"
    got = attention.flash_attention_stats(q, k, v, vis)
    want = attention.flash_attention_stats_plain(q, k, v, vis)
    torch.cuda.synchronize()
    err_o, err_m, err_l = hold_stats(attention, got, want, vis, where)
    ms = time_ms(lambda: attention.flash_attention_stats(q, k, v, vis), 10)
    plain_ms = time_ms(
        lambda: attention.flash_attention_stats_plain(q, k, v, vis), 2)
    bound_ms, bound_by = stats_bound(q, k, v, vis)
    library_ms = None
    if name in ("all", "diagonal"):
        # A yardstick only, never called by the port: torch's flash
        # attention with its row log-sum-exp, the same function in another
        # form (normalised o and lse = m + log l), on K/V repeated to the
        # query heads (it takes no GQA).
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  for t in (k, v))
        def library():
            return torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, name == "diagonal")

        library_ms = time_ms(library, 10)
    row = dict(pattern=name, B=B, Lq=Lq, Lk=Lk, H=H, Hkv=Hkv, D=D,
               max_abs_err=max(err_o, err_l), o_err=err_o, m_err=err_m,
               l_err=err_l, rule=STATS_RULE, m_tol=STATS_M_TOL, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    if name == "all":  # the ring's full blocks
        row["device_ms"] = device_ms(
            lambda: attention.flash_attention_stats(q, k, v, vis), 10,
            bound_ms)
        row["library_device_ms"] = device_ms(library, 10, bound_ms)
    log("stats_check", json.dumps(row))
    return row


def check_small_training(models, gen):
    """Phase 7: fp32 training on the card through the kernels against the
    plain path on the CPU."""
    cfg = models.LlamaConfig(vocab_size=512, d_model=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=512,
                             dtype=torch.float32)
    params = models.init_params(cfg, gen, device="cuda")
    cpu_params = _host_copy(params)
    leaves, cpu_leaves = (models.trainable(params),
                          models.trainable(cpu_params))
    tokens = torch.randint(0, 512, (2, 100), generator=gen, device="cuda")
    batches = {"card": {"tokens": tokens}, "host": {"tokens": tokens.cpu()}}
    for remat, chunked in ((False, 0), (True, 128)):
        losses = {}
        for dev, tree, ls in (("card", params, leaves),
                              ("host", cpu_params, cpu_leaves)):
            for t in ls:
                t.grad = None
            loss = models.loss_fn(tree, batches[dev], cfg, remat=remat,
                                  chunked_vocab=chunked)
            loss.backward()
            losses[dev] = loss.item()
        if not abs(losses["card"] - losses["host"]) <= 1e-5 * losses["host"]:
            raise AssertionError(f"small model loss {losses} differs")
        worst = max(hold_grad(g.grad.cpu(), w.grad, FP32_GRAD_RULE,
                              f"small model grad {i}")[1]
                    for i, (g, w) in enumerate(zip(leaves, cpu_leaves)))
        log(f"small_model fp32 remat={remat} chunked_vocab={chunked}: loss "
            f"{losses['card']} (CPU {losses['host']}), {len(leaves)} "
            f"gradients, worst element {worst} of rule {FP32_GRAD_RULE}")
    start = [t.detach().cpu().clone() for t in cpu_leaves]
    curves = {}
    for dev, tree, ls in (("card", params, leaves),
                          ("host", cpu_params, cpu_leaves)):
        opt = torch.optim.AdamW(ls, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.1)
        curve = []
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = models.loss_fn(tree, batches[dev], cfg)
            loss.backward()
            opt.step()
            curve.append(loss.item())
        curves[dev] = curve
    if not all(abs(a - b) <= 1e-5 * b for a, b in zip(curves["card"],
                                                     curves["host"])):
        raise AssertionError(f"AdamW losses differ from the CPU: {curves}")
    # Adam moves an element by about LR a step whatever its gradient's size,
    # so a gradient wrong in sign moves it 2 LR a step away: each element's
    # 3-step update is held to LR / 2 of the CPU's. Where a gradient is near
    # eps (1e-8), fp32 differences in it far below the gradient rule move
    # the update by a share of LR, so elementwise is all that can be asked;
    # each tensor's whole update is also held to 1e-2 of its L2 norm.
    worst = (0.0, 0.0, -1)
    for i, (g, w, p0) in enumerate(zip(leaves, cpu_leaves, start)):
        dc, dh = g.detach().cpu() - p0, w.detach() - p0
        err = float((dc - dh).abs().max())
        rel = float((dc - dh).norm() / dh.norm().clamp(min=1e-30))
        if not (err <= LR / 2 and rel <= 1e-2):
            raise AssertionError(f"AdamW update of parameter {i} differs "
                                 f"from the CPU: max {err}, relative L2 "
                                 f"{rel}")
        worst = max(worst, (err, rel, i))
    err, rel, i = worst
    at = int((leaves[i].detach().cpu() - cpu_leaves[i].detach()).abs()
             .argmax())
    grads = (float(leaves[i].grad.flatten()[at]),
             float(cpu_leaves[i].grad.flatten()[at]))
    log(f"small_model fp32 3 AdamW steps: losses {curves['card']} (CPU "
        f"{curves['host']}); worst update error {err} (limit {LR / 2}) in "
        f"parameter {i}, relative L2 {rel} (limit 1e-2), where the last "
        f"gradients were {grads} (card, CPU)")


# The small fp32 models of phases 12 (c), 13 and 15: head dim 64, which the
# kernels take (MIXTRAL_DEBUG's 16 would route to dense attention).
SMALL_MOE_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=512, n_experts=4, top_k=2)
SMALL_VIT_CFG = dict(image_size=32, patch_size=8, num_classes=10,
                     d_model=256, n_layers=2, n_heads=4, d_ff=512)


def hold_tree_grads(got, want, what):
    """Every gradient of two leaf lists by FP32_GRAD_RULE; the worst share
    of its limit."""
    return max(hold_grad(g.grad.cpu(), w.grad, FP32_GRAD_RULE,
                         f"{what} grad {i}")[1]
               for i, (g, w) in enumerate(zip(got, want)))


def check_small_mixtral(models, attention, gen):
    """Phase 13's fp32 check: a small Mixtral (SMALL_MOE_CFG) on the card
    against the plain path on the CPU: logits and aux, then loss_fn (remat,
    JAX's default) and every gradient, with each kernel's launches counted
    (K1 n_layers for the logits; K2 twice n_layers forward under remat and
    n_layers backward)."""
    cfg = models.MixtralConfig(**SMALL_MOE_CFG, dtype=torch.float32)
    params = models.mixtral.init_params(cfg, gen, device="cuda")
    cpu_params = _host_copy(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen,
                           device="cuda")
    for c in COUNTERS + ("dense_routes",):
        setattr(attention, c, 0)
    with torch.no_grad():
        logits, aux = models.mixtral.forward(params, tokens, cfg)
        want, want_aux = models.mixtral.forward(cpu_params, tokens.cpu(), cfg)
    err, _ = hold(logits.cpu(), want, FP32_TOL, 0.0, "small Mixtral logits")
    if not abs(aux.item() - want_aux.item()) <= 1e-5 * want_aux.item():
        raise AssertionError(f"small Mixtral aux {aux.item()}, CPU "
                             f"{want_aux.item()}")
    leaves, cpu_leaves = (models.trainable(params),
                          models.trainable(cpu_params))
    loss = models.mixtral.loss_fn(params, {"tokens": tokens}, cfg)
    loss.backward()
    want_loss = models.mixtral.loss_fn(cpu_params, {"tokens": tokens.cpu()},
                                       cfg)
    want_loss.backward()
    counts = _counts(attention)
    n = cfg.n_layers
    expect = {"launches": n + 2 * n, "bwd_launches": n, "stats_launches": 0,
              "dense_routes": 0}
    if counts != expect:
        raise AssertionError(f"small Mixtral: launches {counts}, expected "
                             f"{expect}")
    if not abs(loss.item() - want_loss.item()) <= 1e-5 * want_loss.item():
        raise AssertionError(f"small Mixtral loss {loss.item()}, CPU "
                             f"{want_loss.item()}")
    worst = hold_tree_grads(leaves, cpu_leaves, "small Mixtral")
    log(f"small Mixtral fp32 (head dim 64, {cfg.n_experts} experts, top "
        f"{cfg.top_k}): logits max_abs_err {err} (tol {FP32_TOL}), aux "
        f"{aux.item()} (CPU {want_aux.item()}), loss {loss.item()} (CPU "
        f"{want_loss.item()}), {len(leaves)} gradients, worst element "
        f"{worst} of rule {FP32_GRAD_RULE}; launches {counts}")


def check_small_sp(models, parallel, attention, gen):
    """Phase 10: a small fp32 model's loss and every gradient through ring
    attention (sp = 4 on one device, the flash block step) on the card,
    against the same on the CPU through the plain versions, and against
    the card's flash_attention path."""
    cfg = models.LlamaConfig(vocab_size=512, d_model=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=512,
                             dtype=torch.float32)
    params = models.init_params(cfg, gen, device="cuda")
    cpu_params = _host_copy(params)
    leaves, cpu_leaves = (models.trainable(params),
                          models.trainable(cpu_params))
    tokens = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    spec = parallel.MeshSpec(sp=4)
    runs = {}
    for name, tree, ls, tok, attn in (
            ("ring card", params, leaves, tokens, parallel.make_ring_attention(
                parallel.make_mesh(spec, device="cuda"), block_impl="flash")),
            ("ring host", cpu_params, cpu_leaves, tokens.cpu(),
             parallel.make_ring_attention(
                 parallel.make_mesh(spec, device="cpu"), block_impl="flash")),
            ("flash card", params, leaves, tokens, None)):
        for t in ls:
            t.grad = None
        before = attention.stats_launches
        loss = models.loss_fn(tree, {"tokens": tok}, cfg, remat=False,
                              attn_impl=attn)
        loss.backward()
        runs[name] = (loss.item(), [t.grad.cpu() for t in ls],
                      attention.stats_launches - before)
    launched = [runs[n][2] for n in runs]
    if launched != [cfg.n_layers * 16, 0, 0]:
        raise AssertionError(f"stats kernel launches {launched}, expected "
                             f"{cfg.n_layers * 16} on the card's ring only")
    ref_loss, ref_grads, _ = runs["ring card"]
    for other in ("ring host", "flash card"):
        loss, grads, _ = runs[other]
        if not abs(loss - ref_loss) <= 1e-5 * abs(loss):
            raise AssertionError(f"sp ring loss {ref_loss} != {other} {loss}")
        worst = max(hold_grad(g, w, FP32_GRAD_RULE,
                              f"sp ring grad {i} vs {other}")[1]
                    for i, (g, w) in enumerate(zip(ref_grads, grads)))
        log(f"small_model fp32 sp=4 ring (flash block, card): loss "
            f"{ref_loss} ({other} {loss}), {len(grads)} gradients, worst "
            f"element {worst} of rule {FP32_GRAD_RULE}")
    # The share of a split batch with remat and the chunked loss, on a
    # one-device mesh (the whole loss), card against CPU. Remat runs each
    # layer's ring forward again in the backward.
    runs = {}
    for dev, tree, ls, tok in (("card", params, leaves, tokens),
                               ("host", cpu_params, cpu_leaves,
                                tokens.cpu())):
        mesh = parallel.make_mesh(spec, device=tok.device)
        for t in ls:
            t.grad = None
        before = attention.stats_launches
        loss = parallel.sharded_loss_fn(
            tree, tok, cfg, mesh, remat=True, chunked_vocab=128,
            attn_impl=parallel.make_ring_attention(mesh, block_impl="flash"))
        loss.backward()
        runs[dev] = (loss.item(), [t.grad.cpu() for t in ls],
                     attention.stats_launches - before)
    (loss, grads, launched), (want, want_grads, host_launched) = \
        runs["card"], runs["host"]
    if (launched, host_launched) != (2 * cfg.n_layers * 16, 0) or \
            not abs(loss - want) <= 1e-5 * abs(want):
        raise AssertionError(f"sharded_loss_fn remat + chunked: loss {loss} "
                             f"(CPU {want}), stats launches {launched}")
    worst = max(hold_grad(g, w, FP32_GRAD_RULE, f"sharded grad {i}")[1]
                for i, (g, w) in enumerate(zip(grads, want_grads)))
    log(f"small_model fp32 sharded_loss_fn sp=4 ring, remat, chunked_vocab "
        f"128: loss {loss} (CPU {want}), worst gradient element {worst} of "
        f"rule {FP32_GRAD_RULE}; {launched} stats launches")


def ring_layer_times(attention, parallel, gen):
    """Phase 11's attention alone, at one layer's shape ([1, 8192], 32/8
    heads, D 64, bf16, causal): the sp = 4 ring's output and dq, dk, dv
    held per element to flash_attention's (K2) on the same inputs, then
    the ring's forward (16 stats launches and the merges) and its plain
    backward timed beside flash_attention's forward and backward."""
    q = torch.randn(1, 8192, 32, 64, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(1, 8192, 8, 64, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    do = torch.randn_like(q)
    for t in (q, k, v):
        t.requires_grad_(True)
    ring = parallel.make_ring_attention(
        parallel.make_mesh(parallel.MeshSpec(sp=4), device="cuda"),
        block_impl="flash")
    out, res = {}, {}
    for name, fn in (("ring", ring), ("flash_attention", lambda *a:
                                      attention.flash_attention(*a, True))):
        o = fn(q, k, v)
        res[name] = (o.detach(), *torch.autograd.grad(o, (q, k, v), do))
        with torch.no_grad():
            fwd = time_ms(lambda: fn(q, k, v), 3)
        both = time_ms(lambda: torch.autograd.grad(fn(q, k, v), (q, k, v),
                                                   do), 3)
        out[name] = dict(fwd_ms=fwd, bwd_ms=both - fwd)
    # Both sides sum in fp32 from the same bf16 inputs and round once to
    # bf16, as in phases 2 and 6: the output by the forward's rule, the
    # gradients by the backward's.
    (ro, *rg), (fo, *fg) = res["ring"], res["flash_attention"]
    shares = {"o": hold(ro, fo, BF16_ATOL, BF16_RTOL,
                        "ring o vs flash_attention")[1]}
    for name, g, w in zip(("dq", "dk", "dv"), rg, fg):
        shares[name] = hold_grad(g, w, BF16_GRAD_RULE,
                                 f"ring {name} vs flash_attention")[1]
    out["worst_share_of_limit"] = shares
    log(f"attention per layer [1, 8192] causal bf16, ring against "
        f"flash_attention within (ATOL {BF16_ATOL}, RTOL {BF16_RTOL}) for o "
        f"and {BF16_GRAD_RULE} for dq, dk, dv: {json.dumps(out)}")
    return out


COUNTERS = ("launches", "bwd_launches", "stats_launches")


def train_run(models, attention, cfg, tokens, seed, warm, timed, remat,
              chunked, expect, name, attn_impl=None, profile=True,
              model=None, batch=None, loss_kw=None, throughput=None,
              groups=None):
    """One run of a training main path from weights drawn from ``seed``:
    ``warm`` + ``timed`` AdamW steps on the same tokens through
    ``attn_impl`` (``flash_attention`` unless given), with every launch
    count reset just before and read just after and held to ``expect``
    (counter name to launches), then, with ``profile``, one profiled step.
    ``model`` is the family (``models``, a Llama, unless given:
    ``models.mixtral``, ``models.vit``), ``batch`` its loss's batch
    ({"tokens": tokens} unless given), ``loss_kw`` more arguments of its
    ``loss_fn`` (``remat=None`` passes none), ``throughput`` the items a
    step trains, their name and FLOPs per item (the tokens and
    ``flops_per_token`` unless given), and ``groups(params)`` the first
    step's squared gradient norms by group (``llama_group_sq``), kept
    where given. The weights and optimizer are freed on return."""
    model = model or models
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(cfg, gen, device="cuda")
    leaves = models.trainable(params)
    opt = torch.optim.AdamW(leaves, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.1)
    batch = batch if batch is not None else {"tokens": tokens}
    kw = dict(loss_kw or {}, attn_impl=attn_impl)
    if remat is not None:
        kw["remat"] = remat
    if chunked:
        kw["chunked_vocab"] = chunked
    if throughput is None:
        B, L = tokens.shape
        throughput = (B * L, f"tokens [{B}, {L}]",
                      models.flops_per_token(cfg, L))
    norms = []  # the first step's squared gradient norm of each leaf
    group_sq = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss_fn(params, batch, cfg, **kw)
        loss.backward()
        if not norms:
            norms.append(torch.stack([t.grad.float().square().sum()
                                      for t in leaves]))
            if groups is not None:
                group_sq.append(groups(params))
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts reset just before, read just after
    for c in COUNTERS:
        setattr(attention, c, 0)
    t0 = time.perf_counter()
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses += [step() for _ in range(timed)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - (t1 if timed else t0)) / (timed or warm)
    counts = {c: getattr(attention, c) for c in COUNTERS}
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or \
            (len(losses) > 1 and not losses[-1] < losses[0]):
        raise AssertionError(f"{name}: losses {losses} not finite and "
                             f"falling")
    if counts != {c: expect.get(c, 0) for c in COUNTERS}:
        raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    items, unit, flops_per_item = throughput
    tok_s = items / step_s
    mfu = flops_per_item * tok_s / H100_BF16_FLOPS
    log(f"train {name}, {unit}: losses {losses}; "
        f"{step_s * 1e3} ms/step over {timed or warm} "
        f"{'timed' if timed else 'untimed-warm'} steps = {tok_s} "
        f"{unit.split()[0]}/s, MFU {mfu}; peak memory {peak / 2**30} GiB; "
        f"launches {counts} over {warm + timed} steps")
    out = dict(losses=losses, step_ms=step_s * 1e3, tokens_per_s=tok_s,
               mfu=mfu, peak_gib=peak / 2**30,
               grad_norm=float(norms[0].sum().sqrt()),
               leaf_norms=norms[0].sqrt().tolist(), **counts)
    if group_sq:
        out["group_sq"] = group_sq[0]
    if profile:
        busy_ms, kernels = device_profile(step, 1)
        if not kernels:
            # a window the profiler left empty is no reading of 0 ms
            log(f"train profile {name}: the profiler traced no kernel; "
                f"busy share not measured")
        else:
            log(f"train profile {name}: the device ran {busy_ms} ms in "
                f"one step, {busy_ms / 1e3 / step_s} of the unprofiled "
                f"step, in {sum(n for _, n, _ in kernels)} kernels")
            log_top(kernels)
            out["busy_share"] = busy_ms / 1e3 / step_s
    del params, leaves, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 14: Mixtral-8x7B's widths at 2 of its 32 layers: 3.165 B
# parameters, whose bf16 weights, gradients and AdamW moments (8 bytes a
# parameter) take 25.3 GB, beside the dense MoE's activations (g, u and
# silu(g) u at [8, 8192, 14336] bf16, 1.88 GB each, a layer at a time
# under remat).
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_TRAIN_SEED = 16


def train_mixtral(models, parallel, attention, tokens):
    """Phase 14: 1 + 2 AdamW steps of mixtral_train_cfg on ``tokens``
    [4, 2048], remat on, the MoE dense (every expert on every token, as
    JAX's single-device path); K2 launches 2 n_layers forward (remat runs
    each forward twice) and n_layers backward a step. Returns train_run's
    result with the first step's aux and CE, and MFU counted by the active
    parameters (JAX's count for an MoE) beside train_run's, which counts
    every expert's FLOPs, the work the dense path does."""
    cfg = mixtral_train_cfg(models)
    n, L = cfg.n_layers, tokens.shape[1]
    log(f"Mixtral-8x7B widths, {n} layers: {cfg.param_count()} params, "
        f"{cfg.active_param_count()} active; d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, {cfg.n_experts} experts, top {cfg.top_k}")
    rec = AuxRecorder(lambda x, router, experts: parallel.moe_ffn_dense(
        x, router, experts, cfg.top_k))
    out = train_run(models, attention, cfg, tokens, seed=MIXTRAL_TRAIN_SEED,
                    warm=1, timed=2, remat=True, chunked=0,
                    expect={"launches": 2 * n * 3, "bwd_launches": n * 3},
                    name=f"Mixtral-8x7B widths {n} layers remat (MFU by "
                         f"every expert's FLOPs)",
                    model=models.mixtral, loss_kw={"moe_ffn": rec})
    out["aux"] = float(torch.stack(rec.aux[:n]).sum())
    out["ce"] = out["losses"][0] - cfg.aux_coef * out["aux"]
    active = 6 * cfg.active_param_count() + 12 * n * cfg.d_model * L
    out["mfu_active"] = active * out["tokens_per_s"] / H100_BF16_FLOPS
    log(f"Mixtral training: first loss {out['losses'][0]} = CE {out['ce']} "
        f"+ {cfg.aux_coef} x aux {out['aux']}; gradient norm "
        f"{out['grad_norm']}; MFU {out['mfu_active']} by the active "
        f"parameters, {out['mfu']} by every expert's FLOPs")
    return out


# Phase 15: ViT-B/16 at full width and depth, its images and AdamW steps.
VIT_IMAGES = 128
VIT_SEED = 18
# flash_attention against dense_attention on the same bf16 weights and
# images: the two round attention's output to bf16 after fp32 sums taken in
# another order, a step of 2**-8 at most in an element, through 12 layers.
# The first loss is held to VIT_RTOL of the dense run's, and each leaf's
# first gradient norm to VIT_LEAF_RTOL of its counterpart's: the loss at
# random init is near ln(1000) whatever attention computes, so the leaves
# carry the check. Its negative control, dense_attention blind to the keys
# past the last whole tile of 64 (5 of 197: the tail a kernel's key mask
# guards), must break the leaf rule. Read on an H100 80GB HBM3 (700 W):
# the loss 1.24e-4 and the worst of 103 leaves 2.97e-3 from the dense
# run's; the fault's loss 9.2e-4, its worst leaf 5.0e-2.
VIT_RTOL = 5e-4
VIT_LEAF_RTOL = 1e-2


def vit_batch(cfg, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"images": torch.randn(n, cfg.image_size, cfg.image_size,
                                  cfg.channels, generator=gen, device="cuda"),
            "labels": torch.randint(0, cfg.num_classes, (n,), generator=gen,
                                    device="cuda")}


def train_vit(models, attention):
    """Phase 15: ViT-B/16 (ViTConfig()), bf16, random weights from a seed,
    VIT_IMAGES random images; 1 + 2 AdamW steps through flash_attention
    (the main path: K2 at [128, 197, 12/12, 64] non-causal, 12 forward and
    12 backward launches a step), the first step again through
    dense_attention, the first loss and each leaf's gradient norm held by
    VIT_RTOL and VIT_LEAF_RTOL, and once with a planted fault they must
    refuse; then
    the forward under no_grad (K1, 12 launches) and a small fp32 ViT
    against the CPU."""
    vit = models.vit
    cfg = vit.ViTConfig()
    n = cfg.n_layers
    batch = vit_batch(cfg, VIT_IMAGES, VIT_SEED)
    throughput = (VIT_IMAGES, f"images [{VIT_IMAGES}, {cfg.image_size}, "
                  f"{cfg.image_size}, {cfg.channels}]",
                  vit.flops_per_image(cfg))
    log(f"ViT-B/16: {cfg.param_count()} params, {cfg.num_patches + 1} "
        f"tokens, {cfg.n_heads} heads of {cfg.head_dim}")
    flash = train_run(models, attention, cfg, None, seed=VIT_SEED, warm=1,
                      timed=2, remat=None, chunked=0,
                      expect={"launches": 3 * n, "bwd_launches": 3 * n},
                      name="ViT-B/16", model=vit, batch=batch,
                      throughput=throughput)
    dense = train_run(models, attention, cfg, None, seed=VIT_SEED, warm=1,
                      timed=0, remat=None, chunked=0, expect={},
                      name="ViT-B/16 through dense_attention",
                      attn_impl=attention.dense_attention, profile=False,
                      model=vit, batch=batch, throughput=throughput)

    def tail_blind(q, k, v, causal=False):
        keys = k.shape[1] // 64 * 64
        return attention.dense_attention(q, k[:, :keys], v[:, :keys], causal)

    fault = train_run(models, attention, cfg, None, seed=VIT_SEED, warm=1,
                      timed=0, remat=None, chunked=0, expect={},
                      name="ViT-B/16, planted fault: dense_attention blind "
                           "to keys 192..196", attn_impl=tail_blind,
                      profile=False, model=vit, batch=batch,
                      throughput=throughput)

    def worst_leaf(run):  # the largest relative gap of a leaf's norm
        return max(abs(g - w) / w for g, w in
                   zip(run["leaf_norms"], dense["leaf_norms"]))

    loss_gap = abs(flash["losses"][0] - dense["losses"][0]) / \
        abs(dense["losses"][0])
    leaf_gap, fault_gap = worst_leaf(flash), worst_leaf(fault)
    log(f"ViT-B/16 first step against dense_attention: loss "
        f"{flash['losses'][0]} and {dense['losses'][0]} ({loss_gap}, rule "
        f"{VIT_RTOL}); gradient norm {flash['grad_norm']} and "
        f"{dense['grad_norm']}; worst of {len(dense['leaf_norms'])} leaf "
        f"norms {leaf_gap} (rule {VIT_LEAF_RTOL}); the planted fault's loss "
        f"{fault['losses'][0]}, worst leaf {fault_gap}")
    if not (loss_gap <= VIT_RTOL and leaf_gap <= VIT_LEAF_RTOL):
        raise AssertionError("ViT-B/16 through flash_attention parts from "
                             "dense_attention")
    if not fault_gap > VIT_LEAF_RTOL:
        raise AssertionError("ViT-B/16's leaf rule took the planted fault")
    flash.update(loss_gap=loss_gap, leaf_gap=leaf_gap, fault_gap=fault_gap)

    params = vit.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(VIT_SEED), device="cuda")
    for c in COUNTERS + ("dense_routes",):
        setattr(attention, c, 0)
    with torch.no_grad():
        logits = vit.forward(params, batch["images"], cfg)
    torch.cuda.synchronize()
    forward_launches = _counts(attention)
    if forward_launches != {"launches": n, "bwd_launches": 0,
                            "stats_launches": 0, "dense_routes": 0} or \
            logits.shape != (VIT_IMAGES, cfg.num_classes) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"ViT-B/16 forward: {tuple(logits.shape)}, "
                             f"launches {forward_launches}")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: vit.forward(params, batch["images"], cfg), 5)
    log(f"ViT-B/16 forward under no_grad, {VIT_IMAGES} images: {fwd_ms} ms, "
        f"{VIT_IMAGES / fwd_ms * 1e3} images/s; launches {forward_launches}")
    del params, logits, batch
    gc.collect()
    torch.cuda.empty_cache()

    small = vit.ViTConfig(**SMALL_VIT_CFG, dtype=torch.float32)
    params = vit.init_params(small, torch.Generator(device="cuda")
                             .manual_seed(19), device="cuda")
    cpu_params = _host_copy(params)
    sbatch = vit_batch(small, 8, 20)
    cpu_batch = {k: v.cpu() for k, v in sbatch.items()}
    for c in COUNTERS + ("dense_routes",):
        setattr(attention, c, 0)
    with torch.no_grad():
        err, _ = hold(vit.forward(params, sbatch["images"], small).cpu(),
                      vit.forward(cpu_params, cpu_batch["images"], small),
                      FP32_TOL, 0.0, "small ViT logits")
    leaves, cpu_leaves = (models.trainable(params),
                          models.trainable(cpu_params))
    loss = vit.loss_fn(params, sbatch, small)
    loss.backward()
    want = vit.loss_fn(cpu_params, cpu_batch, small)
    want.backward()
    counts = _counts(attention)
    expect = {"launches": 2 * small.n_layers,
              "bwd_launches": small.n_layers, "stats_launches": 0,
              "dense_routes": 0}
    if counts != expect or \
            not abs(loss.item() - want.item()) <= 1e-5 * want.item():
        raise AssertionError(f"small ViT: loss {loss.item()} (CPU "
                             f"{want.item()}), launches {counts}, expected "
                             f"{expect}")
    worst = hold_tree_grads(leaves, cpu_leaves, "small ViT")
    log(f"small ViT fp32 (image 32, patch 8: 17 tokens, 4 heads of 64): "
        f"logits max_abs_err {err} (tol {FP32_TOL}), loss {loss.item()} "
        f"(CPU {want.item()}), {len(leaves)} gradients, worst element "
        f"{worst} of rule {FP32_GRAD_RULE}; launches {counts}")
    return flash, forward_launches["launches"], fwd_ms


# Phases 16 and 12 (f)/(g): LLAMA3_1B's layers pipelined over pp (JAX's
# GPipe schedule, make_pipelined_loss: remat on, the dense loss), held to
# phase 8's dense run. Phase 16 runs pp = 4 on one device, its stages in
# lockstep: name -> microbatches.
LOCKSTEP_PP = 4
LOCKSTEP_RUNS = {"pp=4 lockstep, M=4": 4, "pp=4 lockstep, M=2": 2}
# Each group of leaves' first gradient norm (the embedding, the final norm,
# the head, and each stage's layers) is held to phase 8's within
# GROUP_RTOL: a fault in the pp sums moves one group (the embedding's
# gradient left unsummed over pp reads 1/sqrt(pp) of it, a cotangent
# summed pp times pp times each layer's) while the whole norm can hide it.
# Read on an H100 80GB HBM3 (700 W): the sound runs' worst gap 3.2e-4
# (the final norm's at pp = 2 x tp = 2, whose sums over tp run in another
# order); the two faults, planted in phase 12's (f) and (g) until the
# script's seconds went to phase 24, read 0.293 and 1.000. The CPU tests
# hold each pipelined gradient to JAX's (tests/test_torch_parallel.py),
# which either fault breaks.
GROUP_RTOL = 5e-3


class Pipelined:
    """Llama as ``train_run`` takes a model, its layers pipelined over the
    ``pp`` stages of ``mesh`` in ``microbatches``: ``init_params`` gives
    the pipelined tree of the same weights, ``loss_fn`` is
    ``make_pipelined_loss``'s."""

    def __init__(self, models, parallel, mesh, microbatches):
        self.models, self.parallel = models, parallel
        self.mesh, self.microbatches = mesh, microbatches

    def init_params(self, cfg, gen, device):
        return self.parallel.to_pipeline_params(
            self.models.init_params(cfg, gen, device=device))

    def loss_fn(self, params, batch, cfg, attn_impl=None, remat=True):
        return self.parallel.make_pipelined_loss(
            self.mesh, cfg, self.microbatches, remat=remat,
            attn_impl=attn_impl)(params, batch["tokens"])


def bubble(pp: int, microbatches: int) -> float:
    """The bubble's share of the ticks, (S - 1) / (M + S - 1)."""
    return (pp - 1) / (microbatches + pp - 1)


def pipelined_expect(n_layers: int, pp: int, microbatches: int,
                     steps: int, lockstep: bool) -> dict:
    """K2's launches in ``steps`` remat steps of the pipeline by a rank (or
    by the one process that runs every stage in lockstep): on each of the
    M + S - 1 ticks every stage runs its layers forward, again in remat's
    recompute, and backward."""
    ticks = microbatches + pp - 1
    layers = n_layers if lockstep else n_layers // pp
    return {"launches": 2 * ticks * layers * steps,
            "bwd_launches": ticks * layers * steps}


def llama_group_sq(params) -> dict:
    """The squared gradient norms of a Llama tree's groups of leaves, plain
    or pipelined: ``embedding``, ``norm``, ``lm_head``, and ``layers`` (one
    for each layer)."""
    def sq(t):
        return float(t.grad.float().square().sum())

    out = {k: sq(params[k]) for k in ("embedding", "norm", "lm_head")}
    if "layers" in params:
        out["layers"] = [sum(sq(t) for t in layer.values())
                         for layer in params["layers"]]
    else:
        stacked = list(params["stacked"].values())
        out["layers"] = [float(sum(t.grad[i].float().square().sum()
                                   for t in stacked))
                         for i in range(stacked[0].shape[0])]
    return out


def sharded_group_sq(parallel, shards, mesh, specs, cfg) -> dict:
    """``llama_group_sq`` over a process-group mesh from each rank's
    pipelined shards (after ``allreduce_grads``): a leaf's sum of squares
    over the count of ranks that hold the same shard, each stacked layer
    at its global index, summed over the mesh."""
    from ray_tpu_torch.parallel import collectives, mesh as pmesh, sharding

    spec_of = dict(sharding.tree_paths(specs))

    def part(path, t):
        split = sharding.spec_axes(spec_of[path])
        copies = math.prod(n for a, n in mesh.shape.items()
                           if a not in split)
        return t.grad.float().square() / copies

    vec = torch.zeros(3 + cfg.n_layers, device=mesh.device)
    for i, k in enumerate(("embedding", "norm", "lm_head")):
        vec[i] = part(k, shards[k]).sum()
    n = cfg.n_layers // mesh.shape["pp"]
    first = 3 + mesh.coords["pp"] * n
    for path, t in sharding.tree_paths(shards["stacked"], "stacked"):
        vec[first:first + n] += part(path, t).flatten(1).sum(1)
    vec = collectives.allreduce(vec, mesh, pmesh.AXES).tolist()
    return dict(embedding=vec[0], norm=vec[1], lm_head=vec[2],
                layers=vec[3:])


def stage_norms(group_sq: dict, pp: int) -> dict:
    """Group norms from ``llama_group_sq``'s squares, the layers summed by
    the stage that holds them at ``pp`` stages."""
    out = {k: math.sqrt(group_sq[k]) for k in ("embedding", "norm",
                                               "lm_head")}
    layers = group_sq["layers"]
    n = len(layers) // pp
    for s in range(pp):
        out[f"layers {s * n}-{(s + 1) * n - 1}"] = math.sqrt(
            sum(layers[s * n:(s + 1) * n]))
    return out


def group_gaps(got_sq: dict, want_sq: dict, pp: int) -> dict:
    """Each group's relative gap from the reference's, at ``pp`` stages."""
    got, want = stage_norms(got_sq, pp), stage_norms(want_sq, pp)
    return {k: abs(got[k] - want[k]) / want[k] for k in want}


def pipeline_phase(models, parallel, attention, cfg, tokens, dense):
    """Phase 16: LOCKSTEP_RUNS, 1 + 2 AdamW steps each of phase 8's
    weights (seed 7) and tokens, pipelined over a one-device pp = 4 mesh
    (the 4 stages in lockstep, 4 layers each) through flash_attention (K2)
    with remat; launches at the schedule's count, the first loss and the
    whole gradient norm within 1e-2 and each group's norm within
    GROUP_RTOL of phase 8's dense run (``dense``)."""
    mesh = parallel.make_mesh(parallel.MeshSpec(pp=LOCKSTEP_PP),
                              device="cuda")
    out = {}
    for name, m in LOCKSTEP_RUNS.items():
        run = train_run(
            models, attention, cfg, tokens, seed=7, warm=1, timed=2,
            remat=True, chunked=0,
            expect=pipelined_expect(cfg.n_layers, LOCKSTEP_PP, m, 3,
                                    lockstep=True),
            name=f"LLAMA3_1B {name}", model=Pipelined(models, parallel,
                                                     mesh, m),
            groups=llama_group_sq)
        hold_pipelined(name, run["losses"][0], run["grad_norm"],
                       run["group_sq"], dense, LOCKSTEP_PP)
        run["bubble"] = bubble(LOCKSTEP_PP, m)
        run["step_vs_dense"] = run["step_ms"] / dense["step_ms"]
        log(f"phase 16 {name}: {run['step_ms']} ms/step (phase 8's dense "
            f"step {dense['step_ms']}: {run['step_vs_dense']}x; the layers' "
            f"work (M + S - 1) / M = {(m + LOCKSTEP_PP - 1) / m}x plus "
            f"remat's recompute), bubble {run['bubble']}, peak "
            f"{run['peak_gib']} GiB")
        out[name] = run
    return out


def hold_pipeline_traffic(name, sizes, microbatches, tokens, d_model, got):
    """A pipelined rank's traffic a step: 2 (M + S) - 3 hops (M + S - 1
    forward; the hop back of each but the last tick's) of a bf16
    microbatch's activations, and each FSDP-split leaf gathered and
    reduce-scattered once, whatever the count of ticks."""
    pp = sizes["pp"]
    rows = tokens.shape[0] // math.prod(sizes.get(a, 1)
                                        for a in ("dp", "fsdp", "ep"))
    hops = 2 * (microbatches + pp) - 3
    hop_bytes = rows // microbatches * tokens.shape[1] * d_model * 2
    for r, g in enumerate(got):
        t = g["traffic_per_step"]
        want = {"send_recv": hops, "send_recv_bytes": hops * hop_bytes,
                "allgather": g["fsdp_leaves"],
                "allgather_bytes": g["fsdp_bytes"],
                "reducescatter": g["fsdp_leaves"]}
        seen = {k: t.get(k, 0) for k in want}
        if seen != want:
            raise AssertionError(f"{name} rank {r}: traffic a step {seen}, "
                                 f"expected {want}")
    log(f"phase 12 {name}: a step moves {hops} hops of {hop_bytes} bytes "
        f"and gathers {got[0]['fsdp_leaves']} FSDP leaves once "
        f"({got[0]['fsdp_bytes']} bytes a rank); bubble "
        f"{bubble(pp, microbatches)}")


def hold_pipelined(name, first, norm, group_sq, dense, pp):
    """A pipelined run's first loss and whole gradient norm within 1e-2 of
    phase 8's dense run, and each group's norm within GROUP_RTOL."""
    ref = dense["losses"][0]
    if not abs(first - ref) <= 1e-2 * abs(ref):
        raise AssertionError(f"{name}: first loss {first}, phase 8's {ref}")
    if not abs(norm - dense["grad_norm"]) <= 1e-2 * dense["grad_norm"]:
        raise AssertionError(f"{name}: first gradient norm {norm}, phase "
                             f"8's {dense['grad_norm']}")
    gaps = group_gaps(group_sq, dense["group_sq"], pp)
    worst = max(gaps, key=gaps.get)
    log(f"{name}: first loss {first} (phase 8's {ref}), gradient norm "
        f"{norm} (ratio {norm / dense['grad_norm']}); group norms' gaps "
        f"from phase 8's {json.dumps(gaps)}, worst {worst} {gaps[worst]} "
        f"(limit {GROUP_RTOL})")
    if not gaps[worst] <= GROUP_RTOL:
        raise AssertionError(f"{name}: group {worst}'s gradient norm "
                             f"{gaps[worst]} from phase 8's")
    return gaps


# Phase 12: sharded training, 4 ranks on the one card. LLAMA3_1B's runs:
# name -> (mesh sizes, remat, chunked vocab, phase 8's run of that recipe,
# pipeline microbatches or None). (f) and (g) pipeline the layers over pp
# (make_pipelined_loss: remat, the dense loss), held to phase 8's dense run.
SHARDED_RUNS = {
    "fsdp=2 x tp=2, dense": (dict(fsdp=2, tp=2), False, 0, "dense", None),
    "fsdp=4, remat + chunked": (dict(fsdp=4), True, 16384, "remat", None),
    "(f) pp=2 x tp=2, M=4, remat": (dict(pp=2, tp=2), True, 0, "dense", 4),
    "(g) pp=2 x fsdp=2, M=2, remat": (dict(pp=2, fsdp=2), True, 0, "dense",
                                      2),
}
# (e): phase 14's Mixtral on ep = 4, capacity factor E / k, so that a rank
# may send all its tokens to one expert and none is dropped.
EP_RUN = "ep=4, Mixtral 2 layers, remat"
# AdamW steps a run takes (its first, the CUDA and gloo warm-up
# included, timed too); then the later loss, which must fall below the
# first, from a forward of the updated shards under no_grad: a host-staged
# step takes 3-26 s a rank, its forward a fraction of that.
SHARDED_STEPS = 1
# (h): ViT-B/16 at full width and depth on fsdp = 2 x tp = 2, phase 15's
# weights, images and labels; its first loss held to phase 15's within
# VIT_RTOL, its first gradient norm within 1%.
VIT_RUN = "(h) ViT-B/16, fsdp=2 x tp=2"
VIT_MESH = dict(fsdp=2, tp=2)
# The small fp32 models: head dim 64, so tp = 2 leaves each rank 2/1 heads
# for the kernels. name -> (mesh sizes, attention, remat, chunked vocab,
# MoE, pipeline microbatches or None); the Mixtral's through
# make_ep_moe_ffn at its capacity factor 2.0 (= E / k: nothing dropped),
# remat on (JAX's default); the pipelined Llama's SMALL_PIPE_LAYERS layers
# through make_pipelined_loss on SMALL_PIPE_TOKENS.
SMALL_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=512)
SMALL_TOKENS = (2, 128)
SMALL_MOE_TOKENS = (4, 64)  # a row a token shard at fsdp = 2 x ep = 2
SMALL_PIPE_LAYERS = 4       # a layer a stage at pp = 4
SMALL_PIPE_TOKENS = (4, 128)  # a row a microbatch at M = 4
SHARDED_SMALL_RUNS = {
    "tp=2 x sp=2, sp ring (flash)": (dict(tp=2, sp=2), "ring", False, 0,
                                     False, None),
    "fsdp=2 x tp=2, flash_attention, remat + chunked":
        (dict(fsdp=2, tp=2), None, True, 128, False, None),
    "ep=2 x tp=2, Mixtral, remat": (dict(ep=2, tp=2), None, True, 0, True,
                                    None),
    "fsdp=2 x ep=2, Mixtral, remat": (dict(fsdp=2, ep=2), None, True, 0,
                                      True, None),
    "pp=4, M=4, flash_attention, remat": (dict(pp=4), None, True, 0, False,
                                          4),
    "pp=2 x tp=2, M=2, flash_attention, remat":
        (dict(pp=2, tp=2), None, True, 0, False, 2),
}
WORLD = 4


def _small_inputs(models, moe=False, pipelined=False):
    """Phase 12 (c)'s fp32 weights and tokens (a Llama, with ``moe`` a
    Mixtral, with ``pipelined`` a SMALL_PIPE_LAYERS-layer Llama's
    pipelined tree), from CPU generators, so the ranks and the parent's
    CPU reference draw the same ones."""
    if moe:
        cfg = models.MixtralConfig(**SMALL_MOE_CFG, dtype=torch.float32)
        params = models.mixtral.init_params(
            cfg, torch.Generator().manual_seed(12), device="cpu")
        shape = SMALL_MOE_TOKENS
    elif pipelined:
        from ray_tpu_torch.parallel import pipeline

        cfg = models.LlamaConfig(**dict(SMALL_CFG,
                                        n_layers=SMALL_PIPE_LAYERS),
                                 dtype=torch.float32)
        params = pipeline.to_pipeline_params(models.init_params(
            cfg, torch.Generator().manual_seed(12), device="cpu"))
        shape = SMALL_PIPE_TOKENS
    else:
        cfg = models.LlamaConfig(**SMALL_CFG, dtype=torch.float32)
        params = models.init_params(cfg, torch.Generator().manual_seed(12),
                                    device="cpu")
        shape = SMALL_TOKENS
    tokens = torch.randint(0, cfg.vocab_size, shape,
                           generator=torch.Generator().manual_seed(13))
    return cfg, params, tokens


def _counts(attention):
    return {c: getattr(attention, c) for c in COUNTERS + ("dense_routes",)}


def _specs(models, parallel, params, mesh):
    """A tree's specs: pipelined_specs for a pipelined tree,
    mixtral_shardings for an MoE, LLAMA_RULES else."""
    if "stacked" in params:
        return parallel.pipelined_specs(params, mesh)
    if "router" in params["layers"][0]:
        return models.mixtral_shardings(params, mesh)
    return parallel.shardings_for_tree(params, mesh)


def sharded_small(models, parallel, attention, sizes, attn, remat, chunked,
                  moe, micro, grads_path):
    """Phase 12 (c) in one rank: the small model's shards on the mesh, its
    share's backward (through make_pipelined_loss in ``micro``
    microbatches where given), the gradients completed; returns the global
    loss and this rank's launches, and rank 0 saves the gathered
    gradients."""
    from ray_tpu_torch.parallel import collectives, training

    cfg, params, tokens = _small_inputs(models, moe, pipelined=bool(micro))
    mesh = parallel.make_mesh(parallel.MeshSpec(**sizes), device="cuda",
                              backend="gloo")
    params = _tree_map(lambda t: t.to("cuda"), params)
    specs = _specs(models, parallel, params, mesh)
    shards = parallel.shard_params(params, mesh, specs)
    models.trainable(shards)
    impl = (parallel.make_ring_attention(mesh, block_impl="flash")
            if attn == "ring" else None)
    for c in COUNTERS + ("dense_routes",):
        setattr(attention, c, 0)
    if micro:
        share = parallel.make_pipelined_loss(mesh, cfg, micro, remat=remat)(
            shards, tokens.to("cuda"), specs)
    else:
        kw = {"forward": models.mixtral.sharded_forward} if moe else {}
        share = parallel.sharded_loss_fn(
            shards, tokens.to("cuda"), cfg, mesh, attn_impl=impl,
            remat=remat, chunked_vocab=chunked, specs=specs, **kw)
    share.backward()
    parallel.allreduce_grads(shards, mesh, specs)
    torch.cuda.synchronize()
    counts = _counts(attention)
    loss = collectives.allreduce(share.detach(), mesh, training.SPLIT_AXES)
    grads = parallel.gather_params(_tree_map(lambda t: t.grad, shards),
                                   mesh, specs)
    if torch.distributed.get_rank() == 0:
        torch.save(_host_copy(grads), grads_path)
    layer = shards["stacked"] if micro else shards["layers"][0]
    return dict(loss=float(loss), local_heads=[
        layer["wq"].shape[-1] // cfg.head_dim,
        layer["wk"].shape[-1] // cfg.head_dim], **counts)


class AuxRecorder:
    """A ``moe_ffn`` that keeps each call's aux: a step's first n_layers
    calls are its forward's (remat's recompute calls again in the
    backward)."""

    def __init__(self, fn):
        self.fn, self.aux = fn, []

    def __call__(self, x, router, experts):
        out, aux = self.fn(x, router, experts)
        self.aux.append(aux.detach())
        return out, aux


def sharded_train(models, parallel, attention, cfg, tokens, sizes, remat,
                  chunked, model=None, seed=7, microbatches=None):
    """Phase 12 (a), (b), (e), (f), (g) and (h) in one rank: phase 8's
    weights (seed 7), or with ``model=models.mixtral`` phase 14's, or with
    ``model=models.vit`` phase 15's, built on the card, cut to this rank's
    shards and the rest freed, then SHARDED_STEPS AdamW steps on the
    phase's tokens through sharded_loss_fn (flash_attention, K2, at this
    rank's heads and rows; a Mixtral's MoE through make_ep_moe_ffn, whose
    aux the first step records), a ViT's ``tokens`` (its batch of images
    and labels) through sharded_vit_loss_fn under VIT_RULES' specs, or
    with ``microbatches`` through make_pipelined_loss on the pipelined
    tree, whose first step also records its group norms. Every launch
    count and the mesh's traffic are reset just before the steps and read
    just after; then the loss of the updated shards from a forward under
    no_grad."""
    from ray_tpu_torch.parallel import collectives, training

    model = model or models
    mesh = parallel.make_mesh(parallel.MeshSpec(**sizes), device="cuda",
                              backend="gloo")
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    if microbatches:
        params = parallel.to_pipeline_params(params)
        specs = parallel.pipelined_specs(params, mesh)
        loss_fn = parallel.make_pipelined_loss(mesh, cfg, microbatches,
                                               remat=remat)
    elif model is models.vit:
        specs = parallel.shardings_for_tree(params, mesh, parallel.VIT_RULES)
    else:
        specs = _specs(models, parallel, params, mesh)
    shards = parallel.shard_params(params, mesh, specs)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    leaves = models.trainable(shards)
    opt = torch.optim.AdamW(leaves, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.1)
    loss_kw, aux_rec = {}, None
    if model is models.mixtral:
        aux_rec = AuxRecorder(parallel.make_ep_moe_ffn(
            mesh, cfg.top_k, cfg.capacity_factor))
        loss_kw["forward"] = functools.partial(
            models.mixtral.sharded_forward, moe_ffn=aux_rec)
    norms, group_sq = [], []  # the first step's

    def loss_share():
        if microbatches:
            return loss_fn(shards, tokens, specs)
        if model is models.vit:
            return parallel.sharded_vit_loss_fn(shards, tokens, cfg, mesh,
                                                specs=specs)
        return parallel.sharded_loss_fn(
            shards, tokens, cfg, mesh, remat=remat, chunked_vocab=chunked,
            specs=specs, **loss_kw)

    def step():
        opt.zero_grad(set_to_none=True)
        share = loss_share()
        share.backward()
        parallel.allreduce_grads(shards, mesh, specs)
        if not norms:
            norms.append(parallel.global_grad_norm(shards, mesh, specs))
            if microbatches:
                group_sq.append(sharded_group_sq(parallel, shards, mesh,
                                                 specs, cfg))
        opt.step()
        return collectives.allreduce(share.detach(), mesh,
                                     training.SPLIT_AXES)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts reset just before, read just after
    for c in COUNTERS + ("dense_routes",):
        setattr(attention, c, 0)
    mesh.traffic.clear()
    t0 = time.perf_counter()
    losses = [step() for _ in range(SHARDED_STEPS)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts(attention)
    traffic = {k: v / SHARDED_STEPS for k, v in sorted(mesh.traffic.items())}
    # ---- end of the main path
    with torch.no_grad():  # the updated shards' loss
        losses.append(collectives.allreduce(loss_share().detach(), mesh,
                                            training.SPLIT_AXES))
    state = sum(t.numel() * t.element_size() for t in leaves) + sum(
        v.numel() * v.element_size() for st in opt.state.values()
        for v in st.values())
    out = dict(losses=[float(x) for x in losses], grad_norm=float(norms[0]),
               step_ms=(t1 - t0) / SHARDED_STEPS * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               state_gib=(state + sum(t.grad.numel() * t.grad.element_size()
                                      for t in leaves)) / 2**30,
               shard_params=sum(t.numel() for t in leaves),
               traffic_per_step=traffic, **counts)
    if microbatches:
        out["group_sq"] = group_sq[0]
        # what one gather of the stage, the head and the embedding moves:
        # every FSDP-split leaf's shard, once
        spec_of = dict(parallel.sharding.tree_paths(specs))
        split = [t for path, t in parallel.sharding.tree_paths(shards)
                 if "fsdp" in parallel.sharding.spec_axes(spec_of[path])
                 and mesh.shape["fsdp"] > 1]
        out["fsdp_leaves"] = len(split)
        out["fsdp_bytes"] = sum(t.numel() * t.element_size() for t in split)
    if aux_rec is not None:  # the first step's aux, summed over the ranks
        aux = collectives.allreduce(
            torch.stack(aux_rec.aux[:cfg.n_layers]).sum(), mesh,
            training.SPLIT_AXES)
        out["aux"] = float(aux)
        out["ce"] = out["losses"][0] - cfg.aux_coef * out["aux"]
    del shards, leaves, opt, step, loss_share
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mixtral_train_cfg(models):
    """Phases 14 and 12 (e): Mixtral-8x7B's widths at
    MIXTRAL_TRAIN_LAYERS layers; capacity factor E / k for the EP run."""
    cfg = replace(models.MIXTRAL_8X7B, n_layers=MIXTRAL_TRAIN_LAYERS)
    return replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def sharded_rank(rank, tmp, tokens, moe_tokens):
    """Phase 12's body in rank ``rank`` of the 4-process group: (c) the
    small models' runs, then (a), (b), (f), (g), (e) and (h); results to
    ``tmp``. A
    failure raises out of the process, and the parent's spawn raises it."""
    import datetime

    import torch.distributed as dist
    from ray_tpu_torch import models, parallel
    from ray_tpu_torch.ops import attention

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=600))
    try:
        out = {"small": {}, "train": {}}
        for i, (name, run) in enumerate(SHARDED_SMALL_RUNS.items()):
            out["small"][name] = sharded_small(
                models, parallel, attention, *run,
                os.path.join(tmp, f"small{i}.pt"))
        tokens = tokens.to("cuda")
        for name, (sizes, remat, chunked, _, micro) in SHARDED_RUNS.items():
            out["train"][name] = sharded_train(
                models, parallel, attention, models.LLAMA3_1B, tokens,
                sizes, remat, chunked, microbatches=micro)
        out["train"][EP_RUN] = sharded_train(
            models, parallel, attention, mixtral_train_cfg(models),
            moe_tokens.to("cuda"), dict(ep=WORLD), True, 0,
            model=models.mixtral, seed=MIXTRAL_TRAIN_SEED)
        vit_cfg = models.vit.ViTConfig()
        out["train"][VIT_RUN] = sharded_train(
            models, parallel, attention, vit_cfg,
            vit_batch(vit_cfg, VIT_IMAGES, VIT_SEED), VIT_MESH, False, 0,
            model=models.vit, seed=VIT_SEED)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def small_reference(models, attn, remat, chunked, moe, micro, n_shards):
    """Phase 12 (c)'s model on the CPU, whole: loss and gradients (a
    pipelined tree's through loss_fn on its layers unstacked into views).
    For the Mixtral, JAX's expert-parallel loss: the CE of the whole batch
    plus aux_coef times the mean over the ``n_shards`` token shards of
    each shard's aux (each shard's rows through the dense MoE, which
    computes the EP function where nothing is dropped)."""
    from ray_tpu_torch.models.llama import next_token_targets
    from ray_tpu_torch.ops.layers import cross_entropy_loss
    from ray_tpu_torch.parallel import pipeline

    cfg, params, tokens = _small_inputs(models, moe, pipelined=bool(micro))
    leaves = models.trainable(params)
    if micro:
        tree = {k: v for k, v in params.items() if k != "stacked"}
        tree["layers"] = pipeline.unstack_layers(params["stacked"])
        loss = models.loss_fn(tree, {"tokens": tokens}, cfg, remat=remat)
    elif not moe:
        loss = models.loss_fn(params, {"tokens": tokens}, cfg, remat=remat,
                              chunked_vocab=chunked)
    else:
        ce, count, aux = 0.0, 0.0, 0.0
        for rows in tokens.chunk(n_shards):
            logits, a = models.mixtral.forward(params, rows, cfg,
                                               remat=remat)
            mean, n = cross_entropy_loss(logits, next_token_targets(rows))
            ce, count, aux = ce + mean * n, count + n, aux + a
        loss = ce / count + cfg.aux_coef * aux / n_shards
    loss.backward()
    return loss.item(), [t.grad for t in leaves]


def sharded_training(models, parallel, attention, tokens, phase8,
                     moe_tokens, phase14, phase15):
    """Phase 12: 4 processes on this card, each with its own CUDA context,
    in one gloo group (their mesh built with backend="gloo", so every
    collective is staged through host memory). (c) the small fp32 models
    as SHARDED_SMALL_RUNS (the ring, K3; flash_attention, K2; the EP MoE),
    loss and every gathered gradient held to the same model on the CPU;
    (a) and (b) LLAMA3_1B as SHARDED_RUNS, held to phase 8's run of the
    same recipe (``phase8``: name to its result and step count); (e) phase
    14's Mixtral on ep = 4, held to phase 14's run (``phase14``); (h)
    ViT-B/16 on fsdp = 2 x tp = 2, held to phase 15's run (``phase15``);
    (d) the dryrun's launcher, in a thread of its own while the ranks run
    (its processes and its stage actors start beside theirs). Returns (a),
    (b), (e), (f), (g) and (h)'s per-rank results, and (c)'s."""
    import tempfile
    import threading

    import torch.multiprocessing as mp

    log("phase 12: 4 ranks on this one card; the mesh's process groups use "
        "backend='gloo', so every collective is staged through host memory "
        "(a record of the sharded path, not a speed figure for it)")
    torch.cuda.empty_cache()
    dry = {}

    def dryrun():
        t = time.perf_counter()
        try:
            dry["losses"] = parallel.dryrun_multichip(WORLD, device="cuda",
                                                      backend="gloo")
        except BaseException as e:  # raised below, in this thread
            dry["error"] = e
        dry["s"] = time.perf_counter() - t

    dry_thread = threading.Thread(target=dryrun, name="phase12-dryrun")
    t0 = time.perf_counter()
    dry_thread.start()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(sharded_rank, args=(tmp, tokens.cpu(), moe_tokens.cpu()),
                 nprocs=WORLD, join=True)
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        small_grads = [torch.load(os.path.join(tmp, f"small{i}.pt"))
                       for i in range(len(SHARDED_SMALL_RUNS))]
    log(f"phase 12 ranks done in {time.perf_counter() - t0} s")
    for (name, (sizes, attn, remat, chunked, moe, micro)), grads in zip(
            SHARDED_SMALL_RUNS.items(), small_grads):
        shards = math.prod(sizes.get(a, 1) for a in ("dp", "fsdp", "ep"))
        want, want_grads = small_reference(models, attn, remat, chunked,
                                           moe, micro, shards)
        got = [r["small"][name] for r in ranks]
        if not all(abs(g["loss"] - want) <= 1e-5 * abs(want) for g in got):
            raise AssertionError(f"(c) {name}: losses {[g['loss'] for g in got]}"
                                 f", CPU {want}")
        flat = [t for _, t in parallel.sharding.tree_paths(grads)]
        worst = max(hold_grad(g, w, FP32_GRAD_RULE, f"(c) {name} grad {i}")[1]
                    for i, (g, w) in enumerate(zip(flat, want_grads)))
        n = SMALL_CFG["n_layers"]
        if micro:
            expect = pipelined_expect(SMALL_PIPE_LAYERS, sizes["pp"], micro,
                                      1, lockstep=False)
        elif attn == "ring":
            expect = {"stats_launches": n * sizes["sp"]}
        else:
            expect = {"launches": 2 * n, "bwd_launches": n}
        for r, g in enumerate(got):
            counts = {c: g[c] for c in COUNTERS + ("dense_routes",)}
            if counts != {c: expect.get(c, 0) for c in counts}:
                raise AssertionError(f"(c) {name} rank {r}: launches "
                                     f"{counts}, expected {expect}")
        log(f"phase 12 (c) {name}: loss {got[0]['loss']} (CPU {want}), "
            f"{len(flat)} gathered gradients, worst element {worst} of rule "
            f"{FP32_GRAD_RULE}; local heads {got[0]['local_heads']}; "
            f"launches per rank {expect}")
    results = {}
    runs = [(name, recipe, micro, phase8[recipe])
            for name, (*_, recipe, micro) in SHARDED_RUNS.items()]
    # phases 14 and 15 each ran 1 + 2 steps
    runs.append((EP_RUN, "phase 14", None, (phase14, 3)))
    runs.append((VIT_RUN, "phase 15", None, (phase15, 3)))
    steps = SHARDED_STEPS
    for name, recipe, micro, (ref, ref_steps) in runs:
        got = [r["train"][name] for r in ranks]
        first, norm = got[0]["losses"][0], got[0]["grad_norm"]
        if not all(g["losses"] == got[0]["losses"] for g in got):
            raise AssertionError(f"{name}: ranks' losses differ: "
                                 f"{[g['losses'] for g in got]}")
        if micro:
            sizes = SHARDED_RUNS[name][0]
            hold_pipelined(f"phase 12 {name}", first, norm,
                           got[0]["group_sq"], ref, sizes["pp"])
        else:
            held = [("first loss", first, ref["losses"][0])]
            if "ce" in ref:
                held.append(("CE", got[0]["ce"], ref["ce"]))
            rtol = VIT_RTOL if name == VIT_RUN else 1e-2
            for what, x, want in held:
                if not abs(x - want) <= rtol * abs(want):
                    raise AssertionError(f"{name}: {what} {x}, {recipe}'s "
                                         f"{want}")
            if not abs(norm - ref["grad_norm"]) <= 1e-2 * ref["grad_norm"]:
                raise AssertionError(f"{name}: first gradient norm {norm}, "
                                     f"{recipe}'s {ref['grad_norm']}")
        losses = got[0]["losses"]  # the last, the updated shards' loss
        if not (all(math.isfinite(x) for x in losses) and len(losses) > 1
                and all(x < losses[0] for x in losses[1:])):
            raise AssertionError(f"{name}: losses {losses} not finite and "
                                 f"below the first")
        if micro:  # every stage on every tick: the schedule's count
            expect = pipelined_expect(models.LLAMA3_1B.n_layers, sizes["pp"],
                                      micro, steps, lockstep=False)
        else:
            expect = {c: ref.get(c, 0) * steps // ref_steps
                      for c in COUNTERS}
        expect = {c: expect.get(c, 0) for c in COUNTERS}
        expect["dense_routes"] = 0
        for r, g in enumerate(got):
            counts = {c: g[c] for c in expect}
            if counts != expect:
                raise AssertionError(f"{name} rank {r}: launches {counts}, "
                                     f"expected {expect}")
        log(f"phase 12 {name}: losses {losses} ({recipe}'s first "
            f"{ref['losses'][0]}, gap {first - ref['losses'][0]}); first "
            f"gradient norm {norm} ({recipe}'s {ref['grad_norm']}, ratio "
            f"{norm / ref['grad_norm']}); launches per rank {expect} over "
            f"{steps} steps")
        if "ce" in ref:
            log(f"phase 12 {name}: first CE {got[0]['ce']} ({recipe}'s "
                f"{ref['ce']}), aux over the token shards {got[0]['aux']} "
                f"({recipe}'s, over the whole batch, {ref['aux']})")
        if micro:
            hold_pipeline_traffic(name, sizes, micro, tokens,
                                  models.LLAMA3_1B.d_model, got)
        for r, g in enumerate(got):
            log(f"phase 12 {name} rank {r}: {g['step_ms']} ms/step over "
                f"{steps} step (the first: its warm-up included), peak "
                f"memory {g['peak_gib']} GiB, state {g['state_gib']}"
                f" GiB ({g['shard_params']} parameters), per step "
                f"{json.dumps(g['traffic_per_step'])}")
        results[name] = got
    # (e)'s exchanges: a layer's dispatch and return, each in the forward,
    # remat's recompute and the backward; each an fp32 [E, C, D] buffer.
    cfg = mixtral_train_cfg(models)
    capacity = parallel.moe.default_capacity(
        moe_tokens.numel() // WORLD, cfg.n_experts, cfg.top_k,
        cfg.capacity_factor)
    calls = 6 * cfg.n_layers
    expect = (calls, calls * cfg.n_experts * capacity * cfg.d_model * 4)
    for r, g in enumerate(results[EP_RUN]):
        traffic = g["traffic_per_step"]
        if (traffic.get("alltoall"), traffic.get("alltoall_bytes")) != expect:
            raise AssertionError(f"{EP_RUN} rank {r}: all-to-all per step "
                                 f"{traffic.get('alltoall')} calls, "
                                 f"{traffic.get('alltoall_bytes')} bytes; "
                                 f"expected {expect}")
    t0 = time.perf_counter()
    dry_thread.join()
    if "error" in dry:
        raise dry["error"]
    losses = dry["losses"]
    if set(losses) != {"sharded", "pipeline", "moe", "multihost", "mpmd"}:
        raise AssertionError(f"phase 12 (d): the dryrun ran {sorted(losses)}")
    log(f"phase 12 (d) dryrun_multichip({WORLD}) on this card (gloo), beside "
        f"the ranks: losses {json.dumps(losses)} in {dry['s']} s (waited "
        f"{time.perf_counter() - t0} s for it after the ranks' holds)")
    return results, {name: [r["small"][name] for r in ranks]
                     for name in SHARDED_SMALL_RUNS}


async def serve_requests(server, requests):
    """The requests at once through ``server``: each one's tokens, and the
    streamed one's first token's time after they were sent."""
    t0 = time.perf_counter()
    first = []

    async def one(body):
        if not body.get("stream"):
            return (await server(body))["tokens"]
        toks = []
        async for tok in await server(body):
            if not first:
                first.append(time.perf_counter() - t0)
            toks.append(tok)
        return toks

    outs = await asyncio.gather(*[one(b) for b in requests])
    return outs, (first[0] if first else None)


# Phase 17: the runtime's trainer. LLAMA3_1B is trained by
# ray_tpu_torch.train.TorchTrainer in worker actors that the runtime pins
# to the card, from phase 8's weights (seed 7) and tokens, through K2.
RUNTIME_STEPS = 3
# (a)'s losses against phase 8's in-process run on the same card and
# kernels (no atomics): the same function of the same bits.
RUNTIME_LOSS_RTOL = 1e-6
# (c)'s first loss and gradient norm against (a)'s: phase 12's 1e-2, and
# within it the gaps predicted before the first run for two halves of the
# batch whose gradients gloo sums in fp32. Both ranks on one half would
# miss them.
RUNTIME_DP_LOSS_RTOL = 1e-5
RUNTIME_DP_NORM_RTOL = 1e-4


def runtime_loop(cfg):
    """The worker's loop (shipped by value): phase 8's dense step on the
    worker's own card, or on a gloo mesh over ``dp`` (each rank a half of
    the batch, gradients summed by allreduce_grads); a checkpoint of the
    parameters and AdamW state after step ``checkpoint_after``; with
    ``die_after``, an exit just after that step on the first attempt; with
    ``later_loss``, the updated weights' loss from a forward under no_grad
    after the last step. Each step's launches are counted from 0."""
    import os
    import time

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import models, parallel, train
    from ray_tpu_torch.ops import attention

    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    mcfg = models.LLAMA3_1B
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    params = models.init_params(mcfg, gen, device="cuda")
    leaves = models.trainable(params)
    opt = torch.optim.AdamW(leaves, lr=cfg["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1)
    tokens = ray_tpu_torch.get(cfg["tokens"]).to("cuda")
    mesh = None
    if world > 1:
        mesh = parallel.make_mesh(parallel.MeshSpec(dp=world),
                                  device="cuda", backend="gloo")
    hist = {"losses": [], "grad_norms": [], "step_s": [], "report_t": [],
            "enter_t": [t_enter], "restore_s": None, "save_s": None,
            "ckpt_bytes": None, "step_counts": [], "later_loss": None}
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        state = train.load_pytree(ckpt.path, device="cuda")
        with torch.no_grad():
            for t, saved in zip(leaves, state["leaves"]):
                t.copy_(saved)
        opt.load_state_dict(state["opt"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        hist, start = state["hist"], state["step"]
        hist["enter_t"].append(t_enter)
        # when the first attempt's checkpoint was complete (its file's
        # last write), for the restart's time
        state_file = os.path.join(ckpt.path, "state.pt")
        hist["saved_t"] = os.path.getmtime(state_file)
        hist["ckpt_bytes"] = os.path.getsize(state_file)
        hist["restore_s"] = restore_s
        del state

    def loss_share():
        if mesh is None:
            return models.loss_fn(params, {"tokens": tokens}, mcfg,
                                  attn_impl=None, remat=False)
        return parallel.sharded_loss_fn(params, tokens, mcfg, mesh)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(start, cfg["steps"]):
        for c in cfg["counters"]:
            setattr(attention, c, 0)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_share()
        loss.backward()
        if mesh is None:
            total = loss.detach()
        else:
            parallel.allreduce_grads(leaves, mesh)
            total = parallel.collectives.allreduce(loss.detach(), mesh)
        if step == 0:
            # the first step's gradient norm, where phase 8 takes it (it
            # reads every gradient once more, so no later step does)
            norm = (parallel.global_grad_norm(leaves, mesh) if mesh else
                    torch.stack([t.grad.float().square().sum()
                                 for t in leaves]).sum().sqrt())
            hist["grad_norms"].append(float(norm))
        opt.step()
        torch.cuda.synchronize()
        hist["step_s"].append(time.perf_counter() - t0)
        hist["losses"].append(float(total))
        hist["step_counts"].append({c: getattr(attention, c)
                                    for c in cfg["counters"]})
        if cfg.get("later_loss") and step + 1 == cfg["steps"]:
            with torch.no_grad():
                later = loss_share().detach()
                if mesh is not None:
                    later = parallel.collectives.allreduce(later, mesh)
            hist["later_loss"] = float(later)
        hist["report_t"].append(time.time())
        checkpoint = None
        if step + 1 == cfg["checkpoint_after"]:
            path = os.path.join(ctx.get_storage_path(), ctx.get_trial_name(),
                                f"checkpoint_{step:06d}")
            t0 = time.perf_counter()
            hist["ckpt_bytes"] = train.save_pytree(
                {"leaves": [t.detach() for t in leaves],
                 "opt": opt.state_dict(), "hist": hist, "step": step + 1},
                path)
            hist["save_s"] = time.perf_counter() - t0
            checkpoint = train.Checkpoint(path)
        train.report({
            **hist, "rank": rank, "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": torch.cuda.get_device_name(0),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            **{c: sum(n[c] for n in hist["step_counts"])
               for c in cfg["counters"]}},
            checkpoint=checkpoint)
        if cfg["die_after"] == step + 1 and ckpt is None:
            os._exit(1)  # the planted death, first attempt only


def _session_log_tails(lines: int = 40, root: str = "") -> str:
    """The last lines of the port's session logs (and jobs' logs) under
    ``root`` (RAY_TPU_TORCH_TMPDIR unless given), for a failed phase."""
    import glob

    root = root or os.environ.get("RAY_TPU_TORCH_TMPDIR", "")
    out = []
    for path in sorted(glob.glob(os.path.join(root, "session_*", "*.out"))
                       + glob.glob(os.path.join(root, "session_*",
                                                "job-*.log"))):
        with open(path, errors="replace") as f:
            tail = f.read().splitlines()[-lines:]
        out.append(f"--- {path}\n" + "\n".join(tail))
    return "\n".join(out)


def runtime_training(tokens, dense):
    """Phase 17: ray_tpu_torch.init(num_cpus=4, num_gpus=1), then
    TorchTrainer runs (a) one worker with the card, 3 steps, held to phase
    8's losses and launches, (b) in the same run with a checkpoint after
    step 2, a planted exit just after it and FailureConfig(max_failures=
    1), step 3 held to phase 8's bit for bit; (c) two workers at
    num_gpus=0.5 on gloo, one step, held to (a)'s first loss and gradient
    norm by phase 12's rules, the updated weights' loss below the first.
    The cluster is shut down at the end, failures included."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import train

    os.environ.setdefault("RAY_TPU_TORCH_TMPDIR",
                          tempfile.mkdtemp(prefix="rtt"))
    storage = tempfile.mkdtemp(prefix="rtt_runs")
    per_step = {c: dense[c] // 6 for c in COUNTERS}
    out = {}
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        log(f"phase 17: cluster up in {time.perf_counter() - t0} s: "
            f"{ray_tpu_torch.cluster_resources()}")
        base = {"seed": 7, "lr": LR, "tokens": ray_tpu_torch.put(
            tokens.cpu()), "steps": RUNTIME_STEPS, "checkpoint_after": 2,
            "die_after": 0, "counters": COUNTERS}

        def fit(name, workers, share, backend=None, failures=0, **kw):
            trainer = train.TorchTrainer(
                runtime_loop, train_loop_config={**base, **kw},
                scaling_config=train.ScalingConfig(
                    num_workers=workers, use_gpu=True,
                    gpus_per_worker=share),
                run_config=train.RunConfig(
                    name=name, storage_path=storage,
                    failure_config=train.FailureConfig(
                        max_failures=failures)),
                torch_backend=backend)
            t_fit = time.time()
            result = trainer.fit()
            if result.error is not None:
                raise AssertionError(f"phase 17 {name}: {result.error}")
            ranks = result.metrics_all_workers
            m = ranks[0]
            log(f"phase 17 {name}: worker start {m['enter_t'][0] - t_fit}"
                f" s after fit(), first report {m['report_t'][0] - t_fit} "
                f"s after fit(); fit() took {time.time() - t_fit} s")
            return result, ranks, t_fit

        # (a) and (b): one worker with the card, 3 steps, a checkpoint
        # after step 2, a planted exit just after it and one restart
        result, ranks, _ = fit("one_gpu", 1, 1.0, failures=1, die_after=2)
        a = ranks[0]
        want = dense["losses"][:RUNTIME_STEPS]
        diff = [abs(x - w) / abs(w) for x, w in zip(a["losses"], want)]
        log(f"phase 17 (a): losses {a['losses']}, phase 8's {want}, "
            f"relative differences {diff}; gradient norm "
            f"{a['grad_norms'][0]}, phase 8's {dense['grad_norm']}")
        if len(a["losses"]) != RUNTIME_STEPS or \
                not all(d <= RUNTIME_LOSS_RTOL for d in diff):
            raise AssertionError(f"phase 17 (a): losses {a['losses']}, "
                                 f"phase 8's {want}")
        counts = {c: a[c] for c in COUNTERS}
        if a["step_counts"] != [per_step] * RUNTIME_STEPS or \
                not counts["launches"] or not counts["bwd_launches"]:
            raise AssertionError(f"phase 17 (a): launches by step "
                                 f"{a['step_counts']}, phase 8's rate "
                                 f"{per_step}")
        if a["gpu_ids"] != ["0"] or a["visible"] != "0":
            raise AssertionError(f"phase 17 (a): worker pinned to "
                                 f"{a['gpu_ids']}, CUDA_VISIBLE_DEVICES "
                                 f"{a['visible']!r}")
        step_ms = [x * 1e3 for x in a["step_s"]]
        log(f"phase 17 (a): launches {counts} ({per_step} a step); worker "
            f"on {a['device']} pinned to {a['gpu_ids']} "
            f"(CUDA_VISIBLE_DEVICES {a['visible']}); ms/step {step_ms} "
            f"(steps 2-3 mean {sum(step_ms[1:]) / len(step_ms[1:])}; step 3 "
            f"on the restored worker) against phase 8's {dense['step_ms']}; "
            f"peak memory {a['peak_gib']} GiB (the restored worker's)")
        out["a"] = dict(a, step_ms=step_ms, **counts)

        # (b) the restart from step 2's checkpoint, in the same run: the
        # same kernels with no atomics give phase 8's bits
        if a["losses"][2] != want[2] or a["restore_s"] is None:
            raise AssertionError(f"phase 17 (b): step 3's loss "
                                 f"{a['losses'][2]} after the restart, "
                                 f"phase 8's {want[2]}")
        # from the end of step 2's checkpoint (the planted exit follows
        # its report) to step 3's report on the restored worker
        saved_t = a["saved_t"]
        restart_s = a["report_t"][2] - saved_t
        log(f"phase 17 (b): step 3's loss {a['losses'][2]} equals phase "
            f"8's {want[2]} bit for bit; the restart took {restart_s} s "
            f"from step 2's checkpoint to step 3's report (the new worker "
            f"entered its loop {a['enter_t'][1] - saved_t} s after the "
            f"checkpoint, restored {a['ckpt_bytes'] / 1e9} GB in "
            f"{a['restore_s']} s); checkpoint written in "
            f"{saved_t - a['report_t'][1]} s")
        out["b"] = dict(a, restart_s=restart_s)
        shutil.rmtree(os.path.join(storage, "one_gpu"), ignore_errors=True)

        # (c) two workers sharing the card, gloo, one step and the
        # updated weights' loss
        result, ranks, _ = fit("two_half_gpus", 2, 0.5, backend="gloo",
                               steps=1, checkpoint_after=0, later_loss=True)
        c0, c1 = ranks[0], ranks[1]
        if sorted(r["rank"] for r in ranks.values()) != [0, 1] or \
                c0["gpu_ids"] != ["0"] or c1["gpu_ids"] != ["0"] or \
                c0["visible"] != c1["visible"]:
            raise AssertionError(f"phase 17 (c): ranks {ranks}")
        first, norm = c0["losses"][0], c0["grad_norms"][0]
        loss_gap = abs(first - a["losses"][0]) / a["losses"][0]
        norm_gap = abs(norm - a["grad_norms"][0]) / a["grad_norms"][0]
        later = c0["later_loss"]
        if c1["losses"] != c0["losses"] or c1["later_loss"] != later or \
                not loss_gap <= min(1e-2, RUNTIME_DP_LOSS_RTOL) or \
                not norm_gap <= min(1e-2, RUNTIME_DP_NORM_RTOL) or \
                not (math.isfinite(later) and later < first):
            raise AssertionError(
                f"phase 17 (c): losses {c0['losses']} / {c1['losses']}, "
                f"updated {later} / {c1['later_loss']}, "
                f"norm {norm}; (a)'s {a['losses'][0]}, "
                f"{a['grad_norms'][0]}; relative gaps {loss_gap} (limit "
                f"{RUNTIME_DP_LOSS_RTOL}) and {norm_gap} (limit "
                f"{RUNTIME_DP_NORM_RTOL})")
        log(f"phase 17 (c): ranks 0 and 1 both pinned to {c0['gpu_ids']}; "
            f"losses {c0['losses']} (first {first} against (a)'s "
            f"{a['losses'][0]}, relative gap {loss_gap}, limit "
            f"{RUNTIME_DP_LOSS_RTOL}; the updated weights' {later}, below "
            f"it), gradient norm {norm} against "
            f"{a['grad_norms'][0]} (relative gap {norm_gap}, limit "
            f"{RUNTIME_DP_NORM_RTOL}); ms/step "
            f"{[x * 1e3 for x in c0['step_s']]}; peak memory "
            f"{[r['peak_gib'] for r in ranks.values()]} GiB")
        out["c"] = dict(c0)
    except BaseException:
        log(_session_log_tails())
        raise
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    log(f"phase 17 done in {time.perf_counter() - t0} s")
    return out


# Phase 18: the Serve runtime. The replicas draw their weights from these
# seeds on the card; the driver draws the same ones for its in-process
# reference servers, after each replica is gone.
SERVE_SEED = 18
REFRESH_SEEDS = (19, 20)  # the 1B replica's weights, then the refresh's
REFRESH_PROMPT = 64
REFRESH_NEW = 24


def seeded_llama(name: str, seed: int):
    """A model factory, shipped by value to a replica: ``models.<name>``
    drawn on the card from a torch.Generator("cuda") seeded with
    ``seed``."""
    def factory():
        import torch
        from ray_tpu_torch import models

        cfg = getattr(models, name)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return models.init_params(cfg, gen, device="cuda"), cfg

    return factory


def pinned_llm_server():
    """LLMServer with one op more, ``probe``: the cards the replica was
    pinned to and its K1 launches. Shipped by value; the package has no
    such op."""
    from ray_tpu_torch.serve.llm import LLMServer

    class PinnedLLMServer(LLMServer):
        def probe(self):
            import os

            import torch

            import ray_tpu_torch
            from ray_tpu_torch.ops import attention

            return {"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "launches": attention.launches,
                    "device": torch.cuda.get_device_name(0)}

    return PinnedLLMServer


def _send_handle(handle):
    def send(body):
        t0 = time.perf_counter()
        if not body.get("stream"):
            return handle.remote(body).result(timeout=600)["tokens"], None

        async def consume():
            toks, first = [], None
            async for tok in handle.stream(body):
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(tok)
            return toks, first

        return asyncio.run(consume())

    return send


def _send_rpc(port, route):
    from ray_tpu_torch.serve.rpc_client import ServeRpcClient

    def send(body):
        t0 = time.perf_counter()
        with ServeRpcClient(port=port, timeout=600) as client:
            if not body.get("stream"):
                return client.call(route, body)["tokens"], None
            toks, first = [], None
            for tok in client.stream(route, body):
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(tok)
            return toks, first

    return send


def _send_http(port, route):
    import urllib.request

    def send(body):
        t0 = time.perf_counter()
        headers = {"Content-Type": "application/json"}
        if body.get("stream"):
            headers["Accept"] = "text/event-stream"
        req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                     data=json.dumps(body).encode(),
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=600) as resp:
            if not body.get("stream"):
                return json.loads(resp.read())["tokens"], None
            toks, first = [], None
            for line in resp:
                if line.startswith(b"data: "):
                    if first is None:
                        first = time.perf_counter() - t0
                    toks.append(json.loads(line[len(b"data: "):]))
            return toks, first

    return send


def drive_route(name, send, probe, requests, vocab, per_route):
    """Phase 18 (a): the six requests at once over one route; the
    replica's K1 launches read before and after."""
    before = probe()["launches"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(requests)) as pool:
        outs = list(pool.map(send, requests))
    wall = time.perf_counter() - t0
    launches = probe()["launches"] - before
    toks = [o[0] for o in outs]
    for body, got in zip(requests, toks):
        if len(got) != body["max_new_tokens"] or \
                not all(0 <= t < vocab for t in got):
            raise AssertionError(f"phase 18 {name}: bad response {got} for "
                                 f"a prompt of {len(body['prompt'])}")
    if launches != per_route:
        raise AssertionError(f"phase 18 {name}: the replica launched K1 "
                             f"{launches} times, expected {per_route}")
    ttft = next(o[1] for o in outs if o[1] is not None)
    n_tok = sum(len(t) for t in toks)
    log(f"phase 18 (a) {name}: {len(requests)} requests, {n_tok} tokens in "
        f"{wall} s = {n_tok / wall} tokens/s; the streamed request's first "
        f"token {ttft} s after it was sent (client side); the replica's K1 "
        f"launches {launches}")
    return {"tokens": toks, "tokens_per_s": n_tok / wall, "ttft_s": ttft,
            "launches": launches}


def _replicas_gone(rt, timeout=120.0, what="phase 18"):
    """Wait until the cluster's card is free again: the deleted replica's
    (or the trainer's workers') actor has died and its GPU share is
    back."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if abs(rt.available_resources().get("GPU", 0.0) - 1.0) < 1e-6:
            return
        time.sleep(0.2)
    raise AssertionError(f"{what}: the card was not freed: "
                         f"{rt.available_resources()}")


def serve_runtime(models, requests):
    """Phase 18 (see the module docstring): (a) LLAMA3_8B from a replica
    pinned to the card over every route, (b) a weight refresh over the
    object plane in a LLAMA3_1B replica. Returns the replica's K1
    launches."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import LLMServer
    from ray_tpu_torch.serve.proxy import ProxyActor

    try:
        import aiohttp  # noqa: F401 - only whether it is installed
        http = True
    except ImportError:
        http = False
    os.environ.setdefault("RAY_TPU_TORCH_TMPDIR",
                          tempfile.mkdtemp(prefix="rtt"))
    cls = pinned_llm_server()
    cfg = models.LLAMA3_8B
    per_route = cfg.n_layers * len(requests)
    out = {}
    t_phase = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, object_store_memory=8 << 30)
    try:
        # (a) LLAMA3_8B from a replica pinned to the card
        app = serve.deployment(cls).options(
            ray_actor_options={"num_gpus": 1}).bind(
            seeded_llama("LLAMA3_8B", SERVE_SEED), max_slots=4,
            max_len=1024)
        t0 = time.perf_counter()
        handle = serve.run(app, name="llm8b",
                           route_prefix="/llm" if http else None)
        ready_s = time.perf_counter() - t0
        if http:
            rpc_port = serve.get_rpc_port()
        else:
            proxy = ProxyActor.remote()
            rpc_port = ray_tpu_torch.get(proxy.start_rpc.remote())
            ray_tpu_torch.get(proxy.register.remote(
                "/llm", "llm8b", "PinnedLLMServer"))
        probe = handle.probe.remote().result(timeout=600)
        log(f"phase 18 (a): serve.run to the replica ready {ready_s} s; "
            f"replica on {probe['device']} pinned to {probe['gpu_ids']} "
            f"(CUDA_VISIBLE_DEVICES {probe['visible']}); HTTP proxy "
            + ("up" if http else "not started: aiohttp is not installed "
               "here, so HTTP was held by the CPU tests alone"))
        if probe["gpu_ids"] != ["0"] or probe["visible"] != "0":
            raise AssertionError(f"phase 18 (a): replica pinned to "
                                 f"{probe['gpu_ids']}, CUDA_VISIBLE_DEVICES "
                                 f"{probe['visible']!r}")

        def read_probe():
            return handle.probe.remote().result(timeout=600)

        # one short request first, as phase 4's server runs after a
        # forward: the replica's first prefill loads cuBLAS and the kernel
        t0 = time.perf_counter()
        handle.remote({"prompt": requests[0]["prompt"],
                       "max_new_tokens": 2}).result(timeout=600)
        log(f"phase 18 (a): the replica's warm-up request took "
            f"{time.perf_counter() - t0} s, K1 launches "
            f"{read_probe()['launches']}")

        routes = {"handle": _send_handle(handle),
                  "rpc": _send_rpc(rpc_port, "/llm")}
        if http:
            routes["http"] = _send_http(serve.get_proxy_port(), "/llm")
        got = {name: drive_route(name, send, read_probe,
                                 [dict(r) for r in requests],
                                 cfg.vocab_size, per_route)
               for name, send in routes.items()}
        out["launches"] = read_probe()["launches"]
        serve.delete("llm8b")
        _replicas_gone(ray_tpu_torch)

        # the in-process reference on the same weights, the replica gone
        params, _ = seeded_llama("LLAMA3_8B", SERVE_SEED)()
        server = LLMServer(lambda: (params, cfg), max_slots=4,
                           max_len=1024)
        t0 = time.perf_counter()
        want, ref_ttft = asyncio.run(serve_requests(
            server, [dict(r) for r in requests]))
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        n_tok = sum(len(t) for t in want)
        agree = {name: [near_tie_agreement(
            models, params, cfg, body["prompt"], w, g,
            f"phase 18 (a) {name}, prompt of {len(body['prompt'])}")[0]
            for body, w, g in zip(requests, want, run["tokens"])]
            for name, run in got.items()}
        log(f"phase 18 (a): the in-process server on the same weights, "
            f"{n_tok / ref_s} tokens/s, the streamed request's first token "
            f"after {ref_ttft} s; each route's tokens held to its by "
            f"the near-tie rule, leading tokens equal {json.dumps(agree)} "
            f"of {[r['max_new_tokens'] for r in requests]}")
        del params, server
        gc.collect()
        torch.cuda.empty_cache()

        # (b) a weight refresh over the object plane, LLAMA3_1B
        cfg1 = models.LLAMA3_1B
        app = serve.deployment(cls).options(
            ray_actor_options={"num_gpus": 1}).bind(
            seeded_llama("LLAMA3_1B", REFRESH_SEEDS[0]), max_slots=4,
            max_len=256)
        handle = serve.run(app, name="llm1b", route_prefix=None)
        new, _ = seeded_llama("LLAMA3_1B", REFRESH_SEEDS[1])()
        nbytes = sum(t.numel() * t.element_size()
                     for t in models.trainable(new))
        t0 = time.perf_counter()
        host = _host_copy(new)
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(host)
        put_s = time.perf_counter() - t0
        del host
        t0 = time.perf_counter()
        handle.reconfigure.remote({"weights_ref": ref}).result(timeout=600)
        refresh_s = time.perf_counter() - t0
        stats = handle.remote({"_admin": "stats"}).result(timeout=600)
        prompt = torch.randint(0, cfg1.vocab_size, (REFRESH_PROMPT,),
                               generator=torch.Generator().manual_seed(
                                   REFRESH_SEEDS[1])).tolist()
        body = {"prompt": prompt, "max_new_tokens": REFRESH_NEW}
        after = handle.remote(dict(body)).result(timeout=600)["tokens"]
        probe = handle.probe.remote().result(timeout=600)
        serve.delete("llm1b")
        if stats["weights_version"] != 2 or probe["gpu_ids"] != ["0"]:
            raise AssertionError(f"phase 18 (b): stats {stats}, replica "
                                 f"pinned to {probe['gpu_ids']}")
        server = LLMServer(lambda: (new, cfg1), max_slots=4, max_len=256)
        want = asyncio.run(server(dict(body)))["tokens"]
        n, margin = near_tie_agreement(models, new, cfg1, prompt, want,
                                       after, "phase 18 (b) refresh")
        log(f"phase 18 (b): {nbytes / 1e9} GB of LLAMA3_1B weights copied "
            f"off the card in {copy_s} s and put in {put_s} s, the "
            f"replica's refresh over the object plane took "
            f"{refresh_s} s = {nbytes / refresh_s / 1e9} GB/s; "
            f"weights_version {stats['weights_version']}; its greedy tokens "
            f"agree with an in-process server on the new weights for "
            f"{n} of {REFRESH_NEW} (near-tie margin {margin})")
        out.update(refresh_s=refresh_s, refresh_gb=nbytes / 1e9,
                   ready_s=ready_s, http=http, in_process_ttft_s=ref_ttft,
                   in_process_tokens_per_s=n_tok / ref_s,
                   routes={k: {f: v[f] for f in ("tokens_per_s", "ttft_s")}
                           for k, v in got.items()})
        del new, server
    except BaseException:
        log(_session_log_tails())
        raise
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    log(f"phase 18 done in {time.perf_counter() - t_phase} s")
    return out


# Phase 19: the data ingest path. (a) LLAMA3_1B is trained by TorchTrainer
# in a worker pinned to the card from its dataset shard: INGEST_ROWS rows
# of 2048 int32 tokens drawn with numpy from INGEST_SEED, in INGEST_BLOCKS
# blocks through a map_batches task, INGEST_BATCH rows a step, phase 8's
# weights (seed 7) and step; (b) two workers at num_gpus=0.5 on gloo train
# a small fp32 regression through prepare_model (DDP) on their shards;
# (c) the rate at which the driver's iter_torch_batches feeds the card.
INGEST_ROWS = 16
INGEST_BLOCKS = 4
INGEST_BATCH = 4
INGEST_SEED = 19
DDP_ROWS, DDP_BLOCKS, DDP_BATCH, DDP_SEED = 4096, 8, 256, 23
DDP_LOADER_ROWS = 1024
# (b)'s averaged gradient against the driver's over the same 512 rows:
# fp32 on both sides, the sums over rows taken in another order (gloo adds
# the ranks' means), so a few fp32 roundings of the largest element.
DDP_GRAD_RTOL = 1e-5
RATE_SHAPE = (131072, 2048)  # 1 GiB of int32 tokens
RATE_BLOCKS = 64
RATE_BATCH = 64


def ingest_loop(cfg):
    """Phase 19 (a)'s worker loop (shipped by value): phase 8's dense step
    on the batches of the worker's dataset shard, steps 1-2 through
    iter_torch_batches' default device ("auto") and steps 3-4 through an
    explicit device=train.torch.get_device(); each batch is held to the
    rows it must be before its step."""
    import itertools
    import time

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import models, train
    from ray_tpu_torch.ops import attention

    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = models.LLAMA3_1B
    device = train.torch.get_device()
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    params = models.init_params(mcfg, gen, device="cuda")
    leaves = models.trainable(params)
    opt = torch.optim.AdamW(leaves, lr=cfg["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1)
    rows = np.array(ray_tpu_torch.get(cfg["rows"]))
    shard = train.get_dataset_shard("train")
    steps, size, half = cfg["steps"], cfg["batch"], cfg["steps"] // 2
    kw = dict(batch_size=size, dtypes={"tokens": torch.int64},
              drop_last=True)
    hist = {"losses": [], "step_s": [], "wait_s": [], "report_t": [],
            "enter_t": t_enter, "batches": [], "get_device": str(device),
            "gpu_ids": ray_tpu_torch.get_gpu_ids()}
    torch.cuda.synchronize()
    # ---- the main path: counts reset just before, read just after
    for c in cfg["counters"]:
        setattr(attention, c, 0)
    auto = shard.iter_torch_batches(**kw)
    explicit = shard.iter_torch_batches(device=train.torch.get_device(),
                                        **kw)
    batches = itertools.chain(itertools.islice(auto, half),
                              itertools.islice(explicit, half, steps))
    for k in range(steps):
        t0 = time.perf_counter()
        tokens = next(batches)["tokens"]
        hist["wait_s"].append(time.perf_counter() - t0)
        want = torch.from_numpy(rows[k * size:(k + 1) * size]).to(
            tokens.device, torch.int64)
        hist["batches"].append({
            "device": str(tokens.device), "dtype": str(tokens.dtype),
            "shape": list(tokens.shape), "equal": bool(torch.equal(
                tokens, want)), "row_sums": tokens.sum(dim=1).tolist()})
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = models.loss_fn(params, {"tokens": tokens}, mcfg,
                              attn_impl=None, remat=False)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        hist["step_s"].append(time.perf_counter() - t0)
        hist["losses"].append(float(loss.detach()))
        hist["report_t"].append(time.time())
        train.report({**hist, **{c: getattr(attention, c)
                                 for c in cfg["counters"]}})
    # ---- end of the main path (the last report read the counts)


def ddp_loop(cfg):
    """Phase 19 (b)'s worker loop (shipped by value): the rank's shard's
    ids, one DDP step of a small fp32 model (prepare_model) on its first
    batch, and the indices prepare_data_loader hands this rank."""
    import torch
    import torch.nn.functional as F
    from torch.nn.parallel import DistributedDataParallel

    import ray_tpu_torch
    from ray_tpu_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shard = train.get_dataset_shard("train")
    ids, first = [], None
    for batch in shard.iter_torch_batches(batch_size=cfg["batch"]):
        first = first or batch
        ids += batch["id"].tolist()
    torch.manual_seed(cfg["seed"])
    model = train.torch.prepare_model(torch.nn.Sequential(
        torch.nn.Linear(16, 64), torch.nn.Tanh(), torch.nn.Linear(64, 1)))
    loss = F.mse_loss(model(first["x"]).squeeze(-1), first["y"])
    train.torch.backward(loss)
    loader = train.torch.prepare_data_loader(torch.utils.data.DataLoader(
        torch.utils.data.TensorDataset(torch.arange(cfg["loader_rows"])),
        batch_size=32))
    ddp = isinstance(model, DistributedDataParallel)
    train.report({
        "rank": train.get_context().get_world_rank(), "ids": ids,
        "first_ids": first["id"].tolist(),
        "batch_device": str(first["x"].device), "ddp": ddp,
        "device_ids": model.device_ids if ddp else None,
        "param_devices": sorted({str(p.device)
                                 for p in model.parameters()}),
        "get_device": str(train.torch.get_device()),
        "gpu_ids": ray_tpu_torch.get_gpu_ids(),
        "grads": [p.grad.cpu().numpy() for p in model.parameters()],
        "loader_ids": [int(i) for (b,) in loader for i in b]})


def ingest_reference(models, rows, seed):
    """Phase 19 (a)'s losses in process: phase 8's dense step from seed
    ``seed`` on the same batches of ``rows`` in order."""
    cfg = models.LLAMA3_1B
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = models.init_params(cfg, gen, device="cuda")
    leaves = models.trainable(params)
    opt = torch.optim.AdamW(leaves, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.1)
    losses = []
    for k in range(len(rows) // INGEST_BATCH):
        tokens = torch.from_numpy(
            rows[k * INGEST_BATCH:(k + 1) * INGEST_BATCH]).to(
            "cuda", torch.int64)
        opt.zero_grad(set_to_none=True)
        loss = models.loss_fn(params, {"tokens": tokens}, cfg,
                              attn_impl=None, remat=False)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    del params, leaves, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def ddp_reference(x, y, seed):
    """Phase 19 (b)'s gradient in process: the same fp32 model on the card
    and the mean loss over all of ``x``."""
    import torch.nn.functional as F

    torch.manual_seed(seed)
    model = torch.nn.Sequential(
        torch.nn.Linear(16, 64), torch.nn.Tanh(),
        torch.nn.Linear(64, 1)).to("cuda")
    loss = F.mse_loss(model(torch.from_numpy(x).cuda()).squeeze(-1),
                      torch.from_numpy(y).cuda())
    loss.backward()
    return [p.grad.cpu().numpy() for p in model.parameters()]


def ingest_rate(rd, vocab):
    """Phase 19 (c): RATE_SHAPE int32 tokens in RATE_BLOCKS blocks through
    a numpy map_batches, then iter_torch_batches(RATE_BATCH, int64,
    device="cuda") in the driver; each batch's sum on the card against
    numpy's. Returns the readings."""
    import numpy as np

    tokens = np.random.default_rng(INGEST_SEED + 1).integers(
        0, vocab, RATE_SHAPE, dtype=np.int32)
    want = tokens.reshape(-1, RATE_BATCH, RATE_SHAPE[1]).sum(
        axis=(1, 2), dtype=np.int64)
    per = RATE_SHAPE[0] // RATE_BLOCKS
    ds = rd.from_numpy([tokens[i * per:(i + 1) * per]
                        for i in range(RATE_BLOCKS)], column="tokens")
    ds = ds.map_batches(lambda b: {"tokens": np.minimum(b["tokens"],
                                                        vocab - 1)})
    sums, arrive = [], []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for batch in ds.iter_torch_batches(batch_size=RATE_BATCH,
                                       dtypes={"tokens": torch.int64},
                                       device="cuda"):
        t = batch["tokens"]
        if t.device.type != "cuda" or t.dtype != torch.int64:
            raise AssertionError(f"phase 19 (c): a batch on {t.device} "
                                 f"as {t.dtype}")
        sums.append(t.sum())
        arrive.append(time.perf_counter())
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = torch.stack(sums).cpu().numpy()
    if got.shape != want.shape or not (got == want).all():
        bad = (np.nonzero(got != want)[0][:5] if got.shape == want.shape
               else got.shape)
        raise AssertionError(f"phase 19 (c): batch sums differ from "
                             f"numpy's: {bad}")
    gaps = np.diff([t0] + arrive) * 1e3
    # the same stream again as numpy batches, nothing copied: what the
    # tasks and the store deliver before any copy to the card
    t1 = time.perf_counter()
    n = sum(1 for _ in ds.iter_batches(batch_size=RATE_BATCH))
    numpy_s = time.perf_counter() - t1
    if n != len(got):
        raise AssertionError(f"phase 19 (c): {n} numpy batches, "
                             f"{len(got)} torch batches")
    return {"wall_s": wall, "gb_per_s": tokens.nbytes / wall / 1e9,
            "median_batch_ms": float(np.median(gaps)),
            "device_ms": start.elapsed_time(end), "batches": len(got),
            "gb": tokens.nbytes / 1e9, "numpy_s": numpy_s,
            "numpy_gb_per_s": tokens.nbytes / numpy_s / 1e9}


def store_read_rate(rt):
    """Phase 19 (c)'s host side: 256 MiB in 16 blocks written into the
    store by a task, then read by the driver twice through its views (a
    64-row batch at a time into one buffer): the first read maps each
    page of the store into the driver, the second finds it mapped.
    Returns GB/s of each read."""
    import numpy as np

    @rt.remote
    def block(i):
        return np.full((2048, 2048), i, np.int32)

    refs = [block.remote(i) for i in range(16)]
    rt.wait(refs, num_returns=len(refs))
    out = np.empty((RATE_BATCH, 2048), np.int32)
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        for i, ref in enumerate(refs):
            a = rt.get(ref)
            for s in range(0, len(a), RATE_BATCH):
                np.copyto(out, a[s:s + RATE_BATCH])
            if out[0, 0] != i:
                raise AssertionError(f"phase 19 (c): block {i} read "
                                     f"{out[0, 0]}")
        rates.append(16 * (2048 * 2048 * 4) / (time.perf_counter() - t0)
                     / 1e9)
    return rates


def data_ingest(models):
    """Phase 19 (see the module docstring): its own
    init(num_cpus=4, num_gpus=1), (a), (b) and (c); the card must be free
    again after each trainer. Returns (a)'s worker's K2 launches and the
    readings."""
    import shutil
    import tempfile

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import train

    os.environ.setdefault("RAY_TPU_TORCH_TMPDIR",
                          tempfile.mkdtemp(prefix="rtt"))
    storage = tempfile.mkdtemp(prefix="rtt_runs")
    cfg = models.LLAMA3_1B
    steps = INGEST_ROWS // INGEST_BATCH
    rows = np.random.default_rng(INGEST_SEED).integers(
        0, cfg.vocab_size, (INGEST_ROWS, TRAIN_TOKENS[1]), dtype=np.int32)
    t_phase = time.perf_counter()
    want = ingest_reference(models, rows, seed=7)
    log(f"phase 19 (a): the driver's run of phase 8's step on the {steps} "
        f"batches: losses {want} in {time.perf_counter() - t_phase} s")
    out = {}
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, object_store_memory=8 << 30)
    try:
        log(f"phase 19: cluster up in {time.perf_counter() - t0} s")
        # (a) one worker with the card, fed from its shard
        vocab = cfg.vocab_size
        per = INGEST_ROWS // INGEST_BLOCKS
        ds = rd.from_numpy([rows[i * per:(i + 1) * per]
                            for i in range(INGEST_BLOCKS)], column="tokens")
        ds = ds.map_batches(lambda b: {"tokens": np.minimum(b["tokens"],
                                                            vocab - 1)})
        trainer = train.TorchTrainer(
            ingest_loop, train_loop_config={
                "seed": 7, "lr": LR, "rows": ray_tpu_torch.put(rows),
                "steps": steps, "batch": INGEST_BATCH,
                "counters": COUNTERS},
            datasets={"train": ds},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(name="ingest", storage_path=storage))
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        if result.error is not None:
            raise AssertionError(f"phase 19 (a): {result.error}")
        a = result.metrics_all_workers[0]
        diff = [abs(x - w) / abs(w) for x, w in zip(a["losses"], want)]
        sums = [r.sum(dtype=np.int64).item() for r in rows]
        for k, b in enumerate(a["batches"]):
            if not b["equal"] or b["device"] != "cuda:0" or \
                    b["dtype"] != "torch.int64" or \
                    b["row_sums"] != sums[k * INGEST_BATCH:
                                         (k + 1) * INGEST_BATCH]:
                raise AssertionError(f"phase 19 (a): batch {k} {b}, rows "
                                     f"{k * INGEST_BATCH}.. sum to "
                                     f"{sums[k * INGEST_BATCH:]}")
        if a["get_device"] != "cuda:0" or a["gpu_ids"] != ["0"]:
            raise AssertionError(f"phase 19 (a): get_device() "
                                 f"{a['get_device']}, GPU ids "
                                 f"{a['gpu_ids']}")
        if len(diff) != steps or not all(d <= RUNTIME_LOSS_RTOL
                                         for d in diff):
            raise AssertionError(f"phase 19 (a): losses {a['losses']}, "
                                 f"the driver's {want}")
        counts = {c: a[c] for c in COUNTERS}
        expect = {"launches": cfg.n_layers * steps,
                  "bwd_launches": cfg.n_layers * steps, "stats_launches": 0}
        if counts != expect:
            raise AssertionError(f"phase 19 (a): launches {counts}, "
                                 f"expected {expect}")
        step_ms = [x * 1e3 for x in a["step_s"]]
        log(f"phase 19 (a): {steps} batches of {INGEST_BATCH} x "
            f"{TRAIN_TOKENS[1]} int32 tokens from {INGEST_BLOCKS} blocks "
            f"through map_batches, each equal to its rows and on cuda:0 "
            f"as int64 (steps 1-2 device='auto', 3-4 get_device()); "
            f"get_device() {a['get_device']}; losses {a['losses']}, the "
            f"driver's {want}, relative differences {diff}; launches "
            f"{counts}; ms/step {step_ms} (steps 2-4 mean "
            f"{sum(step_ms[1:]) / len(step_ms[1:])}); batch waits ms "
            f"{[x * 1e3 for x in a['wait_s']]}; worker start "
            f"{a['enter_t'] - t_fit} s and first report "
            f"{a['report_t'][0] - t_fit} s after fit(), which took "
            f"{fit_s} s")
        out["a"] = dict(counts, losses=a["losses"], step_ms=step_ms,
                        first_report_s=a["report_t"][0] - t_fit)
        _replicas_gone(ray_tpu_torch, what="phase 19 (a)")

        # (b) two workers sharing the card over gloo
        rng = np.random.default_rng(DDP_SEED)
        x = rng.standard_normal((DDP_ROWS, 16)).astype(np.float32)
        y = (x @ rng.standard_normal(16) + 0.1 * rng.standard_normal(
            DDP_ROWS)).astype(np.float32)
        ids = np.arange(DDP_ROWS)
        per = DDP_ROWS // DDP_BLOCKS
        ddp_ds = rd.from_blocks([
            {"x": x[i * per:(i + 1) * per], "y": y[i * per:(i + 1) * per],
             "id": ids[i * per:(i + 1) * per]} for i in range(DDP_BLOCKS)])
        t_fit = time.time()
        result = train.TorchTrainer(
            ddp_loop, train_loop_config={
                "batch": DDP_BATCH, "seed": DDP_SEED,
                "loader_rows": DDP_LOADER_ROWS},
            datasets={"train": ddp_ds},
            scaling_config=train.ScalingConfig(num_workers=2, use_gpu=True,
                                               gpus_per_worker=0.5),
            run_config=train.RunConfig(name="ddp", storage_path=storage),
            torch_backend="gloo").fit()
        fit_s = time.time() - t_fit
        if result.error is not None:
            raise AssertionError(f"phase 19 (b): {result.error}")
        r0, r1 = (result.metrics_all_workers[i] for i in (0, 1))
        s0, s1 = set(r0["ids"]), set(r1["ids"])
        if s0 & s1 or s0 | s1 != set(range(DDP_ROWS)) or \
                len(r0["ids"]) + len(r1["ids"]) != DDP_ROWS:
            raise AssertionError(f"phase 19 (b): shards of "
                                 f"{len(r0['ids'])} and {len(r1['ids'])} "
                                 f"rows, {len(s0 & s1)} shared")
        placed = {"ddp": True, "device_ids": [0],
                  "param_devices": ["cuda:0"], "batch_device": "cuda:0",
                  "get_device": "cuda:0", "gpu_ids": ["0"]}
        for r in (r0, r1):
            got = {k: r[k] for k in placed}
            if got != placed:
                raise AssertionError(f"phase 19 (b): rank {r['rank']}: "
                                     f"{got}, expected {placed}")
        picked = r0["first_ids"] + r1["first_ids"]
        ref = ddp_reference(x[picked], y[picked], DDP_SEED)
        gaps = []
        for got0, got1, w in zip(r0["grads"], r1["grads"], ref):
            scale = float(np.abs(w).max())
            gaps.append(max(float(np.abs(got0 - w).max()),
                            float(np.abs(got1 - w).max())) / scale)
        if not all(g <= DDP_GRAD_RTOL for g in gaps):
            raise AssertionError(f"phase 19 (b): gradients against the "
                                 f"driver's over {len(picked)} rows: "
                                 f"relative gaps {gaps}")
        l0, l1 = set(r0["loader_ids"]), set(r1["loader_ids"])
        if l0 & l1 or l0 | l1 != set(range(DDP_LOADER_ROWS)):
            raise AssertionError(f"phase 19 (b): prepare_data_loader gave "
                                 f"{len(l0)} and {len(l1)} indices, "
                                 f"{len(l0 & l1)} shared")
        log(f"phase 19 (b): two workers at num_gpus=0.5 over gloo, both "
            f"pinned to {r0['gpu_ids']}: shards of {len(s0)} and "
            f"{len(s1)} disjoint ids covering {DDP_ROWS}; prepare_model "
            f"-> DDP on cuda:0 with device_ids {r0['device_ids']}; the "
            f"averaged gradients against the driver's over {len(picked)} "
            f"rows: largest relative gaps {gaps} (limit {DDP_GRAD_RTOL}); "
            f"prepare_data_loader: {len(l0)} + {len(l1)} disjoint indices "
            f"of {DDP_LOADER_ROWS}; fit() took {fit_s} s")
        out["b"] = {"grad_gaps": gaps, "fit_s": fit_s}
        _replicas_gone(ray_tpu_torch, what="phase 19 (b)")

        # (c) the ingest rate into the card, in the driver
        rate = ingest_rate(rd, vocab)
        rate["store_read_gb_per_s"] = store_read_rate(ray_tpu_torch)
        log(f"phase 19 (c): {rate['gb']} GB of int32 tokens "
            f"{list(RATE_SHAPE)} in {RATE_BLOCKS} blocks through "
            f"map_batches and iter_torch_batches(batch_size={RATE_BATCH}, "
            f"int64, device='cuda'): {rate['batches']} batches, every sum "
            f"equal to numpy's; {rate['wall_s']} s = {rate['gb_per_s']} "
            f"GB/s into the card; median {rate['median_batch_ms']} ms a "
            f"batch; {rate['device_ms']} ms between the card's first and "
            f"last events. The same stream as numpy batches, no copy: "
            f"{rate['numpy_s']} s = {rate['numpy_gb_per_s']} GB/s. The "
            f"driver reading 256 MiB of task-written blocks through its "
            f"store views: first read, then second, GB/s "
            f"{rate['store_read_gb_per_s']}")
        out["c"] = rate
    except BaseException:
        log(_session_log_tails())
        raise
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19 done in {out['phase_s']} s")
    return out


# Phase 20: the MPMD pipeline of stage actors on the card. LLAMA3_1B's 16
# layers as 2 stages of 8, each a stage actor at num_gpus=0.5 (both pinned
# to card "0"); phase 8's tokens [4, 2048] as MPMD_MICROBATCHES
# microbatches of one row, 1F1B.
MPMD_STAGES = 2
MPMD_MICROBATCHES = 4
MPMD_STEPS = (1, 2)  # warm-up, timed AdamW steps after the grad check
MPMD_GANG = "phase20"
# A stage's seconds from a stage's kill to the typed error must stay far
# under the compiled chain's 300 s result timeout: the gang push, not a
# timeout, must have raised it.
MPMD_DETECT_S = 30.0


def mpmd_expect(n_layers: int, stages: int, microbatches: int,
                passes: int) -> dict:
    """K2's launches by one stage actor in ``passes`` forward-and-backward
    passes of the pipeline: its n_layers / stages layers run once per
    microbatch forward, once more in remat's recompute (stage_forward and
    stage_loss take remat), and once backward."""
    per = n_layers // stages * microbatches * passes
    return {"launches": 2 * per, "bwd_launches": per, "stats_launches": 0}


def _probe(pipe, reset: bool = False) -> list:
    """Each stage actor's ``probe`` (its pid, device, GPU ids, peak
    memory, kernel counts, hops sent and gradient leaf squares), in stage
    order; ``reset`` zeroes the peaks, counts and hop tallies after."""
    import ray_tpu_torch

    return ray_tpu_torch.get([s.probe.remote(reset) for s in pipe.stages],
                             timeout=120)


def _store_back_to(worker, level: int, what: str, timeout: float = 30.0):
    """The store's used bytes once at or below ``level`` (C7's hold: a
    step leaves nothing of the stages' arguments and results in the store;
    the hops do not pass through it); raises when they stay above."""
    deadline = time.time() + timeout
    while True:
        used = worker.store.stats()["bytes_in_use"]
        if used <= level:
            return used
        if time.time() > deadline:
            raise AssertionError(f"{what}: the store holds {used} bytes, "
                                 f"{level} before the step")
        gc.collect()
        time.sleep(0.1)


def mpmd_group_sq(stage_sq, layer_counts) -> dict:
    """``llama_group_sq``'s groups from the stages' leaf squares (their
    probes' ``grad_sq``), each stage's layers at their global index."""
    out = {"embedding": 0.0, "norm": 0.0, "lm_head": 0.0, "layers": []}
    for sq, n in zip(stage_sq, layer_counts):
        layers = [0.0] * n
        for path, v in sq.items():
            head, *rest = path.split("/")
            if head == "layers":
                layers[int(rest[0])] += v
            else:
                out[head] += v
        out["layers"] += layers
    return out


def mpmd_training(models, tokens, dense, lockstep):
    """Phase 20 (see the module docstring): its own
    init(num_cpus=4, num_gpus=1, object_store_memory=8 << 30); one
    pipeline in gang MPMD_GANG: (a) the training run, held to phase 8's
    dense run, with a checkpoint after step 1; (b) the fault plane: stage
    1 killed at its first boundary send of the step after (a)'s by its
    failpoint, PipelineMemberLost in push time, the re-form from step 1's
    checkpoint at generation + 1 with (a)'s step 2 loss bit for bit. The
    card must be free after each pipeline; the cluster is shut down at
    the end, failures included. Returns (a)'s launches by stage and the
    readings."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.parallel import mpmd_pipeline as mpmd

    os.environ.setdefault("RAY_TPU_TORCH_TMPDIR",
                          tempfile.mkdtemp(prefix="rtt"))
    ckdir = tempfile.mkdtemp(prefix="rtt_mpmd")
    cfg = models.LLAMA3_1B
    counts = mpmd.stage_layer_counts(cfg.n_layers, MPMD_STAGES)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(7), device="cuda")
    host = _tree_map(lambda t: t.detach().cpu(), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tokens = tokens.cpu()
    # the pipeline's default placement: each stage half of the one card
    opts = mpmd.stage_placement(torch.device("cuda"), MPMD_STAGES, 1.0)
    if opts != [{"num_gpus": 0.5}] * MPMD_STAGES:
        raise AssertionError(f"phase 20: default stage options {opts}")
    kw = dict(n_stages=MPMD_STAGES, n_microbatches=MPMD_MICROBATCHES,
              lr=LR, schedule="1f1b")
    out = {}
    t_phase = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, object_store_memory=8 << 30)
    try:
        w = global_worker()
        log(f"phase 20: cluster up in {time.perf_counter() - t_phase} s")
        # (a) the training run, on the pipeline that (b) kills: stage 1
        # kills its own process at its first boundary send after (a)'s
        # passes (each pass sends MPMD_MICROBATCHES from stage 1)
        passes = 1 + sum(MPMD_STEPS)
        kill = (f"mpmd.boundary.send.s1=hit"
                f"{MPMD_MICROBATCHES * passes + 1}:kill")
        t0 = time.perf_counter()
        pipe = mpmd.MPMDPipeline(
            cfg, host, gang_name=MPMD_GANG,
            checkpoint_dir=os.path.join(ckdir, "b"),
            stage_env={"RAY_TPU_TORCH_FAILPOINTS": kill,
                       "RAY_TPU_TORCH_FAILPOINT_SEED": "20"}, **kw)
        try:
            form_s = time.perf_counter() - t0
            gen = pipe.generation
            # ---- the main path: counts reset just before, read just after
            info = _probe(pipe, reset=True)
            if any(i["gpu_ids"] != ["0"] or i["device"] != "cuda:0"
                   for i in info):
                raise AssertionError(f"phase 20 (a): stages on {info}")
            level = w.store.stats()["bytes_in_use"]
            first = pipe.grad_check_step(tokens)
            vjps = [pipe.live_vjp_counts()]
            norm = math.sqrt(sum(n * n for n in pipe.grad_norms()))
            group_sq = mpmd_group_sq([i["grad_sq"] for i in _probe(pipe)],
                                     counts)
            check_stats = dict(pipe.last_step_stats)
            pipe._reset_step_state()
            store = [_store_back_to(w, level, "phase 20 (a) grad check")]
            losses, step_s, stats = [], [], []
            for n in range(sum(MPMD_STEPS)):
                level = w.store.stats()["bytes_in_use"]
                t1 = time.perf_counter()
                losses.append(pipe.step(tokens))
                step_s.append(time.perf_counter() - t1)
                vjps.append(pipe.live_vjp_counts())
                stats.append(dict(pipe.last_step_stats))
                store.append(_store_back_to(w, level, "phase 20 (a) step"))
                if n == 0:  # the warm-up step: (b) re-forms from here
                    t1 = time.perf_counter()
                    ckpt = pipe.save_checkpoint()
                    save_s = time.perf_counter() - t1
            info = _probe(pipe)
            # ---- end of the main path
            launches = [{c: i["counts"][c] for c in COUNTERS} for i in info]
            hop_bytes = [i["bytes_sent"] / i["hops_sent"] for i in info]
            # (b) the next step meets stage 1's failpoint
            killed = info[1]["pid"]
            t1 = time.perf_counter()
            try:
                pipe.step(tokens)
            except mpmd.PipelineMemberLost as e:
                lost, detect_s = e, time.perf_counter() - t1
            else:
                raise AssertionError("phase 20 (b): a step ran on with "
                                     "stage 1 killed")
        finally:
            pipe.teardown()
        _replicas_gone(ray_tpu_torch, what="phase 20 (a) killed pipeline")
        hold_pipelined("phase 20 (a)", first, norm, group_sq, dense,
                       MPMD_STAGES)
        if any(v != [0] * MPMD_STAGES for v in vjps):
            raise AssertionError(f"phase 20 (a): live VJPs after each "
                                 f"step {vjps}")
        # the first AdamW step's loss is the grad check's, of the same
        # weights; the later ones fall below it
        if losses[0] != first or not all(math.isfinite(x) and x < first
                                         for x in losses[1:]):
            raise AssertionError(f"phase 20 (a): losses {losses}, the grad "
                                 f"check's {first}")
        expect = mpmd_expect(cfg.n_layers, MPMD_STAGES, MPMD_MICROBATCHES,
                             passes)
        if any(c != expect for c in launches):
            raise AssertionError(f"phase 20 (a): launches by stage "
                                 f"{launches}, expected {expect} each")
        timed = step_s[MPMD_STEPS[0]:]  # after the warm-up's checkpoint
        ms = sum(timed) / len(timed) * 1e3
        lock = lockstep["pp=4 lockstep, M=4"]["step_ms"]
        log(f"phase 20 (a): {MPMD_STAGES} stage actors of {counts} layers "
            f"pinned to {[i['gpu_ids'] for i in info]} on "
            f"{[i['device'] for i in info]}, formed in {form_s} s; grad "
            f"check loss {first} (bubble {check_stats['bubble_fraction']}); "
            f"losses {losses}; live VJPs after each step {vjps}; store "
            f"bytes after each step {store}; K2 launches by stage "
            f"{launches} (expected {expect}: {counts[0]} layers x "
            f"{MPMD_MICROBATCHES} microbatches x {passes} passes, forward, "
            f"remat's recompute and backward)")
        log(f"phase 20 (a): {ms} ms/step over {len(timed)} timed steps "
            f"({[x * 1e3 for x in step_s]}), phase 8's dense "
            f"{dense['step_ms']}, phase 16's pp=4 lockstep M=4 {lock}; "
            f"bubble fraction {[s['bubble_fraction'] for s in stats]} "
            f"(analytic {bubble(MPMD_STAGES, MPMD_MICROBATCHES)}); stage "
            f"busy s {[s['stage_busy_s'] for s in stats]}; wall s "
            f"{[s['wall_s'] for s in stats]}; a hop's bytes as each stage "
            f"sent them {hop_bytes}; peak memory by stage "
            f"{[i['peak_bytes'] / 2**30 for i in info]} GiB")
        out["a"] = dict(first=first, losses=losses, step_ms=ms,
                        bubble=[s["bubble_fraction"] for s in stats],
                        busy=[s["stage_busy_s"] for s in stats],
                        peak_gib=[i["peak_bytes"] / 2**30 for i in info],
                        hop_bytes=hop_bytes, launches_by_stage=launches,
                        **{c: sum(x[c] for x in launches)
                           for c in COUNTERS})

        # (b) the fault plane: the kill, then the re-form from step 1's
        # checkpoint
        if lost.generation != gen or lost.lost_stages != [1] or \
                lost.checkpoint_path != ckpt or not detect_s < MPMD_DETECT_S:
            raise AssertionError(f"phase 20 (b): {lost!r} after {detect_s} "
                                 f"s, generation {gen}, checkpoint {ckpt}")
        t1 = time.perf_counter()
        pipe = mpmd.MPMDPipeline.from_checkpoint(ckpt, cfg,
                                                 gang_name=MPMD_GANG, **kw)
        try:
            reform_s = time.perf_counter() - t1
            regen = pipe.generation
            step2 = pipe.step(tokens)
        finally:
            pipe.teardown()
        _replicas_gone(ray_tpu_torch, what="phase 20 (b) re-formed pipeline")
        if regen != gen + 1 or step2 != losses[1]:
            raise AssertionError(
                f"phase 20 (b): generation {gen} -> {regen}; step 2 after "
                f"the re-form {step2} ((a)'s {losses[1]})")
        log(f"phase 20 (b): gang {MPMD_GANG!r} at generation {gen}; merged "
            f"checkpoint after step 1 in {save_s} s; stage 1 (pid {killed})"
            f" killed at its first boundary send of step "
            f"{sum(MPMD_STEPS) + 1}: {type(lost).__name__} (lost stages "
            f"{lost.lost_stages}, generation {lost.generation}) in "
            f"{detect_s} s (the chain's result timeout is 300 s); re-formed "
            f"from the checkpoint at generation {regen} in {reform_s} s; "
            f"its step 2 loss {step2} equals (a)'s {losses[1]} bit for bit")
        out["b"] = dict(detect_s=detect_s, save_s=save_s, reform_s=reform_s,
                        generations=[gen, regen])
    except BaseException:
        log(_session_log_tails())
        raise
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(ckdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20 done in {out['phase_s']} s")
    return out


# Phase 21: Tune and workflow on the card, on a cluster of its own.
# (a) ASHA over TorchTrainer trials of LLAMA3_1B, two at a time, each at
# half the card (resources_per_worker's GPU share): phase 8's remat +
# chunked step, phase 8's weights (seed 7) and tokens. Every trial's first
# loss comes before its first update, so the first rung is at iteration 2;
# the first two rates are sane and the last two so large that their first
# update sends the loss up, so these meet a rung that holds the first two.
TUNE_LRS = (3e-4, 1e-4, 3e-2, 1e-1)
TUNE_MAX_T = 3
TUNE_GRACE = 2
TUNE_CHUNK = 16384
# (b) PBT over three ViT-B/16 trials at a quarter of the card each, phase
# 15's weights, images and labels in every trial and a checkpoint every
# iteration; the last rate sends the loss up at its first update, so that
# trial is the worst at iteration 2 and clones a donor.
PBT_LRS = (3e-4, 1e-4, 1e-1)
PBT_ITERS = 4
PBT_INTERVAL = 2
PBT_MUTATIONS = (3e-4, 1e-4)
PBT_SEED = 21
# (c) the workflow's evaluation batch
WORKFLOW_IMAGES = 64
WORKFLOW_SEED = 22


def _where(attention, counters):
    """Where this process runs and what it launched, for a report."""
    import torch

    import ray_tpu_torch

    return {"gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": f"cuda:{torch.cuda.current_device()}",
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            **{c: getattr(attention, c) for c in counters}}


def tune_llama_loop(cfg):
    """Phase 21 (a)'s trial (shipped by value): phase 8's remat + chunked
    step on LLAMA3_1B from seed 7 on the trial's share of the card, AdamW
    at the trial's rate, a report after every step with its loss, its
    time and the launches so far in this process. It imports torch itself:
    cloudpickle cannot ship the module global's torch.backends.cudnn."""
    import time

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import models, train
    from ray_tpu_torch.ops import attention

    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = models.LLAMA3_1B
    params = models.init_params(
        mcfg, torch.Generator(device="cuda").manual_seed(7), device="cuda")
    leaves = models.trainable(params)
    opt = torch.optim.AdamW(leaves, lr=cfg["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1)
    tokens = ray_tpu_torch.get(cfg["tokens"]).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in cfg["counters"]:
        setattr(attention, c, 0)
    losses, step_s, first_report = [], [], None
    for _ in range(cfg["max_t"]):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = models.loss_fn(params, {"tokens": tokens}, mcfg,
                              attn_impl=None, remat=True,
                              chunked_vocab=cfg["chunk"])
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        first_report = first_report or time.time()
        train.report({"loss": losses[-1], "losses": list(losses),
                      "step_s": list(step_s), "enter_t": t_enter,
                      "first_report_t": first_report,
                      **_where(attention, cfg["counters"])})


def pbt_trainable():
    """Phase 21 (b)'s Trainable (defined here, so it ships by value):
    ViT-B/16 from VIT_SEED on phase 15's batch, AdamW at the trial's rate;
    each step reports the loss before its update. save_checkpoint writes
    the parameters and AdamW state through save_pytree with each leaf's
    float64 sum; load_checkpoint reads them back onto the card and keeps
    the sums it finds beside the saved ones for the next report."""
    from ray_tpu_torch import tune

    class ViTPBT(tune.Trainable):
        checkpoint_frequency = 1

        def setup(self, config):
            import time

            import torch

            from ray_tpu_torch import models
            from ray_tpu_torch.models import vit
            from ray_tpu_torch.ops import attention

            self.t_enter = time.time()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.cfg = vit.ViTConfig()
            self.params = vit.init_params(
                self.cfg, torch.Generator(device="cuda").manual_seed(
                    VIT_SEED), device="cuda")
            self.batch = vit_batch(self.cfg, VIT_IMAGES, VIT_SEED)
            self.leaves = models.trainable(self.params)
            self.opt = torch.optim.AdamW(self.leaves, lr=config["lr"],
                                         betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=0.1)
            self.steps, self.step_s, self.saves = 0, [], []
            self.losses = []
            self.loaded = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in COUNTERS:
                setattr(attention, c, 0)

        def _sums(self):
            import torch

            state = [v for st in self.opt.state.values() for v in st.values()
                     if isinstance(v, torch.Tensor)]
            return [float(t.detach().double().sum())
                    for t in list(self.leaves) + state]

        def step(self):
            import time

            import torch

            from ray_tpu_torch.models import vit
            from ray_tpu_torch.ops import attention

            t0 = time.perf_counter()
            self.opt.zero_grad(set_to_none=True)
            loss = vit.loss_fn(self.params, self.batch, self.cfg)
            loss.backward()
            self.opt.step()
            torch.cuda.synchronize()
            self.step_s.append(time.perf_counter() - t0)
            self.steps += 1
            self.losses.append(float(loss.detach()))
            out = {"loss": self.losses[-1], "lr": self.config["lr"],
                   "losses": list(self.losses), "steps": self.steps,
                   "step_s": list(self.step_s),
                   "saves": list(self.saves), "enter_t": self.t_enter,
                   "done": self.training_iteration + 1 >= PBT_ITERS,
                   **_where(attention, COUNTERS)}
            if self.loaded is not None:
                out["loaded"], self.loaded = self.loaded, None
            return out

        def save_checkpoint(self, checkpoint_dir):
            import time

            from ray_tpu_torch import train

            t0 = time.perf_counter()
            nbytes = train.save_pytree(
                {"leaves": [t.detach() for t in self.leaves],
                 "opt": self.opt.state_dict()}, checkpoint_dir)
            with open(os.path.join(checkpoint_dir, "sums.json"), "w") as f:
                json.dump(self._sums(), f)
            self.saves.append((nbytes, time.perf_counter() - t0))
            return checkpoint_dir

        def load_checkpoint(self, checkpoint_dir):
            import time

            from ray_tpu_torch import train

            import torch

            t0 = time.perf_counter()
            state = train.load_pytree(checkpoint_dir, device="cuda")
            with torch.no_grad():
                for t, saved in zip(self.leaves, state["leaves"]):
                    t.copy_(saved)
            self.opt.load_state_dict(state["opt"])
            for group in self.opt.param_groups:
                group["lr"] = self.config["lr"]
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            with open(os.path.join(checkpoint_dir, "sums.json")) as f:
                saved = json.load(f)
            self.loaded = {"sums": self._sums(), "saved": saved,
                           "from": checkpoint_dir, "load_s": load_s}

    return ViTPBT


def vit_checkpoint_loss(ckpt, images, seed):
    """ViT-B/16's loss under no_grad on ``images`` images from ``seed``,
    its weights from the checkpoint at ``ckpt``, and the launches it
    made."""
    import torch

    from ray_tpu_torch import models, train
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops import attention

    cfg = vit.ViTConfig()
    params = vit.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        VIT_SEED), device="cuda")
    state = train.load_pytree(ckpt, device="cuda")
    with torch.no_grad():
        for t, saved in zip(models.trainable(params), state["leaves"]):
            t.copy_(saved)
    batch = vit_batch(cfg, images, seed)
    for c in COUNTERS:
        setattr(attention, c, 0)
    with torch.no_grad():
        loss = float(vit.loss_fn(params, batch, cfg))
    torch.cuda.synchronize()
    return loss, {c: getattr(attention, c) for c in COUNTERS}


def workflow_eval_step(ckpt, runs_path):
    """Phase 21 (c)'s evaluation step (a task at half the card): counts
    its runs in ``runs_path``, then the loss of the checkpoint at
    ``ckpt`` on the workflow's batch."""
    import torch

    import ray_tpu_torch

    with open(runs_path, "a") as f:
        f.write("run\n")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss, counts = vit_checkpoint_loss(ckpt, WORKFLOW_IMAGES, WORKFLOW_SEED)
    return {"loss": loss, "counts": counts,
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "device": f"cuda:{torch.cuda.current_device()}"}


def workflow_summary_step(evaluation, marker):
    """Phase 21 (c)'s second step: fails while the planted ``marker`` file
    exists, then sums the evaluation up."""
    if os.path.exists(marker):
        raise RuntimeError(f"planted failure: {marker} exists")
    return {"evaluation": evaluation,
            "summary": f"ViT-B/16 loss {evaluation['loss']}"}


def tune_asha(rt, tune, train, tokens, remat, storage):
    """Phase 21 (a); returns each trial's last report by its rate."""
    cfg = {"tokens": rt.put(tokens.cpu()), "max_t": TUNE_MAX_T,
           "chunk": TUNE_CHUNK, "counters": COUNTERS}
    trainer = train.TorchTrainer(
        tune_llama_loop, train_loop_config=cfg,
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=True, resources_per_worker={"GPU": 0.5}))
    t0 = time.time()
    grid = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(
            list(TUNE_LRS))}},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(max_t=TUNE_MAX_T,
                                         grace_period=TUNE_GRACE,
                                         reduction_factor=2)),
        run_config=train.RunConfig(name="asha", storage_path=storage)).fit()
    sweep_s = time.time() - t0
    if grid.errors:
        raise AssertionError(f"phase 21 (a): {grid.errors}")
    rows = {r.config["train_loop_config"]["lr"]: r.metrics for r in grid}
    per_step = {c: remat[c] // 3 for c in COUNTERS}  # phase 8: 1 + 2 steps
    for lr in TUNE_LRS:
        m = rows[lr]
        it = m["training_iteration"]
        counts = {c: m[c] for c in COUNTERS}
        step_ms = [x * 1e3 for x in m["step_s"]]
        log(f"phase 21 (a) lr {lr}: {it} iterations, losses {m['losses']}; "
            f"pinned to {m['gpu_ids']} (CUDA_VISIBLE_DEVICES "
            f"{m['visible']}) on {m['device']}; trial entered its loop "
            f"{m['enter_t'] - t0} s after fit(), first report "
            f"{m['first_report_t'] - m['enter_t']} s later; ms/step "
            f"{step_ms} (phase 8's remat + chunked alone {remat['step_ms']})"
            f"; peak memory {m['peak_gib']} GiB; launches {counts}")
        if m["gpu_ids"] != ["0"] or m["visible"] != "0" or \
                m["device"] != "cuda:0":
            raise AssertionError(f"phase 21 (a) lr {lr}: pinned to "
                                 f"{m['gpu_ids']}, {m['device']}")
        gap = abs(m["losses"][0] - remat["losses"][0]) / remat["losses"][0]
        if not gap <= RUNTIME_LOSS_RTOL:
            raise AssertionError(f"phase 21 (a) lr {lr}: first loss "
                                 f"{m['losses'][0]}, phase 8's "
                                 f"{remat['losses'][0]}")
        if counts != {c: per_step[c] * it for c in COUNTERS}:
            raise AssertionError(f"phase 21 (a) lr {lr}: launches {counts} "
                                 f"over {it} steps, phase 8's rate "
                                 f"{per_step}")
    sane = rows[TUNE_LRS[0]]
    want = remat["losses"][:3]
    diff = [abs(x - w) / abs(w) for x, w in zip(sane["losses"], want)]
    log(f"phase 21 (a) lr {TUNE_LRS[0]}: losses 1-3 {sane['losses'][:3]}, "
        f"phase 8's remat + chunked {want}, relative differences {diff}")
    if len(diff) != 3 or not all(d <= RUNTIME_LOSS_RTOL for d in diff):
        raise AssertionError("phase 21 (a): the lr 3e-4 trial parts from "
                             "phase 8's run")
    # ASHA at the rung of iteration 2, reduction factor 2: a trial goes on
    # only if it is in the better half of the rung so far. The first trial
    # is the better of the first two, so it always finishes; the second
    # finishes only if its report reached the rung first; the last two
    # meet a rung holding both sane ones and stop there.
    stops = {lr: rows[lr]["training_iteration"] for lr in TUNE_LRS}
    if stops[TUNE_LRS[0]] != TUNE_MAX_T or \
            stops[TUNE_LRS[1]] not in (TUNE_GRACE, TUNE_MAX_T) or \
            any(stops[lr] != TUNE_GRACE for lr in TUNE_LRS[2:]):
        raise AssertionError(f"phase 21 (a): iterations by rate {stops}")
    best = grid.get_best_result().config["train_loop_config"]["lr"]
    finished = [lr for lr in TUNE_LRS if stops[lr] == TUNE_MAX_T]
    lowest = min(finished, key=lambda lr: rows[lr]["loss"])
    if best != lowest:
        raise AssertionError(f"phase 21 (a): best {best}, the finished "
                             f"trial with the lowest last loss {lowest}")
    shared = [sum(rows[lr]["step_s"][1:]) / len(rows[lr]["step_s"][1:]) * 1e3
              for lr in TUNE_LRS]
    log(f"phase 21 (a): iterations by rate {stops}; best {best}; ms/step "
        f"after the first, two trials sharing the card, {shared} (phase "
        f"8's remat + chunked alone {remat['step_ms']}); the sweep took "
        f"{sweep_s} s")
    return rows, sweep_s


def tune_pbt(rt, tune, train, vit_run, storage):
    """Phase 21 (b); returns each trial's last report by its id and the
    best checkpoint's path."""
    pbt = tune.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=PBT_INTERVAL,
        hyperparam_mutations={"lr": list(PBT_MUTATIONS)}, seed=PBT_SEED)
    t0 = time.time()
    grid = tune.Tuner(
        tune.with_resources(pbt_trainable(), {"GPU": 0.25}),
        param_space={"lr": tune.grid_search(list(PBT_LRS))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=pbt),
        run_config=train.RunConfig(name="pbt", storage_path=storage)).fit()
    sweep_s = time.time() - t0
    if grid.errors:
        raise AssertionError(f"phase 21 (b): {grid.errors}")
    from ray_tpu_torch.models import vit

    n = vit.ViTConfig().n_layers  # K2 n forward and n backward a step
    rows, exploits = {}, []
    for r in grid:
        tid = os.path.basename(r.path)
        with open(os.path.join(r.path, "result.json")) as f:
            reports = [json.loads(line) for line in f]
        m = rows[tid] = dict(r.metrics, reports=reports)
        counts = {c: m[c] for c in COUNTERS}
        if m["gpu_ids"] != ["0"] or m["device"] != "cuda:0":
            raise AssertionError(f"phase 21 (b) {tid}: pinned to "
                                 f"{m['gpu_ids']}, {m['device']}")
        if counts != {"launches": n * m["steps"],
                      "bwd_launches": n * m["steps"], "stats_launches": 0}:
            raise AssertionError(f"phase 21 (b) {tid}: launches {counts} "
                                 f"over {m['steps']} steps")
        if not tid.endswith("r"):
            first = reports[0]["loss"]
            gap = abs(first - vit_run["losses"][0]) / vit_run["losses"][0]
            if not gap <= VIT_RTOL:
                raise AssertionError(f"phase 21 (b) {tid}: first loss "
                                     f"{first}, phase 15's "
                                     f"{vit_run['losses'][0]}")
        else:
            loaded = reports[0]["loaded"]
            with open(os.path.join(loaded["from"], "sums.json")) as f:
                donor_sums = json.load(f)
            if not loaded["sums"] == loaded["saved"] == donor_sums:
                raise AssertionError(f"phase 21 (b) {tid}: restored sums "
                                     f"differ from the donor checkpoint's")
            exploits.append((tid, loaded["from"].split(os.sep)[-2],
                             reports[0]["lr"], loaded["load_s"],
                             len(loaded["sums"])))
        saves = m["saves"]
        log(f"phase 21 (b) {tid}: lr {m['lr']}, {m['training_iteration']} "
            f"iterations, losses in this process {m['losses']}; pinned to "
            f"{m['gpu_ids']}; ms/step "
            f"{[x * 1e3 for x in m['step_s']]} (phase 15 alone "
            f"{vit_run['step_ms']}); checkpoints "
            f"{[(b / 1e9, s) for b, s in saves]} (GB, s); peak memory "
            f"{m['peak_gib']} GiB; launches {counts}")
    if not exploits:
        raise AssertionError("phase 21 (b): no exploit")
    for tid, donor, lr, load_s, leaves in exploits:
        log(f"phase 21 (b) exploit: {tid} cloned {donor}'s checkpoint at "
            f"lr {lr}, loaded in {load_s} s; {leaves} parameter and AdamW "
            f"leaves' float64 sums equal the donor's as saved")
    best = grid.get_best_result()
    log(f"phase 21 (b): {len(rows)} trials, {len(exploits)} exploits, best "
        f"{os.path.basename(best.path)} (loss {best.metrics['loss']}); the "
        f"sweep took {sweep_s} s")
    return rows, best.checkpoint.path, sweep_s


def durable_workflow(rt, workflow, ckpt, storage):
    """Phase 21 (c): the two-step workflow on the card, its resume and its
    output after the cluster restarts; returns the evaluation."""
    root = os.path.join(storage, "workflows")
    workflow.init(root)
    runs = os.path.join(storage, "eval_runs.txt")
    marker = os.path.join(storage, "fail_once")
    with open(marker, "w") as f:
        f.write("planted")
    evaluate = rt.remote(num_gpus=0.5, max_retries=0)(workflow_eval_step)
    summary = rt.remote(max_retries=0)(workflow_summary_step)
    dag = summary.bind(evaluate.bind(ckpt, runs), marker)
    t0 = time.time()
    try:
        workflow.run(dag, workflow_id="phase21")
    except Exception as e:  # noqa: BLE001 - the planted failure
        first = repr(e)
    else:
        raise AssertionError("phase 21 (c): the planted failure passed")
    status = workflow.get_status("phase21")
    if status not in (workflow.FAILED, workflow.RESUMABLE):
        raise AssertionError(f"phase 21 (c): status {status}")
    os.remove(marker)
    out = workflow.resume("phase21")
    wf_s = time.time() - t0
    with open(runs) as f:
        n_runs = len(f.read().split())
    ev = out["evaluation"]
    want, driver_counts = vit_checkpoint_loss(ckpt, WORKFLOW_IMAGES,
                                              WORKFLOW_SEED)
    gap = abs(ev["loss"] - want) / want
    log(f"phase 21 (c): first run {status} ({first[:120]}), resumed to "
        f"{workflow.get_status('phase21')} in {wf_s} s all told; the "
        f"evaluation ran {n_runs} time(s), on {ev['gpu_ids']} "
        f"{ev['device']}, loss {ev['loss']} (the driver's {want}, relative "
        f"gap {gap}); launches in the step {ev['counts']}")
    from ray_tpu_torch.models import vit

    expect = {"launches": vit.ViTConfig().n_layers, "bwd_launches": 0,
              "stats_launches": 0}
    if n_runs != 1 or gap > VIT_RTOL or ev["counts"] != expect or \
            driver_counts != expect or ev["gpu_ids"] != ["0"] or \
            workflow.get_status("phase21") != workflow.SUCCESSFUL:
        raise AssertionError(f"phase 21 (c): runs {n_runs}, loss "
                             f"{ev['loss']} against {want}, launches "
                             f"{ev['counts']}, on {ev['gpu_ids']}")
    t0 = time.perf_counter()
    rt.shutdown()
    rt.init(num_cpus=8, num_gpus=1)
    workflow.init(root)
    again = workflow.get_output("phase21")
    if again != out:
        raise AssertionError(f"phase 21 (c): stored output {again}, the "
                             f"run's {out}")
    log(f"phase 21 (c): after the cluster restarted "
        f"({time.perf_counter() - t0} s) get_output returns the stored "
        f"result")
    return ev


def tune_and_workflow(tokens, remat, vit_run):
    """Phase 21 (see the module docstring): its own
    ray_tpu_torch.init(num_cpus=8, num_gpus=1), (a), (b) and (c); the card
    must be free after each part; tune's storage is removed and the
    cluster shut down at the end, failures included. Returns each part's
    launches by trial or step."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import train, tune, workflow

    os.environ.setdefault("RAY_TPU_TORCH_TMPDIR",
                          tempfile.mkdtemp(prefix="rtt"))
    storage = tempfile.mkdtemp(prefix="rtt_tune")
    t_phase = time.perf_counter()
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    try:
        log(f"phase 21: cluster up in {time.perf_counter() - t_phase} s")
        asha, asha_s = tune_asha(ray_tpu_torch, tune, train, tokens, remat,
                                 storage)
        _replicas_gone(ray_tpu_torch, what="phase 21 (a)")
        pbt, best_ckpt, pbt_s = tune_pbt(ray_tpu_torch, tune, train,
                                         vit_run, storage)
        _replicas_gone(ray_tpu_torch, what="phase 21 (b)")
        ev = durable_workflow(ray_tpu_torch, workflow, best_ckpt, storage)
        _replicas_gone(ray_tpu_torch, what="phase 21 (c)")
    except BaseException:
        log(_session_log_tails())
        raise
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    log(f"phase 21 done in {time.perf_counter() - t_phase} s (ASHA "
        f"{asha_s} s, PBT {pbt_s} s)")
    launches = {f"tune_asha_lr_{lr}": m for lr, m in asha.items()}
    launches.update({f"tune_pbt_{tid}": m for tid, m in pbt.items()})
    launches["workflow_vit_eval"] = ev["counts"]
    return {k: {c: v[c] for c in COUNTERS} for k, v in launches.items()}


# Phase 22: runtime_env, jobs, the dashboard and the CLI. A cluster of its
# own started by `python -m ray_tpu_torch start`; jobs submitted over the
# dashboard (or the CLI without aiohttp) train phase 8's dense step in an
# actor that sits in a pip venv, holds the card and imports its step from
# a py_modules package.
JOB_STEPS = (1, 2)       # warm-up, timed steps in the job's actor
JOB_STOP_S = 30.0        # a stopped job's GPU share back within
JOB_TIMEOUT_S = 600.0    # a job's longest run (the first builds the venv)
JOB_PROBE = "rtpt_job_probe"   # the local wheel the pip env installs
JOB_STEP_PACKAGE = "p22_step"  # the py_modules package

# The job's training step (JOB_STEP_PACKAGE/__init__.py), shipped to the
# actor by py_modules: phase 8's dense step on its own card.
JOB_STEP_SOURCE = '''"""Phase 22's step: phase 8's dense LLAMA3_1B step from a seed."""
import time

import torch

from ray_tpu_torch import models
from ray_tpu_torch.ops import attention

COUNTERS = ("launches", "bwd_launches", "stats_launches")


def train(tokens, cfg):
    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = models.LLAMA3_1B
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    params = models.init_params(mcfg, gen, device="cuda")
    leaves = models.trainable(params)
    opt = torch.optim.AdamW(leaves, lr=cfg["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1)
    tokens = torch.from_numpy(tokens).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS:
        setattr(attention, c, 0)
    losses, step_s, first_t = [], [], None
    for _ in range(cfg["warm"] + cfg["timed"]):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = models.loss_fn(params, {"tokens": tokens}, mcfg,
                              attn_impl=None, remat=False)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        first_t = first_t or time.time()
    return {"losses": losses, "step_s": step_s, "enter_t": t_enter,
            "first_step_t": first_t,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device": torch.cuda.get_device_name(0),
            **{c: getattr(attention, c) for c in COUNTERS}}
'''

# The job's entrypoint (written into its working_dir): `python job22.py
# train|hold`. It connects through RAY_TPU_TORCH_ADDRESS, which the
# job manager sets, and starts one actor with the card in the pip env.
JOB_SCRIPT = '''"""Phase 22's job: `python job22.py train|hold`."""
import json
import os
import subprocess
import sys
import time

t_start = time.time()

import numpy as np

import ray_tpu_torch as rt

cfg = json.load(open(os.environ["P22_CONFIG"]))
mode = sys.argv[1]
rt.init()


@rt.remote(num_gpus=1, runtime_env={
    "pip": {"packages": [cfg["wheel"]], "no_index": True, "no_deps": True},
    "py_modules": [cfg["step_dir"]]})
class Trainer:
    def __init__(self):
        self.init_t = time.time()

    def _torch(self):
        """`import torch`, timed: an env worker is not forked from the
        worker template, so it pays this itself."""
        before = "torch" in sys.modules
        t0 = time.perf_counter()
        import torch
        return torch, {"torch_before": before,
                       "import_s": time.perf_counter() - t0}

    def probe(self):
        import os

        probe = __import__(cfg["probe"])
        venv = os.path.dirname(os.path.dirname(sys.executable))
        return {"executable": sys.executable, "probe": probe.MAGIC,
                "gpu_ids": rt.get_gpu_ids(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "pid": os.getpid(), "init_t": self.init_t,
                "venv_started": os.path.getmtime(
                    os.path.join(venv, "pyvenv.cfg")),
                "venv_built": os.path.getmtime(
                    os.path.join(venv, ".ray_tpu_ok"))}

    def run(self, tokens, step_cfg):
        _, imported = self._torch()
        step = __import__(cfg["step_package"])
        return {**imported, **step.train(tokens, step_cfg)}

    def hold(self):
        """Hold the card's lease; no torch, no CUDA context (the first
        job's actor measured an env worker's `import torch`)."""
        return self.probe()


def card_pids():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except OSError:
        return None
    return [int(x) for x in out.split() if x.strip().isdigit()]


t_create = time.time()
a = Trainer.remote()
out = rt.get(a.hold.remote() if mode == "hold" else a.probe.remote(),
             timeout=900)
out["create_t"] = t_create
if mode == "hold":
    print("P22_HOLDING " + json.dumps(out), flush=True)
    time.sleep(3600)
if mode == "train":
    out.update(rt.get(a.run.remote(np.load("tokens.npy"), cfg["step"]),
                      timeout=900))
torch = sys.modules.get("torch")
out["driver"] = {
    "pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "torch_loaded": torch is not None,
    "cuda_initialized": bool(torch and torch.cuda.is_initialized()),
    "card_pids": card_pids(), "start_t": t_start}
print("P22_RESULT " + json.dumps(out), flush=True)
'''


class JobRoutes:
    """A phase 22 job's submit, status, logs and stop: over the dashboard's
    HTTP API where aiohttp is installed, else through the CLI."""

    def __init__(self, cli, url):
        self.cli, self.url = cli, url

    def _http(self, path, body=None):
        import urllib.request

        req = urllib.request.Request(
            self.url + path, method="GET" if body is None else "POST",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def submit(self, entrypoint, runtime_env, metadata):
        if self.url:
            return self._http("/api/jobs", {
                "entrypoint": entrypoint, "runtime_env": runtime_env,
                "metadata": metadata})["job_id"]
        out = self.cli("job", "submit", "--no-wait", "--runtime-env",
                       json.dumps(runtime_env), "--", *entrypoint.split())
        return re.search(r"submitted job (\S+)", out).group(1)

    def status(self, jid):
        if self.url:
            return self._http(f"/api/jobs/{jid}")["status"]
        return self.cli("job", "status", jid).strip()

    def logs(self, jid):
        if self.url:
            return self._http(f"/api/jobs/{jid}/logs")["logs"]
        return self.cli("job", "logs", jid)

    def wait(self, jid, until, timeout):
        """Poll until the status is in ``until``: (status, seconds)."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            status = self.status(jid)
            if status in until:
                return status, time.perf_counter() - t0
            time.sleep(0.1)
        raise AssertionError(f"phase 22: job {jid} still {status} after "
                             f"{timeout} s:\n{self.logs(jid)[-4000:]}")


def _job_line(logs, tag):
    for line in logs.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise AssertionError(f"phase 22: no {tag} line in the job's log:\n"
                         f"{logs[-4000:]}")


def runtime_env_jobs(tokens, dense):
    """Phase 22 (see the module docstring). Returns the training job's
    launches."""
    import shutil
    import socket
    import tempfile

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private.node import session_leftovers
    from ray_tpu_torch.runtime_env.wheel import write_wheel

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rtj")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RAY_TPU_TORCH_TMPDIR=root,
               RAY_TPU_TORCH_VENV_ROOT=os.path.join(root, "venvs"),
               RAY_TPU_TORCH_PKG_CACHE=os.path.join(root, "pkgs"),
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("RAY_TPU_TORCH_ADDRESS", None)

    def cli(*args, timeout=120):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                              env=env, cwd=repo, capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"phase 22: `{' '.join(args)}` exited "
                                 f"{proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        log(f"phase 22: `python -m ray_tpu_torch {' '.join(args)[:60]}` in "
            f"{time.perf_counter() - t0} s")
        return proc.stdout

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    connected = started = False
    try:
        # 1. the cluster, from the CLI
        out = cli("start", "--head", "--num-cpus", "4", "--num-gpus", "1",
                  "--port", str(port))
        started = True
        address = re.search(r"address: (\S+)", out).group(1)
        status = cli("status")
        if "  0/1 GPU" not in status:
            raise AssertionError(f"phase 22: status shows no free GPU:\n"
                                 f"{status}")
        log(f"phase 22: cluster at {address}; status:\n{status}")
        # 2. the probe wheel, the step package and the job's working_dir
        wheel = write_wheel(root, JOB_PROBE, {
            f"{JOB_PROBE}/__init__.py": b"MAGIC = 'probe-22'\n"})
        step_dir = os.path.join(root, JOB_STEP_PACKAGE)
        work = os.path.join(root, "job")
        os.makedirs(step_dir)
        os.makedirs(work)
        with open(os.path.join(step_dir, "__init__.py"), "w") as f:
            f.write(JOB_STEP_SOURCE)
        with open(os.path.join(work, "job22.py"), "w") as f:
            f.write(JOB_SCRIPT)
        np.save(os.path.join(work, "tokens.npy"), tokens.cpu().numpy())
        with open(os.path.join(work, "config.json"), "w") as f:
            json.dump({"wheel": wheel, "step_dir": step_dir,
                       "probe": JOB_PROBE, "step_package": JOB_STEP_PACKAGE,
                       "step": {"seed": 7, "lr": LR, "warm": JOB_STEPS[0],
                                "timed": JOB_STEPS[1]}}, f)
        renv = {"working_dir": work, "env_vars": {
            "P22_CONFIG": "config.json", "PYTHONUNBUFFERED": "1"}}
        # 3. the dashboard (the phase's driver starts it), or the CLI
        ray_tpu_torch.init(address=address)
        connected = True
        try:
            import aiohttp  # noqa: F401 - only whether it is installed
            from ray_tpu_torch.dashboard import start_dashboard

            url = start_dashboard(port=0)
            log(f"phase 22: dashboard at {url}")
        except ImportError:
            url = None
            log("phase 22: aiohttp is not installed: no dashboard; the jobs "
                "go through the CLI")
        jobs = JobRoutes(cli, url)

        def submit(mode, until):
            t0 = time.perf_counter()
            jid = jobs.submit(f"{sys.executable} job22.py {mode}", renv,
                              {"phase": "22", "mode": mode})
            status, s = jobs.wait(jid, until, JOB_TIMEOUT_S)
            log(f"phase 22: job {jid} ({mode}) {status} "
                f"{time.perf_counter() - t0} s after its submit")
            return jid, status, time.perf_counter() - t0

        # 4-6. the training job: its actor in the venv, pinned, through K2
        jid, _, to_running = submit("train", ("RUNNING", "SUCCEEDED",
                                              "FAILED"))
        status, _ = jobs.wait(jid, ("SUCCEEDED", "FAILED", "STOPPED"),
                              JOB_TIMEOUT_S)
        logs = jobs.logs(jid)
        if status != "SUCCEEDED":
            raise AssertionError(f"phase 22: job {jid} {status}:\n"
                                 f"{logs[-4000:]}")
        r = _job_line(logs, "P22_RESULT")
        venv_root = env["RAY_TPU_TORCH_VENV_ROOT"]
        want = dense["losses"][:sum(JOB_STEPS)]
        diff = [abs(x - w) / abs(w) for x, w in zip(r["losses"], want)]
        n = dense["launches"] // 6  # phase 8's launches a step
        counts = {c: r[c] for c in COUNTERS}
        expect = {"launches": n * sum(JOB_STEPS),
                  "bwd_launches": n * sum(JOB_STEPS), "stats_launches": 0}
        drv = r["driver"]
        problems = [
            *([f"actor's interpreter {r['executable']} is not in the venv "
               f"root {venv_root}"]
              if not r["executable"].startswith(venv_root) else []),
            *([f"probe {r['probe']!r}"] if r["probe"] != "probe-22" else []),
            *([f"actor pinned to {r['gpu_ids']}, CUDA_VISIBLE_DEVICES "
               f"{r['visible']!r}"]
              if r["gpu_ids"] != ["0"] or r["visible"] != "0" else []),
            *([f"losses {r['losses']}, phase 8's {want}"]
              if len(diff) != len(want) or
              not all(d <= RUNTIME_LOSS_RTOL for d in diff) else []),
            *([f"launches {counts}, expected {expect}"]
              if counts != expect else []),
            # the entrypoint's driver holds no lease: no pin of its own
            # (the cluster's environment is what it inherits) and no CUDA
            *([f"entrypoint CUDA_VISIBLE_DEVICES {drv['visible']!r}, the "
               f"cluster's {os.environ.get('CUDA_VISIBLE_DEVICES')!r}"]
              if drv["visible"] != os.environ.get("CUDA_VISIBLE_DEVICES")
              else []),
            *(["the entrypoint initialised CUDA"]
              if drv["cuda_initialized"] else []),
            *([f"the entrypoint {drv['pid']} is among the card's processes "
               f"{drv['card_pids']}"]
              if drv["card_pids"] and drv["pid"] in drv["card_pids"]
              else [])]
        if problems:
            raise AssertionError(f"phase 22: {problems}")
        step_ms = [x * 1e3 for x in r["step_s"]]
        timed_ms = sum(step_ms[JOB_STEPS[0]:]) / JOB_STEPS[1]
        card = ("the actor on the card's process list"
                if drv["card_pids"] and r["pid"] in drv["card_pids"] else
                f"nvidia-smi lists {drv['card_pids']}, not the actor's pid "
                f"{r['pid']} (another pid namespace): not held by pid")
        build_s = r["venv_built"] - r["venv_started"]
        log(f"phase 22 train job: submit to RUNNING {to_running} s; actor "
            f"in {r['executable']} pinned to {r['gpu_ids']} "
            f"(CUDA_VISIBLE_DEVICES {r['visible']}), probe {r['probe']}; "
            f"venv built in {build_s} s (pyvenv.cfg to its marker); actor "
            f"created {r['create_t'] - drv['start_t']} s after the "
            f"entrypoint started, its __init__ {r['init_t'] - r['create_t']}"
            f" s after the create, `import torch` there "
            f"{r['import_s']} s (torch loaded before: {r['torch_before']}); "
            f"actor start to the first step's end "
            f"{r['first_step_t'] - r['init_t']} s")
        log(f"phase 22 train job: losses {r['losses']}, phase 8's {want}, "
            f"relative differences {diff}; launches {counts}; ms/step "
            f"{step_ms} (timed mean {timed_ms}) against phase 8's "
            f"{dense['step_ms']}; peak memory {r['peak_gib']} GiB on "
            f"{r['device']}; entrypoint driver: CUDA_VISIBLE_DEVICES "
            f"{drv['visible']!r}, torch loaded {drv['torch_loaded']}, CUDA "
            f"initialised {drv['cuda_initialized']}; {card}")
        # 7. a second job with the same pip env reuses the venv, and is
        # stopped while its actor holds the card's lease
        jid2, _, _ = submit("hold", ("RUNNING",))
        t0 = time.perf_counter()
        while "P22_HOLDING" not in jobs.logs(jid2):
            if time.perf_counter() - t0 > JOB_TIMEOUT_S:
                raise AssertionError(f"phase 22: job {jid2} never held the "
                                     f"card:\n{jobs.logs(jid2)[-4000:]}")
            time.sleep(0.2)
        held = _job_line(jobs.logs(jid2), "P22_HOLDING")
        free = ray_tpu_torch.available_resources().get("GPU", 0.0)
        if held["executable"] != r["executable"] or \
                held["venv_built"] != r["venv_built"] or \
                held["probe"] != "probe-22" or held["gpu_ids"] != ["0"] or \
                held["visible"] != "0" or free != 0.0:
            raise AssertionError(f"phase 22: the second job's actor {held}, "
                                 f"{free} GPU free; the first's venv "
                                 f"{r['executable']} built at "
                                 f"{r['venv_built']}")
        log(f"phase 22 hold job: the venv reused (its marker from "
            f"{held['venv_built']}, the first job's); env setup: first job "
            f"{r['init_t'] - r['create_t']} s from the actor's create to its"
            f" __init__ (the venv built in {build_s} s), second job "
            f"{held['init_t'] - held['create_t']} s")
        cli("job", "stop", jid2)
        t0 = time.perf_counter()
        while ray_tpu_torch.available_resources().get("GPU", 0.0) != 1.0:
            if time.perf_counter() - t0 > JOB_STOP_S:
                raise AssertionError(
                    f"phase 22: the card's share not back "
                    f"{JOB_STOP_S} s after `job stop`: "
                    f"{ray_tpu_torch.available_resources()}")
            time.sleep(0.1)
        back_s = time.perf_counter() - t0
        status, _ = jobs.wait(jid2, ("STOPPED",), 30)
        log(f"phase 22 hold job: {status}; the card's share back {back_s} s "
            f"after `job stop`")
    except BaseException:
        log(_session_log_tails(root=root))
        raise
    finally:
        if connected:
            ray_tpu_torch.shutdown()  # a connected driver only disconnects
        # 8. the cluster stops and leaves nothing behind
        if started:
            stop = subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch", "stop"], env=env,
                cwd=repo, capture_output=True, text=True, timeout=120)
            t0 = time.perf_counter()
            while session_leftovers(root)[0] and \
                    time.perf_counter() - t0 < 30:
                time.sleep(0.2)
        left, arenas = session_leftovers(root)
        for pid in left:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        for p in arenas:
            try:
                os.unlink(p)
            except OSError:
                pass
        shutil.rmtree(root, ignore_errors=True)
    if stop.stdout != "cluster stopped\n" or left or arenas:
        raise AssertionError(f"phase 22: `stop` said {stop.stdout!r} "
                             f"{stop.stderr[-2000:]!r}; processes left "
                             f"{left}, arenas left {arenas}")
    log(f"phase 22: `stop` left no process and no arena; phase 22 done in "
        f"{time.perf_counter() - t_phase} s")
    return dict(counts, step_ms=timed_ms)


# Phase 23: the autoscaler, a ray:// driver, an ActorPool and a C++ caller.
# A head with no GPU and a TCP port; the port's Autoscaler in this process
# over LocalNodeProvider, one node type "h100" of one card that it starts
# for the driver's pending half-card actors and terminates once idle.
AUTOSCALE_TYPE = {"CPU": 4.0, "GPU": 1.0}
AUTOSCALE_IDLE_S = 5.0    # the node type's idle timeout
AUTOSCALE_DOWN_S = 15.0   # idle to terminated within the timeout + this
POOL_BATCHES = (8, 4, 512)  # batches of [prompts, tokens] through the pool
POOL_SEED = 23
POOL_WEIGHTS_SEED = 7     # phase 8's
POOL_FN = "h100_next_tokens"

# The ray:// driver (a subprocess): it connects over the head's TCP port,
# asks for two named half-card actors that draw LLAMA3_1B on the card,
# maps the prompt batches through an ActorPool of them, registers POOL_FN
# for other languages and runs the C++ caller, then kills the actors. It
# moves only numpy, so it never imports torch.
POOL_DRIVER = '''"""Phase 23's ray:// driver: `python - config.json`."""
import json
import os
import subprocess
import sys
import time

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch import cross_language
from ray_tpu_torch.util import ActorPool

cfg = json.load(open(sys.argv[1]))
t0 = time.time()
ctx = rt.client(cfg["address"]).namespace("p23").connect()
out = {"connect_s": time.time() - t0}


@rt.remote(num_gpus=0.5)
class NextTokens:
    """LLAMA3_1B at full width, bf16 on the card, from phase 8's seed."""

    def __init__(self, seed):
        import torch

        from ray_tpu_torch import models
        from ray_tpu_torch.ops import attention

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = models.LLAMA3_1B
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = models.init_params(self.cfg, gen, device="cuda")
        torch.cuda.synchronize()
        attention.launches = 0
        self.ready_t = time.time()

    def next_tokens(self, prompts):
        """The argmax of the last position's logits, a forward under
        no_grad (K1 in every layer)."""
        import torch

        from ray_tpu_torch import models

        with torch.no_grad():
            tokens = torch.from_numpy(np.asarray(prompts)).to("cuda").long()
            logits = models.forward(self.params, tokens, self.cfg)
            return logits[:, -1].argmax(-1).cpu().numpy().astype(np.int32)

    def probe(self):
        from ray_tpu_torch.ops import attention

        return {"gpu_ids": rt.get_gpu_ids(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "launches": attention.launches, "pid": os.getpid(),
                "ready_t": self.ready_t}


def h100_next_tokens(prompts):
    """The cross-language face: a batch of prompts (lists of ids) in, the
    next token of each out, from lm0."""
    import numpy as np

    import ray_tpu_torch as rt

    lm = rt.get_actor("lm0", namespace="p23")
    nxt = lm.next_tokens.remote(np.asarray(prompts, dtype=np.int32))
    return rt.get(nxt, timeout=600).tolist()


prompts = np.load(cfg["prompts"])
out["demand_t"] = time.time()
lms = [NextTokens.options(name=f"lm{i}").remote(cfg["seed"])
       for i in range(2)]
ready = rt.get([a.probe.remote() for a in lms], timeout=600)
out["ready_t"] = time.time()
pool = ActorPool(lms)
t0 = time.perf_counter()
out["pool_tokens"] = [t.tolist() for t in pool.map(
    lambda a, batch: a.next_tokens.remote(batch), list(prompts))]
out["pool_s"] = time.perf_counter() - t0
after_pool = rt.get([a.probe.remote() for a in lms], timeout=60)

cross_language.register_function(cfg["function"], h100_next_tokens)
t0 = time.perf_counter()
while not os.path.exists(cfg["built"]):
    if time.perf_counter() - t0 > 300:
        raise SystemExit("the C++ caller never finished building")
    time.sleep(0.05)
out["build_wait_s"] = time.perf_counter() - t0
built = json.load(open(cfg["built"]))
if built["rc"] != 0:
    raise SystemExit(f"g++ failed: {built['err']}")
t0 = time.perf_counter()
cpp = subprocess.run([cfg["binary"], cfg["gcs"], cfg["prompts_txt"]],
                     capture_output=True, text=True, timeout=600)
out["cpp_process_s"] = time.perf_counter() - t0
if cpp.returncode != 0:
    raise SystemExit(f"the C++ caller exited {cpp.returncode}: "
                     f"{cpp.stdout} {cpp.stderr}")
out["cpp"] = json.loads(next(line for line in cpp.stdout.splitlines()
                             if line.startswith("P23_CPP "))[8:])
out["probes"] = rt.get([a.probe.remote() for a in lms], timeout=60)
out["pool_launches"] = [p["launches"] for p in after_pool]
cross_language.unregister_function(cfg["function"])
out["kill_t"] = time.time()
for a in lms:
    rt.kill(a)
ctx.disconnect()
out["torch"] = "torch" in sys.modules
print("P23_RESULT " + json.dumps(out), flush=True)
'''

# The C++ caller (built with g++ against the port's client header while
# the cluster starts): batch 0's prompts, one row of ids a line, sent to
# POOL_FN; it prints the tokens and the call's round trip.
POOL_CPP = r'''// Phase 23's C++ caller: p23 <gcs host:port> <prompts file>
#include <chrono>
#include <cstdio>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include "ray_tpu_client.hpp"

using ray_tpu_torch::Client;
using ray_tpu_torch::Value;

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <address> <prompts>\n", argv[0]);
    return 2;
  }
  try {
    Value batch;
    batch.type = Value::ARRAY;
    std::ifstream in(argv[2]);
    std::string line;
    while (std::getline(in, line)) {
      if (line.empty()) continue;
      Value row;
      row.type = Value::ARRAY;
      std::istringstream ids(line);
      long long id;
      while (ids >> id) row.arr.push_back(Client::make_int(id));
      batch.arr.push_back(row);
    }
    Client client(argv[1]);
    auto t0 = std::chrono::steady_clock::now();
    Value out = client.call("h100_next_tokens", {batch}, 600.0);
    double ms = std::chrono::duration<double, std::milli>(
        std::chrono::steady_clock::now() - t0).count();
    std::printf("P23_CPP {\"tokens\": [");
    for (size_t i = 0; i < out.arr.size(); ++i)
      std::printf("%s%lld", i ? ", " : "",
                  static_cast<long long>(out.arr[i].i));
    std::printf("], \"rows\": %zu, \"cols\": %zu, \"ms\": %.6f}\n",
                batch.arr.size(),
                batch.arr.empty() ? size_t{0} : batch.arr[0].arr.size(), ms);
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "FAILED: %s\n", e.what());
    return 1;
  }
}
'''


def _build_cpp(src, binary, include, marker):
    """g++ of the C++ caller; its exit code, seconds and errors go to
    ``marker`` (written last, by a rename), which the driver waits for."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", "-std=c++17", "-O2", "-o", binary,
                               src, "-I", include], capture_output=True,
                              text=True, timeout=300)
        rec = {"rc": proc.returncode, "err": proc.stderr[-4000:]}
    except (OSError, subprocess.TimeoutExpired) as e:
        rec = {"rc": -1, "err": repr(e)}
    rec["s"] = time.perf_counter() - t0
    with open(marker + ".tmp", "w") as f:
        json.dump(rec, f)
    os.rename(marker + ".tmp", marker)


def autoscaled_pool(models):
    """Phase 23 (see the module docstring). Returns the actors' K1
    launches."""
    import shutil
    import socket
    import tempfile
    import threading

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private.node import (HeadNode, pids_with_env,
                                             session_leftovers)
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                          LocalNodeProvider, NodeTypeConfig)

    t_phase = time.perf_counter()
    cfg = models.LLAMA3_1B
    root = tempfile.mkdtemp(prefix="rta")
    repo = os.path.dirname(os.path.abspath(__file__))
    # 1. the C++ caller builds while the cluster comes up
    paths = {k: os.path.join(root, k) for k in
             ("p23.cc", "p23", "p23.built", "prompts.npy", "prompts.txt",
              "config.json")}
    with open(paths["p23.cc"], "w") as f:
        f.write(POOL_CPP)
    builder = threading.Thread(target=_build_cpp, args=(
        paths["p23.cc"], paths["p23"],
        os.path.join(repo, "ray_tpu_torch", "native", "cpp_client"),
        paths["p23.built"]), daemon=True)
    builder.start()
    prompts = np.random.default_rng(POOL_SEED).integers(
        0, cfg.vocab_size, POOL_BATCHES, dtype=np.int32)
    np.save(paths["prompts.npy"], prompts)
    with open(paths["prompts.txt"], "w") as f:
        f.writelines(" ".join(map(str, row)) + "\n" for row in prompts[0])
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    head = scaler = provider = None
    connected = False
    try:
        # 2. the head (no GPU, a TCP port) and the autoscaler
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        head = HeadNode(num_cpus=2, num_gpus=0, probe_gpu=False, port=port,
                        num_initial_workers=1)
        provider = LocalNodeProvider(head.address, head.session_dir)
        scaler = Autoscaler(AutoscalerConfig(
            node_types={"h100": NodeTypeConfig(
                resources=dict(AUTOSCALE_TYPE), min_workers=0,
                max_workers=1)},
            idle_timeout_s=AUTOSCALE_IDLE_S, update_interval_s=0.25),
            provider, head.address)
        scaler.start()
        ray_tpu_torch.init(address=head.address)
        connected = True
        if "GPU" in ray_tpu_torch.cluster_resources():
            raise AssertionError(f"phase 23: the head has a GPU: "
                                 f"{ray_tpu_torch.cluster_resources()}")
        log(f"phase 23: head at {head.tcp_address} (no GPU) up "
            f"{time.perf_counter() - t_phase} s into the phase")
        # 3. the ray:// driver
        with open(paths["config.json"], "w") as f:
            json.dump({"address": "ray://" + head.tcp_address,
                       "gcs": head.tcp_address, "seed": POOL_WEIGHTS_SEED,
                       "function": POOL_FN, "prompts": paths["prompts.npy"],
                       "prompts_txt": paths["prompts.txt"],
                       "binary": paths["p23"], "built": paths["p23.built"]},
                      f)
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for k in ("RAY_TPU_TORCH_ADDRESS", "RAY_TPU_TORCH_TMPDIR"):
            env.pop(k, None)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-", paths["config.json"]],
                              input=POOL_DRIVER, env=env, cwd=root,
                              capture_output=True, text=True, timeout=900)
        driver_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 23: the driver exited "
                                 f"{proc.returncode}:\n{proc.stdout[-4000:]}"
                                 f"\n{proc.stderr[-6000:]}")
        r = json.loads(next(line for line in proc.stdout.splitlines()
                            if line.startswith("P23_RESULT "))[11:])
        with open(paths["p23.built"]) as f:
            built = json.load(f)
        # 4. the node terminated once idle, and nothing of it left
        (inst,) = scaler.im.instances.values()
        node_env = f"RAY_TPU_TORCH_NODE_ID={inst.node_id_hex}"
        deadline = r["kill_t"] + AUTOSCALE_IDLE_S + AUTOSCALE_DOWN_S
        # the provider drops the instance before the autoscaler records
        # its TERMINATING: wait for both
        while time.time() < deadline and (
                inst.state not in ("TERMINATING", "TERMINATED")
                or provider.non_terminated_nodes() or pids_with_env(node_env)
                or "GPU" in ray_tpu_torch.cluster_resources()):
            time.sleep(0.1)
        left_pids = pids_with_env(node_env)
        resources = ray_tpu_torch.cluster_resources()
        down_t = time.time()
        history = {state: t for t, state, _ in inst.history}
        if provider.non_terminated_nodes() or left_pids or \
                "GPU" in resources or "TERMINATING" not in history:
            raise AssertionError(
                f"phase 23: {AUTOSCALE_IDLE_S + AUTOSCALE_DOWN_S} s after "
                f"the actors went: instances "
                f"{provider.non_terminated_nodes()}, the node's processes "
                f"{left_pids}, resources {resources}, history "
                f"{inst.history}")
    except BaseException:
        log(_session_log_tails(root=root))
        raise
    finally:
        if connected:
            ray_tpu_torch.shutdown()  # a connected driver only disconnects
        if scaler is not None:
            scaler.stop()
        if provider is not None:
            provider.terminate_all()
        if head is not None:
            head.stop()
        t0 = time.perf_counter()
        while session_leftovers(root)[0] and time.perf_counter() - t0 < 30:
            time.sleep(0.2)
        left, arenas = session_leftovers(root)
        for pid in left:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        for p in arenas:
            try:
                os.unlink(p)
            except OSError:
                pass
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        builder.join(300)
        shutil.rmtree(root, ignore_errors=True)
    if left or arenas:
        raise AssertionError(f"phase 23: processes left {left}, arenas left "
                             f"{arenas}")
    # 5. the same next tokens in process, from the same weights
    gen = torch.Generator(device="cuda").manual_seed(POOL_WEIGHTS_SEED)
    params = models.init_params(cfg, gen, device="cuda")
    want = []
    with torch.no_grad():
        for batch in prompts:
            tokens = torch.from_numpy(np.asarray(batch)).to("cuda").long()
            logits = models.forward(params, tokens, cfg)
            want.append(logits[:, -1].argmax(-1).cpu().numpy()
                        .astype(np.int32).tolist())
    del params, logits
    launches = [p["launches"] for p in r["probes"]]
    served = [n // cfg.n_layers for n in r["pool_launches"]]
    problems = [
        *([f"pool tokens {r['pool_tokens']}, in process {want}"]
          if r["pool_tokens"] != want else []),
        *([f"C++ tokens {r['cpp']['tokens']}, in process {want[0]}"]
          if r["cpp"]["tokens"] != want[0]
          or [r["cpp"]["rows"], r["cpp"]["cols"]] != list(POOL_BATCHES[1:])
          else []),
        *([f"actors pinned to "
           f"{[(p['gpu_ids'], p['visible']) for p in r['probes']]}"]
          if any(p["gpu_ids"] != ["0"] or p["visible"] != "0"
                 for p in r["probes"]) else []),
        *([f"K1 launches {launches} (after the pool {r['pool_launches']})"
           f", expected {cfg.n_layers} x the batches each served, plus "
           f"{cfg.n_layers} in lm0 for the C++ call, "
           f"{cfg.n_layers * (POOL_BATCHES[0] + 1)} in all"]
          if sum(launches) != cfg.n_layers * (POOL_BATCHES[0] + 1)
          or sum(served) != POOL_BATCHES[0]
          or any(n % cfg.n_layers for n in r["pool_launches"])
          or launches != [r["pool_launches"][0] + cfg.n_layers,
                          r["pool_launches"][1]] else []),
        *(["the ray:// driver imported torch"] if r["torch"] else [])]
    if problems:
        raise AssertionError(f"phase 23: {problems}")
    registered = history["RAY_RUNNING"]
    idle_to_down = history["TERMINATING"] - r["kill_t"]
    per_batch_ms = r["pool_s"] * 1e3 / POOL_BATCHES[0]
    log(f"phase 23: demand to node registered {registered - r['demand_t']}"
        f" s (instance allocated {history['ALLOCATED'] - r['demand_t']} s "
        f"after the demand); node registered to both actors ready "
        f"{r['ready_t'] - registered} s (each actor's __init__ done "
        f"{[p['ready_t'] - registered for p in r['probes']]} s after); "
        f"the driver's connect {r['connect_s']} s")
    log(f"phase 23: the pool mapped {POOL_BATCHES[0]} batches of "
        f"{POOL_BATCHES[1:]} in {r['pool_s']} s = {per_batch_ms} ms a batch,"
        f" {POOL_BATCHES[0] * POOL_BATCHES[1] / r['pool_s']} prompts/s "
        f"(the first batch on each actor included); batches served "
        f"{served}; tokens equal the in-process forward's")
    log(f"phase 23: the C++ call's round trip {r['cpp']['ms']} ms (its "
        f"process {r['cpp_process_s']} s), its tokens {r['cpp']['tokens']} "
        f"equal batch 0's; g++ {built['s']} s, the driver waited "
        f"{r['build_wait_s']} s for it; K1 in the actors {launches}; "
        f"actors pinned to {[p['gpu_ids'] for p in r['probes']]}; the "
        f"driver loaded torch: {r['torch']}")
    log(f"phase 23: idle to node terminated {idle_to_down} s (terminated "
        f"{history.get('TERMINATED', down_t) - r['kill_t']} s, the GPU gone"
        f" from cluster_resources and no process of the node "
        f"{down_t - r['kill_t']} s after the actors went); the driver "
        f"{driver_s} s; phase 23 done in {time.perf_counter() - t_phase} s")
    return {"launches": sum(launches), "bwd_launches": 0,
            "launches_by_actor": launches}


# Phase 24: rl/'s learner stack and the Podracer tier. The pixel module at
# ViT-B/16's widths on 64 x 64 x 1 CatchEnv pixels: 16 patches and the CLS
# token, 17 tokens, 12 heads of 64 (the kernels take head dims 64 and
# 128 only; the repo's pixel defaults' 8 would run dense_attention).
RL_IMAGE = 64
RL_PIXEL = {"patch_size": 16, "d_model": 768, "n_layers": 12,
            "n_heads": 12, "d_ff": 3072}
RL_SEED = 24
RL_T, RL_B = 16, 32          # (a)'s batch: 512 images an update
# CatchEnv(64)'s episodes are 63 steps, all 32 envs in step: a first
# fragment of RL_WARM_STEPS puts (a)'s batch over their end, a done in
# row 10 and the autoreset row that the mask drops in row 11.
RL_WARM_STEPS = RL_IMAGE - 12
RL_RUNNER_OBS = 16           # (a)'s runner call
RL_UPDATES = 4               # (b)'s least updates
RL_TIMED = 3                 # (a)'s timed updates after the held one
# (a)'s update against the same update with flash_attention_plain. The
# stats: fp32 sums over 512 rows and 12 layers in another order, held at
# RL_STATS_RTOL. The parameters after one Adam step: where a gradient is
# far from zero both steps are lr x its sign to within fp32 rounding, so
# an entry may differ by more than RL_PARAM_ATOL only where the two
# gradients straddle zero; such entries stay within 2 lr (two opposite
# steps) and are at most RL_PARAM_FLIP_SHARE of all.
RL_STATS_RTOL = 1e-4
RL_PARAM_ATOL = 1e-6
RL_PARAM_FLIP_SHARE = 1e-4
# The runner's logits and values against the plain attention's: fp32
# forwards that differ in the order of the attention's sums.
RL_FWD_TOL = (1e-4, 1e-4)    # atol, rtol
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores


class FlatCatch:
    """CatchEnv(size) with its pixels flattened, for PPO's MLP module."""

    def __init__(self, size):
        from ray_tpu_torch.rl import CatchEnv
        from ray_tpu_torch.rl.pixel_env import Box

        self.env = CatchEnv(size)
        self.observation_space = Box(0.0, 1.0, (size * size,))
        self.action_space = self.env.action_space

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed)
        return obs.reshape(-1), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        return obs.reshape(-1), reward, term, trunc, info

    def close(self):
        pass


class NumpyPendulum:
    """gymnasium's Pendulum-v1 in numpy (the H100 machine has no
    gymnasium): the same dynamics, reward, spaces, reset draws (a PCG64
    generator from the seed) and 200-step time limit."""

    max_speed, max_torque, dt, g, m, l = 8, 2.0, 0.05, 10.0, 1.0, 1.0
    max_episode_steps = 200

    def __init__(self):
        import numpy as np

        from ray_tpu_torch.rl.pixel_env import Box

        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = Box(-high, high, (3,))
        self.action_space = Box(-self.max_torque, self.max_torque, (1,))
        self.np_random = np.random.default_rng()
        self.state = None
        self.steps = 0

    def _obs(self):
        import numpy as np

        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None:
            self.np_random = np.random.Generator(np.random.PCG64(
                np.random.SeedSequence(seed)))
        high = np.array([np.pi, 1.0])
        self.state = self.np_random.uniform(low=-high, high=high)
        self.steps = 0
        return self._obs(), {}

    def step(self, u):
        import numpy as np

        th, thdot = self.state
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        norm = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = norm ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th)
                            + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        self.state = np.array([th + newthdot * self.dt, newthdot])
        self.steps += 1
        return (self._obs(), -costs, False,
                self.steps >= self.max_episode_steps, {})

    def close(self):
        pass


def rl_kernel_rows(attention):
    """The fp32 L = 17 calls of phase 24: the learner's forward with lse
    and backward at [RL_T x RL_B, 17, 12, 64], a runner's forward at
    [RL_RUNNER_OBS, 17, 12, 64], each timed beside its plain version and
    sdpa, with the least time (fp32 operations at H100_FP32_FLOPS)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(RL_SEED)
    L, H, D = 17, RL_PIXEL["n_heads"], 64
    rows = {}
    for name, B in (("learner", RL_T * RL_B), ("runner", RL_RUNNER_OBS)):
        q, k, v = (torch.randn(B, L, H, D, generator=gen, device="cuda")
                   for _ in range(3))
        ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v), 20)
        plain = time_ms(lambda: attention.flash_attention_plain(
            q, k, v, return_lse=True), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                      20)
        nbytes = 4 * 4 * B * L * H * D
        t_bytes = nbytes / H100_BYTES_PER_S
        t_ops = 4 * B * H * D * L * L / H100_FP32_FLOPS
        o, lse = attention.flash_attention_fwd(q, k, v)
        ref, ref_lse = attention.flash_attention_plain(q, k, v,
                                                       return_lse=True)
        err, _ = hold(o, ref, FP32_TOL, FP32_TOL, f"phase 24 K2 {name}")
        hold(lse, ref_lse, LSE_TOL, 0.0, f"phase 24 K2 lse {name}")
        row = {"shape": f"B={B} L={L} H={H}/{H} D={D} non-causal fp32",
               "fwd_ms": ms, "fwd_plain_ms": plain, "fwd_library_ms": lib,
               "fwd_bound_ms": max(t_bytes, t_ops) * 1e3,
               "fwd_bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "fwd_max_abs_err": err}
        if name == "learner":
            do = torch.randn_like(q)
            bwd = time_ms(lambda: attention.flash_attention_bwd(
                q, k, v, o, lse, do), 20)
            bwd_plain = time_ms(lambda: attention.flash_attention_bwd_plain(
                q, k, v, o, lse, do), 5)
            qg, kg, vg = (t.detach().requires_grad_(True)
                          for t in (qt, kt, vt))
            out = F.scaled_dot_product_attention(qg, kg, vg)
            dot = do.transpose(1, 2)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), dot, retain_graph=True), 20)
            got = attention.flash_attention_bwd(q, k, v, o, lse, do)
            want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do)
            bwd_err = max(hold_grad(g, w, FP32_GRAD_RULE,
                                    f"phase 24 K2 bwd {n}")[0]
                          for n, g, w in zip("qkv", got, want))
            nbytes = 4 * (8 * B * L * H * D) + 2 * 4 * B * H * L
            t_bytes = nbytes / H100_BYTES_PER_S
            t_ops = 5 * 2 * B * H * D * L * L / H100_FP32_FLOPS
            row.update({"bwd_ms": bwd, "bwd_plain_ms": bwd_plain,
                        "bwd_library_ms": lib_bwd,
                        "bwd_bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bwd_bound_by": ("bytes" if t_bytes >= t_ops
                                         else "operations"),
                        "bwd_max_abs_err": bwd_err})
        rows[name] = row
        log(f"phase 24 K2 at the {name}'s shape: {json.dumps(row)}")
    return rows


def _rl_counts(attention):
    return {c: getattr(attention, c) for c in COUNTERS + ("dense_routes",)}


def _rl_reset(attention):
    for c in COUNTERS:
        setattr(attention, c, 0)


def rl_on_card(attention):
    """Phase 24 (a) in this process: a VtraceMeshLearner (4 ranks on the
    card) from seed RL_SEED, one update on RL_T x RL_B CatchEnv steps that
    a runner on the card collected, held to the same update with
    flash_attention_plain; then the runner's sample function on
    RL_RUNNER_OBS observations, held to the plain attention's forward.
    Returns the launches of both main paths and the timings."""
    import cloudpickle
    import numpy as np

    from ray_tpu_torch.rl import CatchEnv, PixelModuleConfig, PodracerConfig
    from ray_tpu_torch.rl import rl_module
    from ray_tpu_torch.rl.env_runner import EnvRunnerImpl
    from ray_tpu_torch.rl.mesh_learner import VtraceMeshLearner
    from ray_tpu_torch.ops.quant import tree_leaves

    t_phase = time.perf_counter()
    cfg = PixelModuleConfig(image_size=RL_IMAGE, channels=1, num_actions=3,
                            **RL_PIXEL)
    hp = PodracerConfig().hparams()
    learner = VtraceMeshLearner(cfg, hp, n_devices=4, seed=RL_SEED,
                                device="cuda")
    plain = VtraceMeshLearner(cfg, hp, n_devices=4, seed=RL_SEED,
                              device="cuda",
                              attn_impl=attention.flash_attention_plain)
    w0 = learner.get_weights()
    plain.set_weights(w0)
    n_params = sum(t.numel() for t in tree_leaves(w0))
    runner = EnvRunnerImpl(
        "catch", RL_B, cloudpickle.dumps(cfg), seed=RL_SEED,
        env_fn_blob=cloudpickle.dumps(lambda: CatchEnv(RL_IMAGE)),
        device="cuda")
    runner.sample(w0, RL_WARM_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ro = runner.sample(w0, RL_T)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    batch = {k: ro[k] for k in ("obs", "actions", "logp", "rewards",
                                "dones", "mask", "bootstrap_value")}
    if ro["mask"].all() or not ro["dones"].any():
        raise AssertionError("phase 24 (a): the batch has no episode end")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dense_before = attention.dense_routes
    # ---- the main path: counts reset just before, read just after
    _rl_reset(attention)
    t0 = time.perf_counter()
    stats = learner.update(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _rl_counts(attention)
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_layers = RL_PIXEL["n_layers"]
    if (counts["launches"] != n_layers or counts["bwd_launches"] != n_layers
            or counts["dense_routes"] != dense_before):
        raise AssertionError(f"phase 24 (a): the update launched {counts}, "
                             f"want {n_layers} forward and backward and "
                             f"dense_routes {dense_before}")
    want = plain.update(batch)
    for k, v in want.items():
        if not (math.isfinite(stats[k]) and
                abs(stats[k] - v) <= RL_STATS_RTOL * abs(v) + 1e-7):
            raise AssertionError(f"phase 24 (a) {k}: {stats[k]}, plain {v}")
    flips, total, worst = 0, 0, 0.0
    for a, b in zip(tree_leaves(learner.params), tree_leaves(plain.params)):
        d = (a.detach() - b.detach()).abs()
        flips += int((d > RL_PARAM_ATOL).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    if worst > 2 * hp["lr"] or flips > RL_PARAM_FLIP_SHARE * total:
        raise AssertionError(f"phase 24 (a): parameters differ from the "
                             f"plain update's by up to {worst}, {flips} of "
                             f"{total} beyond {RL_PARAM_ATOL}")
    log(f"phase 24 (a): {n_params} parameters; update on [{RL_T}, {RL_B}] "
        f"CatchEnv({RL_IMAGE}) steps: {json.dumps(stats)}; plain "
        f"attention's {json.dumps(want)}; parameters within "
        f"{RL_PARAM_ATOL} but {flips} of {total} (worst {worst}, lr "
        f"{hp['lr']}); launches {json.dumps(counts)}")
    del plain
    # the timed updates (the held one was the first: cuBLAS's first calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RL_TIMED):
        learner.update(batch)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3 / RL_TIMED
    # the runner's sample function on the card, the updated weights
    step = np.arange(RL_RUNNER_OBS)
    obs = batch["obs"][step % RL_T, step]
    params = learner.params
    sample = rl_module.make_sample_fn(cfg)
    g = torch.Generator(device="cuda").manual_seed(RL_SEED)
    sample(params, obs, g)
    torch.cuda.synchronize()
    # ---- the main path: counts reset just before, read just after
    _rl_reset(attention)
    t0 = time.perf_counter()
    actions, logp, values = sample(params, obs, g)
    sample_ms = (time.perf_counter() - t0) * 1e3
    runner_counts = _rl_counts(attention)
    # ---- end of the main path
    if (runner_counts["launches"] != n_layers
            or runner_counts["bwd_launches"]
            or runner_counts["dense_routes"] != dense_before):
        raise AssertionError(f"phase 24 (a): the runner's call launched "
                             f"{runner_counts}")
    x = torch.from_numpy(obs).cuda()
    with torch.no_grad():
        got = rl_module.make_forward(cfg)(params, x)
        ref = rl_module.make_forward(
            cfg, attn_impl=attention.flash_attention_plain)(params, x)
    for name, a, b in zip(("logits", "values"), got, ref):
        hold(a, b, *RL_FWD_TOL, f"phase 24 (a) runner {name}")
    if not np.allclose(values, ref[1].cpu().numpy(), atol=RL_FWD_TOL[0],
                       rtol=RL_FWD_TOL[1]):
        raise AssertionError("phase 24 (a): sampled values differ")
    out = {"launches": counts, "runner_launches": runner_counts,
           "update_ms": update_ms, "first_update_s": first_s,
           "images_per_s": RL_T * RL_B / (update_ms / 1e3),
           "env_step_ms": collect_s * 1e3 / (RL_T + 1),
           "sample_ms": sample_ms, "peak_gib": peak,
           "params": n_params}
    log(f"phase 24 (a): {update_ms} ms an update ({RL_TIMED} timed), "
        f"{out['images_per_s']} images/s, the first update {first_s} s; "
        f"peak {peak} GiB; the runner on the card: {out['env_step_ms']} ms "
        f"an env step of {RL_B} envs (forward included, {RL_T + 1} "
        f"forwards), the sample function {sample_ms} ms on "
        f"{RL_RUNNER_OBS} observations; (a) in "
        f"{time.perf_counter() - t_phase} s")
    del learner, runner, params
    return out


def _rl_rows(handles):
    """util.state's rows of these actor handles."""
    from ray_tpu_torch.util import state

    rows = {a["actor_id"]: a for a in state.list_actors()}
    return [rows[h._actor_id.hex()] for h in handles]


def rl_cluster():
    """Phase 24 (b) and (c) on the phase's cluster: the Podracer with its
    learner leasing the card and its runners on the CPU, RL_UPDATES or
    more updates; then PPO's learner on the card and a checkpoint round
    trip."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.rl import CatchEnv, PodracerConfig, PPOConfig
    from ray_tpu_torch.train.checkpoint import load_pytree
    from ray_tpu_torch.ops.quant import tree_leaves

    t_phase = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="rtt_rl")
    try:
        # (b) the Podracer
        t0 = time.perf_counter()
        serialization.reset_transport_stats()
        pod = (PodracerConfig()
               .environment("catch", env_fn=lambda: CatchEnv(RL_IMAGE))
               .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                            rollout_fragment_length=8)
               .aggregation(num_aggregators=1, agg_fanin=2, queue_depth=2)
               .learners(use_gpu=True)
               .training(broadcast_interval=2, pixel_model=RL_PIXEL)
               .debugging(seed=RL_SEED)).build()
        try:
            built_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            while pod._updates_done < RL_UPDATES:
                if pod.step(max_wall_s=120) == 0:
                    raise AssertionError("phase 24 (b): no update in 120 s")
            train_s = time.perf_counter() - t1
            m = pod.metrics()
            losses = m["learner_stats"]
            learner_row, *runner_rows = _rl_rows(
                [pod.learner] + pod.env_runner_group.runners)
            timings = ray_tpu_torch.get(
                [r.timings.remote() for r in pod.env_runner_group.runners])
        finally:
            pod.stop()
        bad = [s for s in losses for v in s.values() if not math.isfinite(v)]
        if bad or len(losses) != m["updates"]:
            raise AssertionError(f"phase 24 (b): losses {losses}")
        if learner_row["gpu_ids"] != ["0"] or any(
                r["gpu_ids"] for r in runner_rows):
            raise AssertionError(f"phase 24 (b): leases {learner_row}, "
                                 f"{runner_rows}")
        if not m["staleness"] or sum(m["staleness"].values()) < 2 * m[
                "updates"]:
            raise AssertionError(f"phase 24 (b): staleness {m['staleness']}")
        if m["transport"]["weight_bcast_puts"] != m["published_versions"]:
            raise AssertionError(f"phase 24 (b): {m['transport']} for "
                                 f"{m['published_versions']} publishes")
        log(f"phase 24 (b): {m['updates']} updates in {train_s} s (built in "
            f"{built_s} s), {m['env_steps']} env steps; losses "
            f"{json.dumps(losses)}; learner on {learner_row['gpu_ids']}, "
            f"runners on {[r['gpu_ids'] for r in runner_rows]}; staleness "
            f"{m['staleness']}; {m['published_versions']} publishes = "
            f"{m['transport']['weight_bcast_puts']} puts, each (learner to "
            f"driver s, the driver's put s) {m['publish_s']}; runners' pulls "
            f"s {[t['pull_s'] for t in timings]}, ms an env step of 4 envs "
            f"on the CPU {[t['env_step_ms'] for t in timings]}; restarts "
            f"{m['runner_restarts']}, queue {m['queue_occupancy']}")
        _replicas_gone(ray_tpu_torch, what="phase 24 (b)")
        # (c) PPO's learner on the card, two CPU runners
        t0 = time.perf_counter()
        algo = (PPOConfig()
                .environment("catch8", env_fn=lambda: FlatCatch(8))
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=16)
                .learners(num_learners=1, use_gpu=True)
                .training(minibatch_size=64, num_epochs=1)
                .debugging(seed=RL_SEED)).build()
        try:
            out = algo.train()
            (row,) = _rl_rows(algo.learner_group.learners)
            state = algo.get_state()
            algo.save_checkpoint(ckpt)
            algo.train()
            algo.restore_from_path(ckpt)
            back = algo.get_state()
            on_disk = load_pytree(ckpt)
        finally:
            algo.stop()
        if row["gpu_ids"] != ["0"] or not all(
                math.isfinite(v) for v in out["learner"].values()):
            raise AssertionError(f"phase 24 (c): {row}, {out['learner']}")
        for tree in (back["weights"], on_disk["weights"]):
            if not all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(tree), tree_leaves(state["weights"]))):
                raise AssertionError("phase 24 (c): the checkpoint did not "
                                     "round-trip")
        log(f"phase 24 (c): PPO on FlatCatch(8), learner on "
            f"{row['gpu_ids']}, stats {json.dumps(out['learner'])}, the "
            f"checkpoint round-tripped; (c) in {time.perf_counter() - t0} s")
        _replicas_gone(ray_tpu_torch, what="phase 24 (c)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"phase 24 (b) and (c) in {time.perf_counter() - t_phase} s")
    return {"podracer_updates": m["updates"], "publish_s": m["publish_s"],
            "pull_s": [t["pull_s"] for t in timings],
            "env_step_ms_cpu": [t["env_step_ms"] for t in timings]}


# Phase 25: rl/'s second half on phase 24's cluster. DreamerV3 at
# DreamerConfig's defaults on FlatCatch(8) (obs 64, 3 actions) with one
# [48, 8] batch (DreamerV3Algo's seq_len and batch_size), CQL at its
# defaults (256 x 256, 4 CQL actions) on obs 3 / act 1 at batch 256, BC and
# MARWIL over 2048 logged rows: each card update held to the same update
# on the CPU from the same weights and draws. Then DQN, SAC and
# DreamerV3Algo on the cluster, their learners on the card, and the static
# checks. No attention runs on this path: the kernels' counters must not
# move.
RL2_SEED = 25
RL2_DREAM_T, RL2_DREAM_B = 48, 8
RL2_CQL_BATCH = 256
RL2_ROW_STEPS = 256          # x 8 envs: the offline rows
RL2_OFFLINE_BATCH = 256
RL2_TIMED = 3
RL2_BURST = 16               # train_on calls timed on a cluster learner
# The held Dreamer update takes the generator's Gumbel draws scaled by
# RL2_GUMBEL_SCALE, so every categorical choice is the draws' alone: the
# card's and the CPU's logits differ in their last bits, which could flip a
# near tie between two classes and part the two updates. The timed updates
# draw as the algorithm does.
RL2_GUMBEL_SCALE = 1e3
RL2_DQN_UPDATES = 16         # DQNConfig's num_updates_per_iter
RL2_DQN_SYNC = 16            # target_network_update_freq (cut from 50)


def rl2_hold_update(name, stats, want, got_trees, want_trees, lrs):
    """A card update against the CPU's: stats within RL_STATS_RTOL, and
    each tree's parameters within RL_PARAM_ATOL but for at most
    RL_PARAM_FLIP_SHARE of them (gradients that straddle zero), all within
    2 lr. Returns the flips and the worst difference."""
    from ray_tpu_torch.ops.quant import tree_leaves

    for k, v in want.items():
        if not (math.isfinite(stats[k]) and
                abs(stats[k] - v) <= RL_STATS_RTOL * abs(v) + 1e-7):
            raise AssertionError(f"phase 25 {name} {k}: card {stats[k]}, "
                                 f"CPU {v}")
    flips, total, worst = 0, 0, 0.0
    for got, ref, lr in zip(got_trees, want_trees, lrs):
        tree_worst = 0.0
        for a, b in zip(tree_leaves(got), tree_leaves(ref)):
            d = (a.detach().cpu() - b.detach()).abs()
            flips += int((d > RL_PARAM_ATOL).sum())
            total += d.numel()
            tree_worst = max(tree_worst, float(d.max()))
        if tree_worst > 2 * lr:
            raise AssertionError(f"phase 25 {name}: parameters differ by "
                                 f"{tree_worst}, beyond 2 lr ({lr})")
        worst = max(worst, tree_worst)
    if flips > RL_PARAM_FLIP_SHARE * total:
        raise AssertionError(f"phase 25 {name}: {flips} of {total} "
                             f"parameters beyond {RL_PARAM_ATOL}")
    return {"flips": flips, "params": total, "worst": worst}


def rl2_in_process():
    """Phase 25 (a): DreamerV3, CQL, BC and MARWIL updates on the card, each
    held to the same update on the CPU; returns the timings."""
    import cloudpickle
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.rl import BC, CQL, MARWIL, DreamerV3, episodes_to_rows
    from ray_tpu_torch.rl.dreamerv3 import DreamerEnvRunnerImpl
    from ray_tpu_torch.rl.learner import copy_into, host_copy

    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # DreamerV3: the batch from a runner on the card, its filtered policy
    dream = DreamerV3(64, 3, seed=RL2_SEED, device="cuda")
    ref = DreamerV3(64, 3, seed=RL2_SEED, device="cpu")
    copy_into(ref.wm, host_copy(dream.wm))
    copy_into(ref.ac, host_copy(dream.ac))
    runner = DreamerEnvRunnerImpl(
        "catch8", RL2_DREAM_B, cloudpickle.dumps(dream.cfg), seed=RL2_SEED,
        env_fn_blob=cloudpickle.dumps(lambda: FlatCatch(8)), device="cuda")
    weights = {"wm": host_copy(dream.wm), "ac": host_copy(dream.ac)}
    runner.sample(weights, 1)
    t0 = time.perf_counter()
    batch = runner.sample(weights, RL2_DREAM_T)
    out["dreamer_env_step_ms"] = (time.perf_counter() - t0) * 1e3 / RL2_DREAM_T
    batch["first"][0] = 1.0
    if not batch["dones"].any():
        raise AssertionError("phase 25 (a): the Dreamer batch ends no episode")
    draws = {k: (v * RL2_GUMBEL_SCALE).cpu().numpy()
             for k, v in dream.draws(RL2_DREAM_T, RL2_DREAM_B).items()}
    t0 = time.perf_counter()
    stats = dream.train_on_batch(batch, draws=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ref.train_on_batch(batch, draws=draws)
    cpu_s = time.perf_counter() - t0
    held = rl2_hold_update("(a) DreamerV3", stats, want, (dream.wm, dream.ac),
                           (ref.wm, ref.ac), (1e-3, 3e-4))
    if not abs(float(dream.ret_ema) - float(ref.ret_ema)) <= 1e-6:
        raise AssertionError(f"phase 25 (a) DreamerV3 ret_ema "
                             f"{float(dream.ret_ema)}, CPU {float(ref.ret_ema)}")
    out["dreamer_update_ms"] = time_ms(
        lambda: dream.train_on_batch(batch), RL2_TIMED)
    log(f"phase 25 (a) DreamerV3 at DreamerConfig's defaults, [{RL2_DREAM_T}, "
        f"{RL2_DREAM_B}] FlatCatch(8): stats {json.dumps(stats)}; the CPU's "
        f"{json.dumps(want)}; parameters {json.dumps(held)}; the held update "
        f"{first_s} s (CPU {cpu_s} s), then {out['dreamer_update_ms']} ms an "
        f"update ({RL2_TIMED} timed after a warm-up); the runner on the card "
        f"{out['dreamer_env_step_ms']} ms an env step of {RL2_DREAM_B} envs")
    del ref
    # CQL at its defaults
    rng = np.random.default_rng(RL2_SEED)
    n = RL2_CQL_BATCH
    cbatch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
              "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
              "rewards": rng.standard_normal(n).astype(np.float32),
              "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
              "dones": (rng.random(n) < 0.1).astype(np.float32)}
    cql = CQL(3, 1, seed=RL2_SEED, device="cuda")
    cref = CQL(3, 1, seed=RL2_SEED, device="cpu")
    for k in ("params", "target_q"):
        copy_into(cref.state[k], host_copy(cql.state[k]))
    draws = {k: v.cpu().numpy() for k, v in cql.draws(n).items()}
    stats = cql.train_on_batch(cbatch, draws=draws)
    want = cref.train_on_batch(cbatch, draws=draws)
    held = rl2_hold_update(
        "(a) CQL", stats, want, (cql.state["params"], cql.state["target_q"]),
        (cref.state["params"], cref.state["target_q"]), (3e-4, 3e-4))
    out["cql_update_ms"] = time_ms(lambda: cql.train_on_batch(cbatch),
                                     RL2_TIMED)
    log(f"phase 25 (a) CQL at its defaults, obs 3, act 1, batch {n}: stats "
        f"{json.dumps(stats)}; the CPU's {json.dumps(want)}; parameters "
        f"{json.dumps(held)}; {out['cql_update_ms']} ms an update "
        f"({RL2_TIMED} timed after a warm-up)")
    # BC and MARWIL: one epoch over the runner's logged rows
    ro = runner.sample(weights, RL2_ROW_STEPS)
    rows = list(episodes_to_rows(ro))
    ds = data.from_items(rows)
    for cls, kw in ((BC, {}), (MARWIL, {"beta": 2.0})):
        learner = cls(64, 3, seed=RL2_SEED, device="cuda", **kw)
        lref = cls(64, 3, seed=RL2_SEED, device="cpu", **kw)
        copy_into(lref.params, host_copy(learner.params))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = learner.train_on_dataset(ds, batch_size=RL2_OFFLINE_BATCH)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        want = lref.train_on_dataset(ds, batch_size=RL2_OFFLINE_BATCH)
        lr = 1e-3 * learner.iteration  # Adam steps of at most lr each
        held = rl2_hold_update(f"(a) {cls.__name__}", stats, want,
                               (learner.params,), (lref.params,), (lr,))
        name = cls.__name__.lower()
        out[f"{name}_epoch_s"] = epoch_s
        out[f"{name}_update_ms"] = epoch_s * 1e3 / learner.iteration
        log(f"phase 25 (a) {cls.__name__}: one epoch over {len(rows)} rows "
            f"({learner.iteration} updates of {RL2_OFFLINE_BATCH}) in "
            f"{epoch_s} s, data included; stats {json.dumps(stats)}; the "
            f"CPU's {json.dumps(want)}; parameters {json.dumps(held)}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del dream, cql, runner
    return out


def _card_apps():
    """nvidia-smi's rows of the processes on the card: pid, used memory."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except OSError:
        return ["not measured"]


def _same_tree(a, b):
    from ray_tpu_torch.ops.quant import tree_leaves

    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _opt_tensors(opt_state):
    return [v for s in opt_state["state"].values() for v in s.values()]


def rl2_off_policy(ray_tpu_torch, name, algo, updates_per_iter):
    """Phase 25 (b) or (c): two iterations of ``algo`` (its learner on
    the card, its runners on the CPU), the leases, the stats, the state's
    round trip, ms an update through the learner actor and ms an env step
    of a CPU runner. Stops ``algo``."""
    try:
        t0 = time.perf_counter()
        outs = [algo.train() for _ in range(2)]
        train_s = time.perf_counter() - t0
        learner_row, *runner_rows = _rl_rows(
            [algo.learner] + algo.env_runner_group.runners)
        apps = _card_apps()
        state = algo.get_state()
        algo.train()
        changed = algo.get_state()
        algo.set_state(state)
        back = algo.get_state()
        mb = ray_tpu_torch.get(algo.replay.sample.remote(
            algo.config.train_batch_size))
        mb.pop("_indices")
        ray_tpu_torch.get(algo.learner.train_on.remote(mb))
        t0 = time.perf_counter()
        ray_tpu_torch.get([algo.learner.train_on.remote(mb)
                           for _ in range(RL2_BURST)])
        update_ms = (time.perf_counter() - t0) * 1e3 / RL2_BURST
        w = algo.learner.get_weights.remote()
        runner = algo.env_runner_group.runners[0]
        args = (w, 32, 0.05) if name == "DQN" else (w, 32, False)
        ray_tpu_torch.get(runner.sample_transitions.remote(*args))
        t0 = time.perf_counter()
        ray_tpu_torch.get(runner.sample_transitions.remote(*args))
        env_ms = (time.perf_counter() - t0) * 1e3 / 32
    finally:
        algo.stop()
    stats = outs[-1]["learner"]
    if learner_row["gpu_ids"] != ["0"] or any(r["gpu_ids"]
                                              for r in runner_rows):
        raise AssertionError(f"phase 25 {name}: leases {learner_row}, "
                             f"{runner_rows}")
    if not stats or not all(math.isfinite(v) for v in stats.values()):
        raise AssertionError(f"phase 25 {name}: stats {stats}")
    if state["learner"]["updates_done"] < 2 * updates_per_iter:
        raise AssertionError(f"phase 25 {name}: "
                             f"{state['learner']['updates_done']} updates")
    if name == "DQN":
        cur, new, later = state["learner"], back["learner"], changed["learner"]
        trees, opts = ("params", "target_params"), ("opt_state",)
        if not _same_tree(cur["target_params"], cur["params"]):
            raise AssertionError("phase 25 (b) DQN: the target is not the "
                                 "online network right after a sync")
    else:
        cur, new, later = (s["learner"]["state"]
                           for s in (state, back, changed))
        trees = ("params", "target_q", "log_alpha")
        opts = ("actor_opt", "critic_opt", "alpha_opt")
        if not stats["alpha"] != 1.0:
            raise AssertionError(f"phase 25 (c) SAC: alpha {stats['alpha']}")
    if _same_tree(later["params"], cur["params"]):
        raise AssertionError(f"phase 25 {name}: a third iteration changed "
                             f"nothing")
    if not (all(_same_tree(new[t], cur[t]) for t in trees)
            and all(_same_tree(_opt_tensors(new[o]), _opt_tensors(cur[o]))
                    for o in opts)):
        raise AssertionError(f"phase 25 {name}: get_state/set_state did not "
                             f"round-trip bit for bit")
    out = {"train_s": train_s, "update_ms": update_ms, "env_step_ms": env_ms,
           "updates": state["learner"]["updates_done"], "card_apps": apps}
    log(f"phase 25 {name}: 2 iterations in {train_s} s, "
        f"{out['updates']} updates; stats {json.dumps(stats)}; learner on "
        f"{learner_row['gpu_ids']}, runners on "
        f"{[r['gpu_ids'] for r in runner_rows]}; the state round-tripped bit "
        f"for bit; {update_ms} ms an update through the learner actor "
        f"({RL2_BURST} calls queued), {env_ms} ms an env step of 4 envs on a "
        f"CPU runner; processes on the card (pid, memory) {apps}")
    return out


def rl2_static_checks():
    """Phase 25 (e): ``check`` over ray_tpu_torch/rl against the port's
    baseline, and a decoration-time warning in a process of its own."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    check = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "check", "ray_tpu_torch/rl",
         "--baseline", "ray_tpu_torch/raylint_baseline.json", "--format",
         "json"], cwd=repo, env=env, capture_output=True, text=True,
        timeout=300)
    check_s = time.perf_counter() - t0
    if check.returncode != 0 or json.loads(check.stdout)["findings"]:
        raise AssertionError(f"phase 25 (e): check exited "
                             f"{check.returncode}:\n{check.stdout[-2000:]}"
                             f"\n{check.stderr[-2000:]}")
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "deco.py")
        with open(script, "w") as f:
            f.write("import ray_tpu_torch\n\n\n@ray_tpu_torch.remote\n"
                    "def gather(f, xs):\n    out = []\n    for x in xs:\n"
                    "        out.append(ray_tpu_torch.get(f.remote(x)))\n"
                    "    return out\n")
        deco = subprocess.run(
            [sys.executable, script], cwd=tmp, capture_output=True,
            text=True, timeout=120,
            env=dict(env, RAY_TPU_TORCH_STATIC_CHECKS="1"))
    if deco.returncode != 0 or not ("StaticCheckWarning" in deco.stderr
                                    and "RTL002" in deco.stderr):
        raise AssertionError(f"phase 25 (e): the decoration's process said "
                             f"{deco.stderr[-2000:]!r}")
    warning = next(line for line in deco.stderr.splitlines()
                   if "RTL002" in line)
    log(f"phase 25 (e): `check ray_tpu_torch/rl` against the port's baseline "
        f"exited 0 with no findings in {check_s} s; RAY_TPU_TORCH_STATIC_"
        f"CHECKS=1 at decoration warned: {warning.strip()[:200]}")
    return {"check_s": check_s}


def rl_second_half(attention):
    """Phase 25 on phase 24's cluster: (a) in this process, (b) DQN, (c)
    SAC, (d) DreamerV3Algo, (e) the static checks; the attention kernels'
    counters held unmoved through it."""
    import ray_tpu_torch
    from ray_tpu_torch.rl import DQNConfig, DreamerV3Algo, SACConfig

    t_phase = time.perf_counter()
    before = _counts(attention)
    # Each learner leases the whole card, so (b) and (c) run one after
    # the other; each is built a part ahead, so that its learner's process
    # starts (its CUDA context) while the part before runs.
    dqn = (DQNConfig()
           .environment("catch8", env_fn=lambda: FlatCatch(8))
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=32)
           .learners(use_gpu=True)
           .training(prioritized_replay=True, learning_starts=64,
                     target_network_update_freq=RL2_DQN_SYNC,
                     num_updates_per_iter=RL2_DQN_UPDATES)
           .debugging(seed=RL2_SEED)).build()
    t0 = time.perf_counter()
    out = {"a": rl2_in_process()}
    log(f"phase 25: (b) built in {t0 - t_phase} s; (a) in "
        f"{time.perf_counter() - t0} s")
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = rl2_off_policy(ray_tpu_torch, "DQN", dqn, RL2_DQN_UPDATES)
    _replicas_gone(ray_tpu_torch, what="phase 25 (b)")
    sac = (SACConfig()
           .environment("pendulum", env_fn=NumpyPendulum)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
           .learners(use_gpu=True)
           .training(learning_starts=256)
           .debugging(seed=RL2_SEED)).build()
    # (d) DreamerV3Algo: its learner here on the card, one CPU runner
    t0 = time.perf_counter()
    algo = DreamerV3Algo(env_fn=lambda: FlatCatch(8), num_env_runners=1,
                         num_envs_per_runner=8, updates_per_iter=1,
                         seed=RL2_SEED)
    try:
        steps = [algo.training_step() for _ in range(2)]
        returns = algo.episode_stats()
    finally:
        algo.stop()
    if algo.learner.iteration < 1 or not returns or not all(
            math.isfinite(r) for r in returns):
        raise AssertionError(f"phase 25 (d): {algo.learner.iteration} "
                             f"updates, returns {returns}")
    out["d"] = {"s": time.perf_counter() - t0,
                "updates": algo.learner.iteration}
    log(f"phase 25 (d) DreamerV3Algo: 2 iterations, {algo.learner.iteration} "
        f"updates on the card, stats {json.dumps(steps[-1]['learner'])}, "
        f"{len(returns)} episodes (mean return {sum(returns) / len(returns)})"
        f" in {out['d']['s']} s")
    # (e)'s processes run while (c) trains
    with ThreadPoolExecutor(1) as pool:
        checks = pool.submit(rl2_static_checks)
        out["c"] = rl2_off_policy(ray_tpu_torch, "SAC", sac,
                                  sac.config.num_updates_per_iter)
        out["e"] = checks.result()
    _replicas_gone(ray_tpu_torch, what="phase 25 (c)")
    after = _counts(attention)
    if after != before:
        raise AssertionError(f"phase 25: the attention counters moved, "
                             f"{before} -> {after}")
    out["phase_s"] = time.perf_counter() - t_phase
    a = out["a"]
    log(f"phase 25: ms an update: DreamerV3 {a['dreamer_update_ms']}, CQL "
        f"{a['cql_update_ms']}, BC {a['bc_update_ms']}, MARWIL "
        f"{a['marwil_update_ms']} (in this process), DQN "
        f"{out['b']['update_ms']}, SAC {out['c']['update_ms']} (through the "
        f"learner actor); peak memory in this process {a['peak_gib']} GiB; "
        f"ms an env step of a CPU runner: DQN {out['b']['env_step_ms']}, SAC "
        f"{out['c']['env_step_ms']}; attention counters unmoved {after}; "
        f"phase 25 done in {out['phase_s']} s")
    return out


def rl_phase(attention):
    """Phase 24: ray_tpu_torch.init(num_cpus=8, num_gpus=1) first, so that
    its worker template imports torch while (a) runs in this process;
    then (b) and (c) on that cluster, and phase 25 on it too; shut down at
    the end, failures included."""
    import tempfile

    import ray_tpu_torch

    t0 = time.perf_counter()
    rows = rl_kernel_rows(attention)
    gc.collect()
    torch.cuda.empty_cache()
    os.environ.setdefault("RAY_TPU_TORCH_TMPDIR",
                          tempfile.mkdtemp(prefix="rtt"))
    t1 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=8, num_gpus=1, object_store_memory=8 << 30)
    try:
        log(f"phase 24: cluster up in {time.perf_counter() - t1} s")
        card = rl_on_card(attention)
        gc.collect()
        torch.cuda.empty_cache()
        cluster = rl_cluster()
        log(f"phase 24 done in {time.perf_counter() - t0} s")
        # Phase 25: rl/'s second half, on this cluster
        gc.collect()
        torch.cuda.empty_cache()
        second = rl_second_half(attention)
    except BaseException:
        log(_session_log_tails())
        raise
    finally:
        ray_tpu_torch.shutdown()
    return {"rows": rows, **card, **cluster, "phase25": second}


# Phase 26: LLAMA3_8B's four pp stages at full geometry, one after another
# on this card, from phase 1's bf16 weights (before they are freed), held
# to the unsplit loss, the chained forward and stage_hbm_budget's model.
CERT_STAGES = 4
CERT_TOKENS = (1, 8192)
CERT_SEED = 26
CERT_CHUNK = 16384
CERT_EXTRA_STEPS = 2
# The last stage's loss against the unsplit loss_fn on the same weights:
# both bf16 through the same layers and the chunked loss, the stage step's
# forward through the kernel with lse and remat, the unsplit one under
# no_grad; a few bf16 steps of a loss near 12 at most.
CERT_LOSS_RTOL = 2e-3
# A stage step's output against the chained forward under no_grad: the
# same weights and inputs (bits expected), held max-relative.
CERT_ACT_RTOL = 1e-2


def _hold_counts(attention, want, dense_routes, what):
    """The counters since the last ``_rl_reset`` against ``want`` (0 where
    it names none), ``dense_routes`` unmoved from its value before."""
    got = _rl_counts(attention)
    want = {**{c: want.get(c, 0) for c in COUNTERS},
            "dense_routes": dense_routes}
    if got != want:
        raise AssertionError(f"phase 26 {what}: launches {got}, expected "
                             f"{want}")
    return got


def k2_8b_row(attention):
    """Phase 26 (g): K2 at one 8B stage layer's call, [1, 8192, 32/8, 128]
    causal bf16: the forward with lse and the whole backward held to their
    plain versions (each timed by CUDA events around its one call), then
    each call's device time (device_ms) beside sdpa's forward and
    backward, and the bounds."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(CERT_SEED)
    B, L, H, Hkv, D = 1, CERT_TOKENS[1], 32, 8, 128
    q = torch.randn(B, L, H, D, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(B, L, Hkv, D, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    do = torch.randn(B, L, H, D, generator=gen, device="cuda").bfloat16()
    where = f"phase 26 (g) B={B} L={L} H={H}/{Hkv} D={D} causal"

    def events(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    o, lse = attention.flash_attention_fwd(q, k, v, True)
    (want_o, want_lse), fwd_plain_ms = events(
        lambda: attention.flash_attention_plain(q, k, v, causal=True,
                                                return_lse=True))
    fwd_err, _ = hold(o, want_o, BF16_ATOL, BF16_RTOL, f"{where} o")
    hold(lse, want_lse, LSE_TOL, 0.0, f"{where} lse")
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, True)
    want, bwd_plain_ms = events(lambda: attention.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True))
    bwd_err = max(hold_grad(g, w, BF16_GRAD_RULE, f"{where} d{n}")[0]
                  for n, g, w in zip("qkv", got, want))
    del want_o, want_lse, want
    fwd_bound, fwd_by = attention_bound(B, L, H, Hkv, D, True)
    (bwd_bound, bwd_by), _, _ = bwd_bounds(B, L, H, Hkv, D, True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        fwd_lib = device_ms(sdpa, 10, fwd_bound)
    graph = sdpa()
    bwd_lib = device_ms(lambda: torch.autograd.grad(
        graph, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 5,
        bwd_bound)
    del graph
    row = {"shape": f"B={B} L={L} H={H}/{Hkv} D={D} causal bf16",
           "fwd_ms": device_ms(lambda: attention.flash_attention_fwd(
               q, k, v, True), 10, fwd_bound),
           "fwd_plain_ms": fwd_plain_ms, "fwd_bound_ms": fwd_bound,
           "fwd_bound_by": fwd_by, "fwd_library_ms": fwd_lib,
           "fwd_max_abs_err": fwd_err,
           "bwd_ms": device_ms(lambda: attention.flash_attention_bwd(
               q, k, v, o, lse, do, True), 5, bwd_bound),
           "bwd_plain_ms": bwd_plain_ms, "bwd_bound_ms": bwd_bound,
           "bwd_bound_by": bwd_by, "bwd_library_ms": bwd_lib,
           "bwd_max_abs_err": bwd_err,
           "timing": "device_ms: CUDA events around calls queued behind a "
                     "spin kernel; plain: CUDA events around its one call"}
    log(f"phase 26 (g) K2 at the 8B stage shape: {json.dumps(row)}")
    return row


def certificate_phase(models, attention, params, cfg):
    """Phase 26 (see the module docstring): LLAMA3_8B's CERT_STAGES
    pipeline stages at full geometry, one after another on this card,
    from phase 1's bf16 ``params``. Returns the counts, the stages' peaks,
    budgets and ms, the losses and K2's row at the stage's shape."""
    from ray_tpu_torch.parallel import dryrun
    from ray_tpu_torch.parallel import mpmd_pipeline as mpmd

    t_phase = time.perf_counter()
    card, card_gib = dryrun.card_memory(0)
    gen = torch.Generator(device="cuda").manual_seed(CERT_SEED)
    tokens = torch.randint(0, cfg.vocab_size, CERT_TOKENS, generator=gen,
                           device="cuda")
    targets = models.next_token_targets(tokens)
    n_layers = mpmd.stage_layer_counts(cfg.n_layers, CERT_STAGES)
    stages = mpmd.split_llama_params(params, CERT_STAGES)
    counts, dense = {}, attention.dense_routes

    # ---- phase 26's main path: counts reset just before each part, read
    # just after
    _rl_reset(attention)
    with torch.no_grad():                                           # (a)
        ref = float(models.loss_fn(params, {"tokens": tokens}, cfg,
                                   remat=True, chunked_vocab=CERT_CHUNK))
        counts["unsplit_forward"] = _hold_counts(
            attention, {"launches": cfg.n_layers}, dense, "(a) unsplit loss")
        _rl_reset(attention)
        acts = [mpmd.stage_forward(stages[0], tokens, cfg, first=True)]
        for i in range(1, CERT_STAGES - 1):
            acts.append(mpmd.stage_forward(stages[i], acts[-1], cfg,
                                           first=False))
        counts["boundary_forwards"] = _hold_counts(
            attention, {"launches": sum(n_layers[:-1])}, dense,
            "(b) chained forwards")
    if not math.isfinite(ref):
        raise AssertionError(f"phase 26 (a): unsplit loss {ref}")
    log(f"phase 26 (a): unsplit loss_fn (remat, chunked vocab "
        f"{CERT_CHUNK}) on [1, {CERT_TOKENS[1]}] tokens, seed {CERT_SEED}: "
        f"{ref}")

    rows, g_next, losses = [], None, []
    for i in reversed(range(CERT_STAGES)):                          # (b)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        p = _tree_map(lambda t: t.detach().clone(), stages[i])
        make_opt, step_fn, kind = mpmd.build_stage_step(
            cfg, i, CERT_STAGES, lr=LR, chunked_vocab=CERT_CHUNK)
        opt = make_opt(p)
        first = tokens if i == 0 else acts[i - 1]
        second = targets if kind == "last" else g_next
        per_step = {"launches": 2 * n_layers[i],
                    "bwd_launches": n_layers[i]}
        step_ms = []
        steps = 1 + (CERT_EXTRA_STEPS if kind == "last" else 0)
        for s in range(steps):
            _rl_reset(attention)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(p, opt, first, second)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            counts[f"stage_{i}_step_{s + 1}"] = _hold_counts(
                attention, per_step, dense, f"(e) stage {i} step {s + 1}")
            if kind == "last":
                loss, g = out
                losses.append(float(loss))
                if s == 0:
                    g_next = g
            else:
                o, g = out if kind == "mid" else (out, None)
                gap = float((o.float() - acts[i].float()).abs().max()
                            / acts[i].float().abs().max())
                if not gap <= CERT_ACT_RTOL:
                    raise AssertionError(
                        f"phase 26 (b) stage {i}: output {gap} of the "
                        f"chained forward's largest, over {CERT_ACT_RTOL}")
                same_bits = torch.equal(o, acts[i])
                g_next = g
            for name, t in (("output", out[0] if kind != "first" else out),
                            ("g_act", g)):
                if t is not None and not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"phase 26 (b) stage {i}: "
                                         f"non-finite {name}")
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        budget = mpmd.stage_hbm_budget(
            cfg, CERT_STAGES, i, devices_per_stage=1, batch_per_chip=1,
            seq=CERT_TOKENS[1], n_microbatches=1, chunk_v=CERT_CHUNK,
            hbm_gib_per_chip=card_gib)
        row = {"stage": i, "kind": kind, "layers": n_layers[i],
               "params": mpmd.stage_param_count(cfg, CERT_STAGES, i),
               "peak_gib": peak,
               "budget_gib": budget["worst_case_gib_per_chip"],
               "peak_over_budget": peak / budget["worst_case_gib_per_chip"],
               "step_ms": step_ms,
               "ms": (sum(step_ms[1:]) / (steps - 1) if steps > 1
                      else step_ms[0]),
               "moments": [str(opt.mu[0].dtype), str(opt.nu[0].dtype)]}
        if kind != "last":
            row["same_bits_as_chained_forward"] = same_bits
            row["output_gap"] = gap
        log(f"phase 26 (b)-(d) stage {i} ({kind}): {json.dumps(row)}")
        if not peak <= budget["worst_case_gib_per_chip"]:               # (c)
            raise AssertionError(
                f"phase 26 (c) stage {i}: peak {peak} GiB over "
                f"stage_hbm_budget's worst case "
                f"{budget['worst_case_gib_per_chip']} GiB")
        rows.append(row)
        if kind == "last" and abs(losses[0] - ref) > CERT_LOSS_RTOL * ref:
            raise AssertionError(f"phase 26 (b): the last stage's loss "
                                 f"{losses[0]}, the unsplit {ref}")
        del p, opt, out, first, second
        gc.collect()
        torch.cuda.empty_cache()
    # ---- end of phase 26's main path
    if not all(b < a for a, b in zip(losses, losses[1:])):          # (d)
        raise AssertionError(f"phase 26 (d): the last stage's losses "
                             f"{losses} do not fall")
    del acts, g_next
    log(f"phase 26 (b): the last stage's loss {losses[0]} against the "
        f"unsplit {ref} (rel {abs(losses[0] - ref) / ref}); its losses "
        f"over {len(losses)} steps {losses}")
    # (f): the two 8B certificate lines for this card come from phase 12
    # (d)'s dryrun, whose tracing runs beside that phase's ranks
    torch.cuda.empty_cache()
    k2 = k2_8b_row(attention)                                        # (g)
    out = {"counts": counts, "stages": rows[::-1], "ref_loss": ref,
           "losses": losses, "k2": k2,
           "launches": sum(c["launches"] for c in counts.values()),
           "bwd_launches": sum(c["bwd_launches"] for c in counts.values()),
           "step_launches": sum(c["launches"] for k, c in counts.items()
                                if k.startswith("stage_")),
           "phase_s": time.perf_counter() - t_phase}
    log(f"phase 26 done in {out['phase_s']} s: peaks "
        f"{[r['peak_gib'] for r in out['stages']]} GiB against budgets "
        f"{[r['budget_gib'] for r in out['stages']]} ({card}, "
        f"{card_gib} GiB); ms a stage step {[r['ms'] for r in out['stages']]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from ray_tpu_torch import models, parallel
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve import LLMServer
    from ray_tpu_torch.util import events

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}"
        f"; devices {torch.cuda.device_count()}")
    t_start = t0 = time.perf_counter()
    with ThreadPoolExecutor(len(attention.KERNELS)) as pool:  # one nvcc each
        libs = list(pool.map(attention.build, attention.KERNELS))
    log(f"build: {[lib.name for lib in libs]} in {time.perf_counter() - t0}"
        f" s, in parallel")
    compiled = kernel_report(libs)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = check_kernel(attention, gen)
    check_small_model(models, gen)
    check_small_paged_and_spec(models, gen)
    check_debug_routes(models, parallel, attention, gen)

    cfg = models.LLAMA3_8B
    t0 = time.perf_counter()
    params = models.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"init LLAMA3_8B: {cfg.param_count()} params in "
        f"{time.perf_counter() - t0} s, "
        f"{torch.cuda.memory_allocated() / 2**30} GiB allocated")
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    prompt_gen = torch.Generator().manual_seed(1)
    plens, news = [5, 40, 200, 600, 12, 100], [32, 24, 16, 16, 32, 20]
    requests = [{"prompt": torch.randint(0, cfg.vocab_size, (n,),
                                         generator=prompt_gen).tolist(),
                 "max_new_tokens": m} for n, m in zip(plens, news)]
    requests[4]["stream"] = True
    server = LLMServer(lambda: (params, cfg), max_slots=4, max_len=1024)

    # ---- the main path: counts reset just before, read just after
    attention.launches = 0
    events.reset()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = models.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    t0 = time.perf_counter()
    outs, _ = asyncio.run(serve_requests(server, requests))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = attention.launches
    # ---- end of the main path

    if logits.shape != (1, 1024, cfg.vocab_size) or not finite:
        raise AssertionError(f"forward logits {tuple(logits.shape)}, "
                             f"finite={finite}")
    log(f"forward LLAMA3_8B [1, 1024], first call: {fwd_s} s, logits "
        f"finite")
    for body, toks in zip(requests, outs):
        if len(toks) != body["max_new_tokens"] or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"bad response {toks} for prompt of "
                                 f"{len(body['prompt'])}")
    rows_ev, _ = events.drain()
    ttft = [r[5] for r in rows_ev if r[1] == "serve.req.first_token"]
    n_tok = sum(len(t) for t in outs)
    prefills = server.engine.prefills
    log(f"serve LLAMA3_8B: {len(requests)} requests (prompts {plens}, one "
        f"streamed), {n_tok} tokens in {serve_s} s = "
        f"{n_tok / serve_s} tokens/s; TTFT s = "
        f"{ttft}; prefills {prefills}")
    expected = cfg.n_layers * (1 + prefills)
    if prefills != len(requests) or launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times on "
                             f"the main path, expected {expected}")
    log(f"main path: flash_fwd launches {launches} == {cfg.n_layers} x "
        f"(1 forward + {prefills} prefills)")

    paged_server, slice_launches = serve_paged_and_speculative(
        models, attention, params, cfg, requests, outs)
    where_time_goes(models, params, cfg, server, tokens, paged_server)
    serve_launches = launches
    del server, logits, outs, paged_server
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 26: the 8B's four pp stages trained on phase 1's weights, the
    # servers freed first, then the weights.
    cert = certificate_phase(models, attention, params, cfg)
    log(f"phase 26 done at {time.perf_counter() - t_start} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serving phases done at {time.perf_counter() - t_start} s; "
        f"{torch.cuda.memory_allocated() / 2**30} GiB still allocated")

    # Phase 13: Mixtral serving at its full widths, then the small fp32
    # Mixtral against the CPU.
    mixtral_serve = serve_mixtral(models, attention)
    check_small_mixtral(models, attention, gen)
    log(f"phase 13 done at {time.perf_counter() - t_start} s")

    bwd_rows = check_bwd(attention, gen)
    check_small_training(models, gen)

    cfg = models.LLAMA3_1B
    tokens = torch.randint(0, cfg.vocab_size, TRAIN_TOKENS, generator=gen,
                           device="cuda")
    log(f"LLAMA3_1B: {cfg.param_count()} params, d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
    # remat runs each forward twice
    dense = train_run(models, attention, cfg, tokens, seed=7, warm=1,
                      timed=5, remat=False, chunked=0,
                      expect={"launches": cfg.n_layers * 6,
                              "bwd_launches": cfg.n_layers * 6},
                      name="LLAMA3_1B remat=False chunked_vocab=0",
                      groups=llama_group_sq)
    remat = train_run(models, attention, cfg, tokens, seed=7, warm=1,
                      timed=2, remat=True, chunked=16384,
                      expect={"launches": cfg.n_layers * 6,
                              "bwd_launches": cfg.n_layers * 3},
                      name="LLAMA3_1B remat=True chunked_vocab=16384")
    # Both runs start from the same weights: the first losses differ only
    # by where the logits are rounded to bf16 (the dense head's output
    # against the chunked loss's fp32 products), a few bf16 steps (2**-8)
    # of the loss at most.
    first = (dense["losses"][0], remat["losses"][0])
    if not abs(first[1] - first[0]) <= 1e-2 * abs(first[0]):
        raise AssertionError(f"first losses differ: dense {first[0]}, "
                             f"remat + chunked {first[1]}")
    log(f"first loss: dense {first[0]}, remat + chunked {first[1]}")
    log(f"phase 8 dense: each layer's first gradient norm and the other "
        f"groups' {json.dumps(stage_norms(dense['group_sq'], cfg.n_layers))}")

    # Phase 16: the same weights and tokens pipelined over pp = 4, the
    # stages in lockstep on this card.
    lockstep = pipeline_phase(models, parallel, attention, cfg, tokens,
                              dense)
    log(f"phase 16 done at {time.perf_counter() - t_start} s")

    stats_rows = check_stats(attention, gen)
    check_small_sp(models, parallel, attention, gen)

    # Phase 11: sequence-parallel training, LLAMA3_1B on phase 8's 8192
    # tokens as one [1, 8192] sequence, sp = 4 ranks in lockstep on this
    # card; the ring's stats kernel runs n_layers x sp^2 times a forward.
    train_tokens, tokens = tokens, tokens.reshape(1, -1)
    mesh = parallel.make_mesh(parallel.MeshSpec(sp=4), device="cuda")
    n = mesh.shape["sp"]
    ring = train_run(models, attention, cfg, tokens, seed=7, warm=1,
                     timed=3, remat=False, chunked=0,
                     expect={"stats_launches": cfg.n_layers * n * n * 4},
                     name="LLAMA3_1B sp=4 ring (flash)",
                     attn_impl=parallel.make_ring_attention(
                         mesh, block_impl="flash"))
    k2 = train_run(models, attention, cfg, tokens, seed=7, warm=1, timed=2,
                   remat=False, chunked=0,
                   expect={"launches": cfg.n_layers * 3,
                           "bwd_launches": cfg.n_layers * 3},
                   name="LLAMA3_1B flash_attention")
    uly = train_run(models, attention, cfg, tokens, seed=7, warm=1, timed=2,
                    remat=False, chunked=0,
                    expect={"launches": cfg.n_layers * n * 3,
                            "bwd_launches": cfg.n_layers * n * 3},
                    name="LLAMA3_1B sp=4 Ulysses",
                    attn_impl=parallel.make_ulysses_attention(mesh))
    # The same weights and tokens: the first losses differ only by the
    # attention's order of sums and where it rounds to bf16, a few bf16
    # steps of the attention's output, far below 1e-3 of a loss near 12.
    first = {"ring": ring["losses"][0], "flash_attention": k2["losses"][0],
             "ulysses": uly["losses"][0]}
    if not all(abs(x - first["ring"]) <= 1e-3 * abs(first["ring"])
               for x in first.values()):
        raise AssertionError(f"first losses differ: {first}")
    log(f"first loss [1, 8192]: {first}")
    ring_layer_times(attention, parallel, gen)

    # Phase 14: Mixtral training on the one card; its weights and tokens
    # are phase 12 (e)'s too.
    moe_tokens = torch.randint(0, models.MIXTRAL_8X7B.vocab_size, (4, 2048),
                               generator=gen, device="cuda")
    mixtral_train = train_mixtral(models, parallel, attention, moe_tokens)
    log(f"phase 14 done at {time.perf_counter() - t_start} s")

    # Phase 15: ViT-B/16 training and inference; phase 12 (h) holds its
    # sharded step to it.
    t0 = time.perf_counter()
    vit_train, vit_forward_launches, vit_forward_ms = train_vit(models,
                                                                attention)
    log(f"phase 15 done in {time.perf_counter() - t0} s, at "
        f"{time.perf_counter() - t_start} s")

    t0 = time.perf_counter()
    sharded, small = sharded_training(models, parallel, attention,
                                      train_tokens, {"dense": (dense, 6),
                                                     "remat": (remat, 3)},
                                      moe_tokens, mixtral_train, vit_train)
    log(f"phase 12 done in {time.perf_counter() - t0} s, at "
        f"{time.perf_counter() - t_start} s")

    # Phase 17: the runtime's trainer, in worker actors pinned to the card.
    gc.collect()
    torch.cuda.empty_cache()
    runtime = runtime_training(train_tokens, dense)["a"]

    # Phase 18: the Serve runtime, replicas pinned to the card.
    gc.collect()
    torch.cuda.empty_cache()
    serving = serve_runtime(models, requests)

    # Phase 19: the data ingest path into the trainer's workers.
    gc.collect()
    torch.cuda.empty_cache()
    ingest = data_ingest(models)["a"]

    # Phase 20: the MPMD pipeline, two stage actors sharing the card.
    gc.collect()
    torch.cuda.empty_cache()
    mpmd_run = mpmd_training(models, train_tokens, dense, lockstep)["a"]

    # Phase 21: Tune and workflow, their trials and steps sharing the card.
    gc.collect()
    torch.cuda.empty_cache()
    tuned = tune_and_workflow(train_tokens, remat, vit_train)

    # Phase 22: runtime_env, jobs, the dashboard and the CLI.
    gc.collect()
    torch.cuda.empty_cache()
    job_run = runtime_env_jobs(train_tokens, dense)

    # Phase 23: the autoscaler starts an H100 node for a ray:// driver's
    # ActorPool and a C++ caller, and terminates it once they are gone.
    gc.collect()
    torch.cuda.empty_cache()
    pool_run = autoscaled_pool(models)

    # Phase 24: rl/'s learner stack on the card, the Podracer and PPO;
    # phase 25: DQN, SAC, CQL, BC/MARWIL, DreamerV3 and the static checks.
    gc.collect()
    torch.cuda.empty_cache()
    rl_run = rl_phase(attention)
    rl_fwd = {"phase24_learner": rl_run["launches"]["launches"],
              "phase24_runner": rl_run["runner_launches"]["launches"]}
    rl_bwd = {"phase24_learner": rl_run["launches"]["bwd_launches"]}

    def sharded_launches(counter):
        """Phase 12's launches of a counter: per rank by run, and in all."""
        by_run = {f"phase 12 {name}, per rank": [g[counter] for g in got]
                  for name, got in list(sharded.items()) + list(small.items())
                  if any(g[counter] for g in got)}
        return by_run, sum(g[counter] for got in sharded.values()
                           for g in got)

    main = next(r for r in rows if r["L"] == 1024)
    train = bwd_rows[0]
    train_shape = "B=4 L=2048 H=32 Hkv=8 D=64 causal bf16"
    pipe_launches = {f"phase 16 {name}": {c: run[c] for c in COUNTERS}
                     for name, run in lockstep.items()}
    bwd_launches = (dense["bwd_launches"] + remat["bwd_launches"]
                    + sum(r["bwd_launches"] for r in pipe_launches.values())
                    + k2["bwd_launches"] + uly["bwd_launches"]
                    + mixtral_train["bwd_launches"]
                    + vit_train["bwd_launches"] + runtime["bwd_launches"]
                    + ingest["bwd_launches"] + mpmd_run["bwd_launches"]
                    + sum(v["bwd_launches"] for v in tuned.values())
                    + job_run["bwd_launches"]
                    + sum(rl_bwd.values()) + cert["bwd_launches"]
                    + sharded_launches("bwd_launches")[1])
    mosaic = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:109",
        "also_replaces": "ray_tpu/ops/attention.py:231 (forward)",
        "launches": serve_launches + sum(slice_launches.values())
        + dense["launches"] + remat["launches"] + k2["launches"]
        + sum(r["launches"] for r in pipe_launches.values())
        + uly["launches"] + mixtral_serve["launches"]
        + mixtral_train["launches"] + vit_train["launches"]
        + vit_forward_launches + runtime["launches"]
        + ingest["launches"] + serving["launches"] + mpmd_run["launches"]
        + sum(v["launches"] for v in tuned.values())
        + job_run["launches"] + pool_run["launches"]
        + sum(rl_fwd.values()) + cert["launches"]
        + sharded_launches("launches")[1],
        "launches_by_path": {"serve": serve_launches, **slice_launches,
                             "train_dense": dense["launches"],
                             "train_remat_chunked": remat["launches"],
                             **{k: r["launches"]
                                for k, r in pipe_launches.items()},
                             "train_8k_flash_attention": k2["launches"],
                             "train_8k_ulysses": uly["launches"],
                             "mixtral_serve": mixtral_serve["launches"],
                             "mixtral_train": mixtral_train["launches"],
                             "vit_train": vit_train["launches"],
                             "vit_forward": vit_forward_launches,
                             "runtime_train_worker": runtime["launches"],
                             "ingest_train_worker": ingest["launches"],
                             "serve_replica": serving["launches"],
                             **{f"mpmd_stage_{i}": c["launches"]
                                for i, c in
                                enumerate(mpmd_run["launches_by_stage"])},
                             **{f"phase21_{k}": v["launches"]
                                for k, v in tuned.items()},
                             "phase22_job_actor": job_run["launches"],
                             "phase23_pool_actors": pool_run["launches"],
                             **rl_fwd,
                             **{f"phase26_8b_{k}": c["launches"]
                                for k, c in cert["counts"].items()},
                             **sharded_launches("launches")[0]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "device_ms": main["device_ms"],
        "library_device_ms": main["library_device_ms"],
        "shape": "B=1 L=1024 H=32 Hkv=8 D=128 causal bf16",
        "train_shape": {"shape": train_shape + ", with lse",
                        "ms": train["fwd_ms"],
                        "plain_ms": train["fwd_plain_ms"],
                        "bound_ms": train["fwd_bound_ms"],
                        "bound_by": train["fwd_bound_by"],
                        "library_ms": train["fwd_library_ms"],
                        "device_ms": train["fwd_device_ms"],
                        "library_device_ms":
                            train["fwd_library_device_ms"]},
        "rl_shapes": {r["shape"] + (", with lse" if k == "learner"
                                    else ", with lse (the runner's call "
                                    "runs without)"): {
            "ms": r["fwd_ms"], "plain_ms": r["fwd_plain_ms"],
            "bound_ms": r["fwd_bound_ms"], "bound_by": r["fwd_bound_by"],
            "library_ms": r["fwd_library_ms"],
            "max_abs_err": r["fwd_max_abs_err"]}
            for k, r in rl_run["rows"].items()},
        "cert_8b_shape": {cert["k2"]["shape"] + ", with lse": {
            f: cert["k2"][f"fwd_{f}"] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}},
    }]
    for name, part in (("dkdv", "dK, dV"), ("dq", "dQ")):
        kernels.append({
            "name": f"flash_bwd_{name}", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "ray_tpu/ops/attention.py:231",
            "replaces_detail": (
                f"backward of _tpu_flash: Mosaic "
                + (f"_flash_attention_bwd_dkv ({mosaic}:941)"
                   if name == "dkdv" else
                   f"_flash_attention_bwd_dq ({mosaic}:1287)")),
            "launches": bwd_launches,
            "launches_by_path": {"train_dense": dense["bwd_launches"],
                                 "train_remat_chunked":
                                     remat["bwd_launches"],
                                 **{k: r["bwd_launches"]
                                    for k, r in pipe_launches.items()},
                                 "train_8k_flash_attention":
                                     k2["bwd_launches"],
                                 "train_8k_ulysses": uly["bwd_launches"],
                                 "mixtral_train":
                                     mixtral_train["bwd_launches"],
                                 "vit_train": vit_train["bwd_launches"],
                                 "runtime_train_worker":
                                     runtime["bwd_launches"],
                                 "ingest_train_worker":
                                     ingest["bwd_launches"],
                                 **{f"mpmd_stage_{i}": c["bwd_launches"]
                                    for i, c in enumerate(
                                        mpmd_run["launches_by_stage"])},
                                 **{f"phase21_{k}": v["bwd_launches"]
                                    for k, v in tuned.items()},
                                 "phase22_job_actor":
                                     job_run["bwd_launches"],
                                 **rl_bwd,
                                 **{f"phase26_8b_{k}": c["bwd_launches"]
                                    for k, c in cert["counts"].items()
                                    if c["bwd_launches"]},
                                 **sharded_launches("bwd_launches")[0]},
            "max_abs_err": max(r[g]["max_abs_err"] for r in bwd_rows
                               for g in (("dk", "dv") if name == "dkdv"
                                         else ("dq",))),
            "ms": train[f"{name}_ms"], "plain_ms": train["plain_ms"],
            "bound_ms": train[f"{name}_bound_ms"],
            "bound_by": train[f"{name}_bound_by"],
            "library_ms": train["library_ms"],
            "device_ms": train[f"{name}_ms"],
            "library_device_ms": train["library_device_ms"],
            "timing": "ms and device_ms: the kernel's device time "
                      "(torch.profiler); library: sdpa's backward",
            "computes": part,
            "plain_and_library_compute": "dQ, dK and dV",
            "backward_ms": train["bwd_ms"],
            "backward_device_ms": train["bwd_device_ms"],
            "backward_bound_ms": train["bound_ms"],
            "di_ms": train["di_ms"], "di_device_ms": train["di_device_ms"],
            "deterministic": True,
            "shapes": {f"B={r['B']} L={r['L']} H={r['H']}/{r['Hkv']} "
                       f"D={r['D']} causal={r['causal']}": {f: r[f] for f in (
                           f"{name}_ms", "bwd_ms", "bwd_device_ms",
                           "library_ms", "library_device_ms",
                           f"{name}_bound_ms")} for r in bwd_rows},
            "shape": train_shape,
            "rl_shape": {rl_run["rows"]["learner"]["shape"]: {
                "backward_ms": rl_run["rows"]["learner"]["bwd_ms"],
                "plain_ms": rl_run["rows"]["learner"]["bwd_plain_ms"],
                "bound_ms": rl_run["rows"]["learner"]["bwd_bound_ms"],
                "bound_by": rl_run["rows"]["learner"]["bwd_bound_by"],
                "library_ms": rl_run["rows"]["learner"]["bwd_library_ms"],
                "max_abs_err": rl_run["rows"]["learner"]["bwd_max_abs_err"],
                "computes": "dQ, dK and dV (both kernels)"}},
            "cert_8b_shape": {cert["k2"]["shape"]: {
                **{f: cert["k2"][f"bwd_{f}"] for f in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")},
                "computes": "dQ, dK and dV (both kernels)"}},
        })
    full = stats_rows[0]  # every key visible, at the ring shard shape
    kernels.append({
        "name": "flash_stats", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_stats.cu",
        "replaces": "ray_tpu/ops/attention.py:314",
        "replaces_detail": "_flash_stats_bhld -> _flash_stats_kernel "
                           "(kernel :261, pallas_call :328)",
        "launches": ring["stats_launches"],
        "launches_by_path": {"train_8k_sp_ring": ring["stats_launches"],
                             **sharded_launches("stats_launches")[0]},
        "max_abs_err": max(r["max_abs_err"] for r in stats_rows),
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
        "device_ms": full["device_ms"],
        "library_device_ms": full["library_device_ms"],
        "library": "torch.ops.aten._scaled_dot_product_flash_attention "
                   "(normalised o and lse) on K/V repeated to 32 heads",
        "shape": "B=1 Lq=Lk=2048 H=32 Hkv=8 D=64 bf16, every key visible",
        "patterns": {r["pattern"]: {f: r[f] for f in (
            "Lq", "Lk", "D", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")} for r in stats_rows},
    })
    for k in kernels:
        lib = k["source"].rsplit("/", 1)[1][:-3]
        k["route_detail"] = ROUTES[lib]
        k["compiled"] = {n: rec for n, rec in compiled.items()
                         if n.startswith(k["name"] + "_")}
    if not all(math.isfinite(k[f]) for k in kernels
               for f in ("ms", "plain_ms", "library_ms", "bound_ms")):
        raise AssertionError(f"non-finite timing in {kernels}")
    log(f"chip_smoke done in {time.perf_counter() - t_start} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
