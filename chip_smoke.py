#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA Hopper card.

  python3 chip_smoke.py             every phase, then the result lines
  python3 chip_smoke.py PHASE ...   bring-up: the named phases alone
                                    (after device and build), no result
  python3 chip_smoke.py --ab DIR [FAMILY ...]
                                    A/B of the kernels' times: the
                                    package of the checkout at DIR (the
                                    parent commit, unpacked) and this one
                                    in turn, parent, change, change,
                                    parent, each in a process of its own
                                    (``--time-kernels SRC`` is one turn);
                                    named kernel families (``ssd_scan_bwd``,
                                    ``lora_matmul``, ...) alone when given

Phases, each printing JSON lines:
  device      the card (``nvidia-smi`` name and power limit), TF32 off;
  build       nvcc builds every kernel under ``src/repro_torch/csrc``,
              one process per source, all started together;
  kernel      paged_decode_attention against its plain PyTorch version,
              float32 and bfloat16, at the serving shape and ten more
              (long context, GQA, pool blocks of 128 and 256 rows, the
              serve tick after 2,048-token prompts paged in blocks of 16
              and contiguous as identity-table blocks of 32, identity-
              table blocks of 1, 2 and 8 rows, and tables that alias the
              same 48 prefix blocks, as the prefix cache makes them;
              hymba-1.5b's rings; the MoE serve runs' G 1 (moonshot, 48
              and 2,080 rows) and G 6 (grok, 48 rows) at head_dim 128;
              the mesh phase's per-rank heads and slots);
  kernel_lora lora_matmul at the decode, train, prefill, long train and
              long prefill shapes of qwen1.5-0.5b, two ragged shapes
              (M 1000 and 5), mamba2-780m's ssm_in / ssm_out at
              decode and a 2,048-token prefill, and the decode q/o and
              k/v projections of llama-3.2-vision-90b and llama3-8b,
              the training CLI's batches (qwen 4 x 128, llama3-8b 8 x 64),
              and (bf16) the rows of every M > 16 wave the serve, prefix,
              chunked and budget runs give it (qwen's suffix wave 8 x 224
              and chunk wave 8 x 256, llama3-8b's 8 x 992 and 8 x 224
              waves), hymba-1.5b's ssm_in (N 6,482, no multiple of 8: W
              and B in padded storage) at M 8 and 8,192, plus its
              backward (dX, dA, dB of
              LoRAMatmulFn against autograd of the plain version) at the
              train shapes and the decode shape; the MoE phases' q/k/v/o
              (moonshot K = N = 2,048; grok q/o 6,144, k/v N 1,024) at
              every M they launch, the train batches' backward too; the
              mesh phase's per-rank blocks (llama3-8b, grok);
  kernel_flash flash_attention forward and backward against the plain
              version (dense f32 softmax, autograd of it) at the prefill
              waves of qwen1.5-0.5b (8 x 2,048 and 8 x 4,096) and
              llama3-8b (8 x 2,048, GQA 4:1 with head_dim 128), the
              train batches (qwen 4 x 2,048, llama3-8b 1 x 2,048), ragged
              lengths 1,000 and 2,049 and a 512-token window, hymba-1.5b's
              and moonshot-v1-16b-a3b's 8 x 2,048 wave; non-causal (each
              row's mask a column of FLASH_SHAPES, the bound counting S^2
              pairs) at head_dim 64 and 128 and at hubert-xlarge's 80
              (16 / 16 heads): its serve wave 4 x 2,048, 1 x 1,040 (the
              Skv edge) and its train batch 2 x 2,048; the
              backward twice (dK, dV bitwise, dQ within one bf16 ulp);
              achieved TFLOP/s;
  kernel_seg  segmented_lora_matmul against its plain version at the
              multi-tenant decode (1, 4 and 8 slots) and prefill waves of
              qwen1.5-0.5b, its 4-tenant suffix wave (8 x 224), a ragged
              shape, llama3-8b's decode and moonshot-v1-16b-a3b's
              4-tenant decode and 8 x 32 wave; in bf16
              each row bitwise lora_matmul of its own slot (B = 0 for -1
              rows) and no leak from 1e6 in an unused slot;
  kernel_ssd  ssd_scan against its plain version (the reference's chunked
              SSD at chunk 256) at mamba2-780m's prefill (H 48, P 64,
              N 128) of 32, 992, 1,000, 2,048 and 4,096 tokens, two
              requests of 512 from a random state and hymba-1.5b's heads
              (H 50, N 16), x float32 and bfloat16 as a strided view like
              the mixer's; 2,048 tokens and the two requests again with
              dt and a as the mixer makes them, so that the state
              carried from one chunk to the next shows in y; then the
              backward kernel against ``ssd_scan_bwd_ref`` (every
              gradient) at every shape the SSM phases train at: mamba2
              and hymba at 4 x 32, 4 x 256 and 4 x 2,048 rows, hymba at 4
              x 1,984, 2 x 1,000 from a random state with a gradient on
              the final state, and the test distributions, two calls
              bitwise equal, its workspace's peak, its bound at float32's
              rate and as 3xTF32 on the tensor cores; and autograd
              through ``ssd_scan`` on CUDA tensors reaching it, chained
              and in a single chunk, with the launches its plan names;
  kernel_lse  the return_lse launch of paged_decode_attention (float32
              output and log-sum-exp) against its plain version at the
              mesh phase's sequence-sharded shapes (LSE_SHAPES), with
              rows at kv_len 0: exactly zeros and -inf, no NaN;
  kernel_decode decode_attention against its plain version at the VLM's
              cross-attention decode (8 slots, 64 heads / 8 KV, head_dim
              128, 1,601 vision tokens, K/V the transposed view of the
              [B, T, Hkv, D] projection), the same with ragged lengths and
              an empty row (exactly zero), and tests/test_kernels.py's
              three shapes; SDPA is the library time.
              Every kernel phase but the flash one also calls each
              kernel twice on the same inputs (bitwise equal, or the
              phase fails) and times the wrapper's host microseconds per
              call (``host_us``: checks, allocation, launch).
              Every kernel phase reports the worst error, kernel / plain
              / library time (CUDA events, median of REPS or FLASH_REPS,
              L2 flushed before each) and the least time the card could
              take (bytes over 3.35 TB/s, operations over the dtype's
              peak rate, whichever is larger);
  reference   the port on the card against the port on the CPU (plain
              versions) at a reduced float32 config: decode logits, one
              train step's loss, LoRA gradients and updated adapter;
              full-width logits finite and of the right shape, and a
              full-width combined_step_paged whose logits equal a
              decode_step_paged with the pre-update adapter; mamba2 at
              its reduced float32 size: prefill logits and SSM caches,
              five decode steps' logits; the VLM at a reduced float32
              size (2 units, 37 vision tokens, gates at 0.5): prefill
              logits, cross_kv, five decode steps' logits and
              decode_attention once per unit per step; the batcher's
              greedy tokens on the card and the CPU (reduced float32):
              a repeated-prefix trace with the prefix cache off, on and
              on chunked, six prompts chunked (paged 8 and 12, contiguous
              8 and 10) and monolithic, a 16-token window whose ring
              wrap copies shared blocks, and tests/test_preemption.py's
              traces oversubscribed (swap under REPRO_SANITIZE=1, drop,
              chunked, shared prefixes) beside an unbounded pool, every
              run of a trace equal, every oversubscribed run preempting;
  reference_blockwise  the same at a reduced float32 config forced onto
              the blockwise path (prefill logits and caches, one train
              step, the flash launches they make), and at full width in
              bf16 on 992 tokens each layer's attention on the
              blockwise against the dense path, same input;
  serve       qwen1.5-0.5b at full width (d_model 1024, 8 layers, bf16,
              random weights from a seed) through ``run_serving``, 16
              requests on 8 slots: paged and contiguous with 32-token
              prompts, 992-token prompts paged (blocks of 16 and of 128)
              and contiguous, 2,048-token prompts paged and contiguous,
              4,096-token prompts paged; then llama3-8b at full width,
              paged, 2,048-token prompts.  Every request finishes, the
              allocator drains, all layouts of one traffic emit the same
              tokens, and the launches are exactly as derived: the decode
              kernel once per layer per decode step, lora_matmul once per
              adapter projection per prefill wave and decode step,
              flash_attention once per layer per prefill wave past 1,024
              tokens and never below; TTFT and TPOT p50 / p99 per run;
  serve_prefix  prefix caching at full width: qwen1.5-0.5b paged, 16
              requests on 8 slots, two families sharing a 768-token prefix
              with tails of 32 to 224 tokens, 32 tokens each, cache off,
              on, and on with 4 tenants (identical prompts to different
              tenants); llama3-8b (GQA 4:1) cache off and on.  Every
              request finishes, the allocator drains, the cache hits,
              launches as derived, first logits on vs off within 2e-2
              (bf16, qwen and llama3-8b), no block aliased across
              tenants; prefill tokens computed and cached, wave times,
              TTFT / TPOT p50 / p99;
  serve_chunked  the 992 + 32 traffic paged and contiguous, prefill_chunk
              256 against monolithic: final-chunk logits within 2e-2 of the
              monolithic prefill's, launches as derived, TTFT / TPOT;
  serve_oversub  KV-pool oversubscription at full width: a 62-block chain
              of qwen's bf16 pool swapped to host and back onto fresh ids
              (moved blocks bitwise, paged_decode_attention over the
              remapped table bitwise its output over the original, swap
              GB/s each way), then 16 requests of 64 + 64 tokens on 8
              slots, paged in blocks of 16: qwen on a pool of 64 blocks
              (every slot fits) and of 40 (admission holds 5 slots), on
              40 at oversubscribe 1.0 with swap (again under
              REPRO_SANITIZE=1: no report, host ms a tick it adds) and
              without (drop and re-prefill), llama3-8b on 40 with swap;
              every request finishes, the allocator drains, the
              oversubscribed runs preempt, launches as derived; tok/s,
              TTFT / TPOT, peak blocks, preemptions, blocks swapped each
              way, tokens re-prefilled, what ``_SwapCost`` chose, swap ms
              per block and GB/s;
  static      ``static_batch_serve`` (batches of 8) against the batcher (8
              contiguous slots), qwen 32 + 16, without and with an EOS id
              that fires: the same EOS rule, launches as derived, tok/s;
  mesh        serving on a 2 x 2 (data, model) mesh, one process a rank
              (``launch/mesh.py::spawn_ranks``; gloo, the four ranks
              sharing card 0, or NCCL with a card a rank where the
              machine has four): each model of MESH_MODELS served
              unsharded first, then ``static_batch_serve`` on every rank
              on ``init_sharded`` weights from the same seed, under
              ``rules_for``'s table and a forced ``kv_seq`` table (the
              sequence-sharded decode through the ``return_lse`` launch);
              every rank's tokens equal, the logits of every step both
              runs reached alike within MESH_TOL of the unsharded
              run's (MoE: of a 1 x 1 mesh's run of the same weights,
              which rounds the expert sums as the mesh path does, its
              expert choices replayed on the ranks, and over the
              prefill wave about as few of them tipped as the unsharded
              run tips against it), every rank's launches
              nonzero and as derived and
              its shapes checked by a kernel phase, every rank's serve
              peak under half the unsharded weights and caches; prints
              the backend, ranks, cards and whether they share one;
  serve_ssm   mamba2-780m at full width (d_model 1536, 8 layers, bf16),
              16 requests on 8 contiguous slots at 32+16, 992+32 and
              2,048+32 tokens: every request finishes, ssd_scan once per
              layer per request (SSD_LAUNCHES launches a call),
              lora_matmul once per adapter projection
              per prefill call and decode step, no attention kernel;
              every lora_matmul shape launched one that kernel_lora
              checked (``LoraShapeTap``);
  serve_hybrid  hymba-1.5b: the reduced float32 batcher's greedy tokens
              on the card and the CPU (16-token window, ring wraps); at
              full width (16 of 32 layers, d_model 1,600, 25 / 5 heads of 64,
              window 2,048, 50 SSM heads of 64, state 16, bf16) through
              ``run_serving``, 8 contiguous slots: 16 requests at 32+16
              and 992+32, 8 at 1,984+128 (every decode wraps the ring):
              every request finishes, launches exactly as derived
              (ssd_scan per layer per request, flash_attention per layer
              per prefill past 1,024 tokens, the paged kernel per layer
              per decode step, lora_matmul per adapter projection),
              every attention and lora_matmul shape launched one that a
              kernel phase checked; TTFT / TPOT; a 1,984-token prompt
              decoded 128 tokens past the window, its logits past
              position 2,048 against ``Model.logits`` of the same tokens
              (5e-2 of the largest, 90% of the argmaxes), every attention
              and lora_matmul shape of that check (decode at M 1, the
              forward at M 2,112) one that a kernel phase checked;
  serve_vlm   llama-3.2-vision-90b at published width (d_model 8192, 64
              heads / 8 KV, d_ff 28672, bf16), depth cut to 4 whole units
              (20 of 100 layers), gates at 0.5, through Engine.prefill_step
              and decode_step (the batcher refuses VLM stacks, as in the
              reference): 16 requests on 8 slots in two waves of 32-token
              prompts with their own random vision inputs, 16 tokens each;
              launches exactly as derived, and one unit's cross-attention
              at decode through the kernel against the dense path (bf16,
              2e-2);
  combined_vlm  co-training on serve_vlm's weights (not drawn again):
              8 decode slots filled by a prefill, three
              ``Engine.combined_step``s (a decode tick and an AdamW step
              on a 4 x 32 batch with vision [4, 1,601, 8,192]): the first
              tick's logits equal a plain decode step's with the
              pre-update adapter, finite losses, launches exactly as
              derived, every lora_matmul shape (dX included) one that
              kernel_lora checked; then ``launch/train.py``'s loop for 2
              steps (zero vision inputs); then the reduced float32 VLM's
              LoRA gradients card against CPU (1e-4 of each leaf's
              largest, gates 0.5);
  combined    the same servers co-training the adapter on every tick
              (``run_serving(combined=True)``, train batch 4 x prompt
              length; llama3-8b 1 x prompt length): qwen paged and
              contiguous 32+16, paged 992+16 and 2,048+16, llama3-8b paged
              2,048+16; one train step per tick with finite losses, and
              launches exactly as derived (lora_matmul: forward, then dX
              of every projection but layer 0's q/k/v; flash_attention:
              one forward per layer per prefill wave and train step, three
              backward launches per layer per train step, past 1,024
              tokens only);
  combined_ssm  co-training on SSM stacks (``run_serving(combined=
              True)``, 8 contiguous slots, 16 requests): mamba2-780m and
              hymba-1.5b at 32+16 with 4 x 32 train rows, mamba2 at
              2,048+8 with 4 x 2,048 (the backward at 2,048 tokens): one
              train step per tick, finite losses, launches exactly as
              derived (ssd_scan and its backward per layer per train
              step, lora_matmul forward and dX), every lora_matmul and
              backward shape launched one that a kernel phase checked
              (``LoraShapeTap``, ``SsdBwdShapeTap``); each arch's loss on
              a fixed 4 x 32 batch falls over six steps;
  serve_adapters  multi-tenant serving at full width (4 tenants tagged
              round-robin; qwen paged and contiguous 32+16, paged 992+32 and
              2,048+32, 6 tenants on 4 device slots, co-training paged
              32+16, llama3-8b paged 32+16): every request finishes, refs
              and blocks return, launches exactly as derived
              (segmented_lora_matmul once per adapter projection per wave
              and step, lora_matmul only in the train step), tenant 0
              (b = 0) emits the single-adapter run's tokens;
  budget      co-training under a 0.1 s TPOT target, paged, 32 + 16 (4 x
              32 train rows) and 992 + 16 in chunks of 256 (4 x 992),
              through run_serving; the host ms of drawing one train
              batch (run_serving draws one every tick); train steps,
              rows per trained tick,
              skipped ticks, spend over target, TPOT, beside the combined
              phase's unbudgeted runs; every request finishes, every loss
              finite;
  mixed_solo  one wave of base and three tenants against each of them
              served alone as the single adapter on the same prompts: the
              same greedy tokens (each request in a wave of its own is
              read out beside it);
  fabric_reference  the live fabric (``runtime/fabric.py``) at the
              reduced float32 config: 2 replicas of 2 paged slots emit the
              greedy tokens of one batcher on the card and of the same
              fabric on the CPU (weights copied across), and with r1
              failed over at tick 3 the never-failed run's;
  fabric      (l-a) ``run_multi_replica_serving`` at full width: 2
              replicas of 4 paged slots over one device copy of the
              weights, 16 requests of 32 + 16, beside one batcher of 8
              slots; (l-b) the same with r1 failed over at tick 6;
              fabric and per-replica tok/s, busy shares, TTFT / TPOT, host
              ms of ``ServingFabric.tick`` and its ``ClusterController.
              tick`` share, peak memory against the weights and pools;
  fabric_combined  (l-c) ``run_combined_fabric_serving``: 2 replicas, 2
              FL rounds of 4 fused steps on a fixed pool of 4 batches,
              FedAvg and publish at the boundaries: versions >= 2 on
              both, round CE falls, every decode inside a round reads the
              published tree (bitwise at the round's end);
  fabric_chaos  (l-d) the same over 3 replicas under ``--chaos``, one
              crash and one NaN round from the seeded schedule: the NaN
              publish refused with the served tree bitwise unchanged, one
              failover for the crash, no quarantine;
  fabric_adapters  (l-e) ``run_multi_replica_serving(n_adapters=4)``:
              segmented_lora_matmul on every wave and tick, the tenant
              rollup sums to the requests finished.
              In every fabric phase the port's ``fabric.warm_up`` warms
              the replicas' shapes inside the entry point, before the
              fabric's clock starts (its seconds are printed); every
              request completes with its whole budget, every replica's
              pool ends all-free, failovers and quarantines equal the
              injected faults (the health monitor's record is printed),
              the launches are exactly as derived from the replicas'
              counts (eval probes and the train steps' microbatches
              included), and every lora_matmul / segmented_lora_matmul
              launch shape, dX included, is one that kernel_lora or
              kernel_seg held against the plain version;
  train       ten full-width train steps on one fixed 4 x 256 batch: the
              loss falls, 189 lora_matmul launches per step;
  train_cli   the training CLI (``launch/train.py``): (a)
              ``train_from_weights`` on one reduced float32 weight set on
              the card, 15 steps with a checkpoint every 5, then 25 with
              a NaN injected at step 12 (rolled back to 10), and each
              run's trajectory one step at a time, the card taking every
              step from the CPU's state (``train_walk``: losses within
              1e-5 relative, moments within float32 noise, adapters
              within 1e-6 plus what the moments' bounds allow); (a2) tests/test_drivers.py's check on the card (the
              reduced qwen, 30 steps of 8 x 32: held-out CE falls); (b)
              ``run_training`` at full width, qwen1.5-0.5b bf16, 4 x 256,
              20 steps, checkpoints every 10: CE on the last batch trained
              on below the initial adapter's (held-out CE reported: 20
              steps do not teach a chain over 151,936 tokens),
              lora_matmul launches exactly
              20 x 189, no flash_attention launch; host ms a step, the
              share of the loop's loss pulls, checkpoint save / wait
              seconds, peak memory; (c) ``restore=True`` to 30 steps from
              (b)'s directory: resumes at 20, runs 10, the restored tree
              bitwise (b)'s with AdamW step 20; a card checkpoint
              restored onto the CPU and a CPU one onto the card bitwise;
              (d) 4 x 2,048, 3 steps: flash_attention forward and
              backward launches as derived; (e) the CLI's ``main``
              (``--full``) in this process, 10 steps, then ``main``
              ``--restore`` to 15 in a subprocess; the manifest's codec as this machine has it; (f) llama3-8b,
              the CLI's default arch and batch (8 x 64), 5 steps; (g)
              ``DataPipeline`` on the card yields the sample function's
              batches in order, bitwise; every lora_matmul launch shape
              of (b)-(f), dX included, one that kernel_lora checked;
  train_cli_ssm  the training CLI on mamba2-780m and hymba-1.5b: (a)
              reduced float32, 10 steps on the card, and their trajectory
              one step at a time against the CPU (``train_walk``); (b)
              full width, 4 x 256, 3 steps, a checkpoint at 3: the last
              batch's CE falls, launches as derived, step ms, peak
              memory; (c) the restart to 4: the restored tree bitwise
              (b)'s, AdamW step 3; every attention, lora_matmul and
              backward shape of (b) and (c) one that a kernel phase
              checked;
  moe_route   ``moe._routing`` on the card against the CPU on the same
              float32 logits: moonshot-v1-16b-a3b's 64 experts, top 6, at
              a decode group of 8 and at 512-token groups, grok-1-314b's
              8 experts, top 2, at 8 and 128, planted exact ties, one
              expert every token wants (drops): dispatch and combine
              bitwise, aux within 1e-6 of its magnitude;
  serve_moe   moonshot-v1-16b-a3b at published width (d_model 2,048, 16
              / 16 heads of 128, 64 experts of 1,408, top 6, bf16) at
              DEPTH_CUT's 8 layers through ``run_serving``, 16 requests on
              8 slots: paged and contiguous 32 + 16 (the same tokens,
              bitwise), paged 2,048 + 32, 4 tenants paged 32 + 16; then
              grok-1-314b (d_model 6,144, 48 / 8 heads of 128, 8 experts
              of 32,768, top 2) cut to GROK_LAYERS (4 of 64 layers),
              paged 32 + 16: every request finishes, launches exactly as
              derived, every attention and lora_matmul shape one a kernel
              phase checked; tok/s, TTFT / TPOT p50 / p99, peak memory;
  combined_moe  both stacks co-training (paged 32 + 16, 4 x 32 train
              rows a tick): one step a tick, the loss and the
              load-balancing aux loss finite, aux > 0, launches as
              derived, every shape (dX included) checked;
  train_cli_moe  the training CLI on moonshot: (a) a reduced float32
              moonshot with its 64 experts, top 6, card against CPU one
              step at a time (``moe_walk``: a step whose routing flips
              between the two is named, and held to the reference's MoE
              rule if it misses the walk's bounds); (b) 8 layers at
              published width, 4 x 256, 3 steps, a checkpoint at 3: the
              last batch's CE falls, aux > 0; (c) the restart to 4: the
              restored tree bitwise, AdamW step 3;
  serve_encoder  hubert-xlarge at published depth and width (48 layers,
              d_model 1,280, 16 / 16 heads of 80, bf16, random weights
              from a seed) through ``Engine.encoder_serve_step``: waves of
              seeded frame embeddings, 8 x 512 (dense attention) and 4 x
              2,048 (flash_attention, non-causal, D 80), a warm wave and
              three timed ones each: frames/s, ms per wave, logits finite
              and shaped, launches exactly as derived, peak memory; the
              reduced float32 copy (2 layers, full width) at 1 x 1,040
              card against CPU (5e-5 of the largest logit); every
              attention and lora_matmul shape one a kernel phase checked;
  train_encoder  (a) the reduced float32 hubert one step at a time card
              against CPU (``train_walk``, frame embeddings drawn once);
              (b) ``run_training`` at published depth and width, 4 x 256
              frames, 3 steps, a checkpoint at 3: finite losses,
              launches as derived; (c) the restart to 4: the restored
              tree bitwise; (d) one ``Engine.train_step`` at 2 x 2,048
              frames: the D-80 non-causal flash forward and backward,
              finite loss, launches as derived; every shape of (b)-(d)
              checked;
  experiment  ``run_experiment`` for the five policies at
              tests/test_experiment.py's short configuration (6
              replicas, 420 s simulated, seed 3) and those tests'
              checks; printed with ``"simulated": true`` (the simulator's
              arithmetic, no card time);
  tick        where a full-width tick's time goes, at DEPTH_CUT's
              layers since PR 29 (serve ticks at 32-,
              992- and 2,048-token prompts, combined ticks with a 4 x 32
              and a 4 x 2,048 train batch, a serve tick of 4 tenants at 32
              tokens, mamba2-780m decode ticks after 32-token
              prompts and a combined one (4 x 32), hymba-1.5b's serve and
              combined ticks at 32, a VLM
              decode tick; one full, one suffix and one
              chunk prefill wave at serve_prefix's shapes): host wall per
              tick or wave, and under torch.profiler the device time,
              each kernel's share and the kernels launched;
  seconds     each phase's wall seconds and the total since the build
              began (the run must end within 1,200 s);
  kernels     one line over all ported kernels.
Bring-up only, when named: ``splits`` times decode_attention and the
lora_matmul decode path over a range of split counts (what their split
plans rest on), beside a streaming-read yardstick; ``budget_seeded`` runs
the budget phase's traffic with the train cost priced first by a warm
idle train tick (a policy the runtime does not have); ``kernel_ssd_bwd``
runs the ssd_scan backward's rows and autograd checks alone; ``tick_moe``
the MoE tick alone (moonshot-v1-16b-a3b at its published 48 layers: the
expert products' part and the least time of reading every weight the
tick reads).
Depth: every phase but the fabric phases and tick_moe (WHOLE_DEPTH)
runs qwen1.5-0.5b, llama3-8b, mamba2-780m, hymba-1.5b and
moonshot-v1-16b-a3b at their published widths with DEPTH_CUT's layers
(8 of 24, 8 of 32, 8 of 48, 16 of 32, 8 of 48; the registry's entries
replaced in this process, so
``run_serving`` and ``run_training`` build them too), every phase
grok-1-314b at GROK_LAYERS (4 of 64) and the VLM at VLM_LAYERS (20 of
100); hubert-xlarge runs its published 48 layers: a tick's host time, which bounds
nearly every run here, grows with the kernels it launches, so with
depth.
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that.  Without a CUDA device, or without the rest of the repository, it
exits non-zero and prints no result.
"""
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

# ``--time-kernels SRC`` (a child of ``--ab``) times the package under SRC
SRC = (sys.argv[2] if sys.argv[1:2] == ["--time-kernels"]
       else os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
sys.path.insert(0, SRC)

HBM_BYTES_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_OPS_S = {torch.float32: 67e12,    # f32 outside the tensor cores
              torch.bfloat16: 989e12}  # dense bf16 tensor cores
PEAK_TF32_S = 495e12                   # dense TF32 tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# timed runs a median (30 until PR 29, which cut it to make room for the
# mesh phase within the script's time)
REPS = 20
ARCH = "qwen1.5-0.5b"
# layers of the earlier paths' archs (published widths; see the module
# docstring) in every phase but WHOLE_DEPTH's: the fabric phases (their
# peak-memory check bounds the activations by half a copy of the
# weights, the embedding and head's 622 MB being most of a cut qwen) and
# the bring-up tick_moe; mamba2-780m and hymba-1.5b cut further (16 -> 8,
# 32 -> 16) to make room for the encoder and VLM co-training phases,
# and tick too since PR 29 (its breakdowns before then are at whole
# depth), to make room for the mesh phase, within the script's time
DEPTH_CUT = {"qwen1.5-0.5b": 8, "llama3-8b": 8, "mamba2-780m": 8,
             "hymba-1.5b": 16, "moonshot-v1-16b-a3b": 8}
# grok-1-314b at published width, cut to whole layers in every phase
# (n_layers 64 -> 4: 4 x 9.67 GB of layers, 3.22 GB of embedding and head)
GROK_ARCH = "grok-1-314b"
GROK_LAYERS = 4
WHOLE_DEPTH = {"tick_moe", "fabric_reference", "fabric",
               "fabric_combined", "fabric_chaos", "fabric_adapters"}
# ARCH's adapter projections per forward (8 layers x q/k/v/o) and their
# dX in the backward (but layer 0's q/k/v); main() derives them again
N_LORA = 32
N_LORA_BWD = 29
LORA_SCALING = 2.0  # alpha / r = 32 / 16
# kernel vs plain, relative to the plain output's largest magnitude:
# float32 sums over K <= 2816 in another order; in bfloat16 both round
# x @ A and the output to bf16, at most one ulp apart (2^-8..2^-7)
LORA_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# (name, M, K, N, r): qwen1.5-0.5b's q/k/v/o at each caller's M; between
# them they take the bf16 decode path and both tile widths of the M > 16
# path; then mamba2-780m's ssm_in (N = 6448: no multiple of 64) and
# ssm_out at decode (8 slots) and at a 2,048-token prefill (forward only);
# then the decode projections of llama-3.2-vision-90b's dense blocks and of
# llama3-8b (q/o: N = K; k/v: N = 8 KV heads x 128), and qwen's at 16
# slots (the decode path's second fragment of 8 rows); then, bf16 only
# (LORA_BF16_ONLY), the M > 16 calls of the serve and combined runs the
# rows above lack: qwen's 4 x 2,048 train batch and 8 x 2,048 prefill
# wave, llama3-8b's 2,048-row train batch and prefill (q/o and k/v), and
# the VLM's 8 x 32 prefill wave at its q/o; then the suffix programs'
# waves (serve_prefix, serve_chunked, budget): qwen's suffix wave (8 x
# 224 over the cached prefix) and chunk wave (8 x 256), llama3-8b's full
# wave (8 x 992) and suffix wave (q/o and k/v each); then the fabric's
# (traffic (l)): a replica's decode at 4 slots, its prefill waves of 1 and
# 3 requests of 32 (2 are the train microbatch's M, 4 the "train" row's)
# and the combined rounds' train microbatch (2 x 32 rows: train batch 4
# in grad_accum 2), whose backward runs too; then the training CLI's
# (train_cli phase) batches of 4 x 128 (qwen) and 8 x 64 (llama3-8b, the
# CLI's default arch and batch: q/o and k/v), with their backward; then
# hymba-1.5b's ssm_in (N = 6,482 = 8 x 810 + 2: W in padded storage, B
# and in the backward dY copied into such storage by the wrapper, the
# output row by row) at decode and at a 4 x 2,048 train batch with its
# backward
LORA_SHAPES = [("decode", 8, 1024, 1024, 16),          # 8 slots
               ("train", 128, 1024, 1024, 16),         # 4 x 32 tokens
               ("prefill", 256, 1024, 1024, 16),       # 8 x 32 prompt
               ("train_256", 1024, 1024, 1024, 16),    # 4 x 256 tokens
               ("train_long", 3968, 1024, 1024, 16),   # 4 x 992
               ("prefill_long", 7936, 1024, 1024, 16), # 8 x 992
               ("ragged", 1000, 1000, 2816, 16),       # no tile multiple
               ("ragged_decode", 5, 1000, 2816, 16),   # the same, M <= 16
               ("ssm_in_decode", 8, 1536, 6448, 16),
               ("ssm_in_prefill", 2048, 1536, 6448, 16),
               ("ssm_out_decode", 8, 3072, 1536, 16),
               ("ssm_out_prefill", 2048, 3072, 1536, 16),
               ("vlm_decode_qo", 8, 8192, 8192, 16),
               ("vlm_decode_kv", 8, 8192, 1024, 16),
               ("llama_decode_qo", 8, 4096, 4096, 16),
               ("llama_decode_kv", 8, 4096, 1024, 16),
               ("decode_m16", 16, 1024, 1024, 16),
               ("train_2048", 8192, 1024, 1024, 16),
               ("prefill_2048", 16384, 1024, 1024, 16),
               ("train_llama_qo", 2048, 4096, 4096, 16),
               ("train_llama_kv", 2048, 4096, 1024, 16),
               ("vlm_prefill_qo", 256, 8192, 8192, 16),
               ("suffix_1792", 1792, 1024, 1024, 16),
               ("chunk_2048", 2048, 1024, 1024, 16),
               ("llama_prefill_qo", 7936, 4096, 4096, 16),
               ("llama_prefill_kv", 7936, 4096, 1024, 16),
               ("llama_suffix_qo", 1792, 4096, 4096, 16),
               ("llama_suffix_kv", 1792, 4096, 1024, 16),
               ("fabric_decode_4", 4, 1024, 1024, 16),
               ("fabric_prefill_32", 32, 1024, 1024, 16),
               ("fabric_prefill_96", 96, 1024, 1024, 16),
               ("train_micro", 64, 1024, 1024, 16),
               ("train_cli", 512, 1024, 1024, 16),
               ("train_llama_cli_qo", 512, 4096, 4096, 16),
               ("train_llama_cli_kv", 512, 4096, 1024, 16),
               ("hymba_ssm_in_decode", 8, 1600, 6482, 16),
               ("train_hymba_ssm_in", 8192, 1600, 6482, 16)] + [
    # the SSM and hybrid phases' (serve_ssm, serve_hybrid, combined_ssm,
    # train_cli_ssm): mamba2's ssm_in / ssm_out prefills of 32 and 992
    # tokens and its train batches of 4 x 32, 4 x 256 and 4 x 2,048;
    # hymba's q/o, k/v (5 heads of 64) and ssm_out at decode, and all
    # four at its prefills of 32, 992 and 1,984 tokens and train batches
    # of 4 x 32, 4 x 256 and 4 x 1,984; then all four at the ring wrap's
    # one-slot decode (M 1) and its forward over 2,112 tokens
    (f"{kind}{proj}_{m}", m, k, n, 16)
    for kind, ms in (("ssm_prefill_", (32, 992)),
                     ("train_ssm_", (128, 1024, 8192)))
    for m in ms
    for proj, k, n in (("in", 1536, 6448), ("out", 3072, 1536))] + [
    ("hymba_decode_qo", 8, 1600, 1600, 16),
    ("hymba_decode_kv", 8, 1600, 320, 16),
    ("hymba_ssm_out_decode", 8, 3200, 1600, 16)] + [
    (f"{kind}{proj}_{m}", m, k, n, 16)
    for kind, ms in (("hymba_prefill_", (32, 992, 1984)),
                     ("train_hymba_", (128, 1024, 7936)))
    for m in ms
    for proj, k, n in (("qo", 1600, 1600), ("kv", 1600, 320),
                       ("ssm_in", 1600, 6482), ("ssm_out", 3200, 1600))] + [
    (f"hymba_ring_{proj}_{m}", m, k, n, 16)
    for m in (1, 2112)
    for proj, k, n in (("qo", 1600, 1600), ("kv", 1600, 320),
                       ("ssm_in", 1600, 6482), ("ssm_out", 3200, 1600))] + [
    # the MoE phases' (serve_moe, combined_moe, train_cli_moe):
    # moonshot-v1-16b-a3b's q/k/v/o (K = N = 2,048) at decode (8 slots),
    # its prefill waves of 8 x 32 and 8 x 2,048 and its train batches of
    # 4 x 32 and 4 x 256; grok-1-314b's q/o (N 6,144) and k/v (8 KV heads
    # of 128: N 1,024) at decode, its 8 x 32 wave and 4 x 32 train batch
    ("moe_decode", 8, 2048, 2048, 16),
    ("moe_prefill", 256, 2048, 2048, 16),
    ("moe_prefill_2048", 16384, 2048, 2048, 16),
    ("train_moe", 128, 2048, 2048, 16),
    ("train_moe_cli", 1024, 2048, 2048, 16)] + [
    (f"{kind}_{proj}", m, 6144, n, 16)
    for kind, m in (("grok_decode", 8), ("grok_prefill", 256),
                    ("train_grok", 128))
    for proj, n in (("qo", 6144), ("kv", 1024))] + [
    # the encoder and VLM co-training phases (serve_encoder,
    # train_encoder, combined_vlm): hubert-xlarge's q/k/v/o (K = N =
    # 1,280) at its flash serve wave (4 x 2,048), the card-vs-CPU
    # check's 1 x 1,040 (float32 too), its train batches of 4 x 256 and
    # 2 x 2,048 with their backward (the latter's 4,096 rows also the
    # dense serve wave's 8 x 512); the VLM's q/o and k/v at its 4 x 32
    # train batch, with their backward
    ("hubert_serve_8192", 8192, 1280, 1280, 16),
    ("hubert_edge_1040", 1040, 1280, 1280, 16),
    ("train_hubert_1024", 1024, 1280, 1280, 16),
    ("train_hubert_4096", 4096, 1280, 1280, 16),
    ("train_vlm_qo", 128, 8192, 8192, 16),
    ("train_vlm_kv", 128, 8192, 1024, 16)] + [
    # the mesh phase's local shapes on a 2 x 2 (data, model) mesh, where
    # each rank contracts its w_embed block (K / 2) into its heads' block
    # (N / 2): llama3-8b's q/o (2,048 x 2,048) and k/v (N 512) at decode
    # (8 slots) and at the 8 x 32 wave (float32 too: the 2-layer float32
    # copy), its 8 x 2,048 wave cut by rows (4 x 2,048 a rank, the weights
    # gathered over data: q K 4,096 N 2,048, k/v N 512, o K 2,048 N
    # 4,096); grok-1-314b's q/o (3,072) and k/v (N 512) at decode and its
    # 8 x 32 wave (float32 too: its 1-layer float32 copy; moonshot's
    # 1,024 x 1,024 blocks are the decode and prefill rows above)
    ("mesh_llama_decode_qo", 8, 2048, 2048, 16),
    ("mesh_llama_decode_kv", 8, 2048, 512, 16),
    ("mesh_llama_prefill_qo", 256, 2048, 2048, 16),
    ("mesh_llama_prefill_kv", 256, 2048, 512, 16),
    ("mesh_llama_long_q", 8192, 4096, 2048, 16),
    ("mesh_llama_long_kv", 8192, 4096, 512, 16),
    ("mesh_llama_long_o", 8192, 2048, 4096, 16),
    ("mesh_grok_decode_qo", 8, 3072, 3072, 16),
    ("mesh_grok_decode_kv", 8, 3072, 512, 16),
    ("mesh_grok_prefill_qo", 256, 3072, 3072, 16),
    ("mesh_grok_prefill_kv", 256, 3072, 512, 16)]
LORA_BF16_ONLY = {"train_2048", "prefill_2048", "train_llama_qo",
                  "train_llama_kv", "vlm_prefill_qo", "suffix_1792",
                  "chunk_2048", "llama_prefill_qo", "llama_prefill_kv",
                  "llama_suffix_qo", "llama_suffix_kv", "train_cli",
                  "train_llama_cli_qo", "train_llama_cli_kv",
                  "train_hymba_ssm_in"} | {
    row[0] for row in LORA_SHAPES
    if row[0].startswith(("ssm_prefill_", "train_ssm_", "hymba_prefill_",
                          "train_hymba_", "moe_", "train_moe", "grok_",
                          "train_grok", "hubert_serve", "train_hubert",
                          "train_vlm", "mesh_llama_long"))
    or row[0].endswith("_2112")}


def lora_has_backward(name):
    """Whether phase_kernel_lora also checks a LORA_SHAPES row's
    backward (dX, dA, dB): the train rows and the decode tile's."""
    return name.startswith("train") or name in ("decode", "decode_m16")


def lora_dtypes(name):
    """The dtypes a LORA_SHAPES row runs in: float32 serves the reduced
    configs only, so the full-width M > 16 rows are bf16 alone."""
    return ((torch.bfloat16,) if name in LORA_BF16_ONLY
            else (torch.float32, torch.bfloat16))


# flash_attention: (name, B, H, Hkv, D, S, window, causal) -- every
# shape the serve, combined and train phases give it: the prefill waves of
# qwen1.5-0.5b (8 x 2,048 and 8 x 4,096) and llama3-8b (GQA 4:1,
# head_dim 128), the co-training train batches (qwen 4 x 2,048, llama
# 1 x 2,048); then two ragged lengths and a sliding window; then
# hymba-1.5b's (25 / 5 heads of 64, a 2,048-token window): a request's
# 1,984-token exact-length prefill, the ring check's forward over 2,112
# tokens (the window binding) and the co-training train batch of 4 x
# 1,984 (forward and backward)
FLASH_SHAPES = [("qwen_prefill", 8, 16, 16, 64, 2048, 0, True),
                ("qwen_prefill_4096", 8, 16, 16, 64, 4096, 0, True),
                ("llama_prefill", 8, 32, 8, 128, 2048, 0, True),
                ("qwen_train", 4, 16, 16, 64, 2048, 0, True),
                ("llama_train", 1, 32, 8, 128, 2048, 0, True),
                ("ragged_1000", 8, 16, 16, 64, 1000, 0, True),
                ("ragged_2049", 4, 16, 16, 64, 2049, 0, True),
                ("window", 4, 16, 16, 64, 2048, 512, True),
                ("hymba_prefill", 1, 25, 5, 64, 1984, 2048, True),
                ("hymba_ring", 1, 25, 5, 64, 2112, 2048, True),
                ("hymba_train", 4, 25, 5, 64, 1984, 2048, True),
                # moonshot-v1-16b-a3b's prefill wave (16 / 16 heads of 128)
                ("moonshot_prefill", 8, 16, 16, 128, 2048, 0, True),
                # non-causal at the decoders' head dims (no model path
                # launches these; the encoder's mask at D 64 and 128)
                ("noncausal_64", 4, 16, 16, 64, 2048, 0, False),
                ("noncausal_128", 1, 32, 8, 128, 2048, 0, False),
                # hubert-xlarge (16 / 16 heads of 80, non-causal): the
                # serve wave 4 x 2,048, the card-vs-CPU check's 1 x 1,040
                # (no multiple of 128: the Skv edge), the train batch
                ("hubert_serve", 4, 16, 16, 80, 2048, 0, False),
                ("hubert_edge", 1, 16, 16, 80, 1040, 0, False),
                ("hubert_train", 2, 16, 16, 80, 2048, 0, False),
                # the mesh phase's llama3-8b 8 x 2,048 wave on a 2 x 2
                # mesh: a rank's 4 rows and its 16 / 4 heads
                ("mesh_llama_prefill", 4, 16, 4, 128, 2048, 0, True)]
FLASH_REPS = 6     # 10 until PR 29 (the mesh phase's time)
# backward launches: bf16 prep (delta, lse, zeroed dQ accumulator), the
# single pass, finish (dQ rounded; dK, dV slices summed); f32 delta,
# dK/dV, dQ
FLASH_BWD = 3
# dQ of two bf16 backwards on the same inputs, relative to its largest
# value: the single pass adds each KV tile's part into f32 in whatever
# order the blocks finish, so dQ may differ by f32 rounding, which can
# move a bf16 rounding by one ulp (2^-8 of the value) at most; dK and dV
# are summed in a fixed order and must be bitwise equal
FLASH_DQ_REPEAT_TOL = 2 ** -8


_T0 = time.perf_counter()


def emit(phase, **kw):
    """One JSON line; ``t``: seconds since the script started."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - _T0,
                      **kw}), flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ timing ------
_FLUSH = None


def device_ms(fn, reps=REPS):
    """Median device time of ``fn`` over ``reps`` runs: each run starts
    with a cold L2 (a 64 MB write) and behind a device spin long enough
    that the host enqueues the whole of ``fn`` before the start event
    fires."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, n=100, batches=5):
    """Host microseconds per call of ``fn`` (the wrapper's checks, its
    allocations and the launch), the device left to run behind: ``n``
    calls enqueued back to back after a synchronize, the host clock
    around them; the least of ``batches`` such runs, as the host's cores
    are shared and a run's mean moves with its neighbours."""
    fn()
    best = math.inf
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / n * 1e6


def bitwise_repeat(fn, first):
    """A second call of ``fn`` on the same inputs equals ``first`` bit for
    bit (the split kernels sum their partials in a fixed order)."""
    again = fn()
    torch.cuda.synchronize()
    return bool(torch.equal(again, first))


# ------------------------------------------------- paged decode attention -
def attention_case(b, h, hkv, d, bs, nb, dtype, seed, lengths="ragged",
                   shared=0):
    """Inputs as the runtime builds them: shuffled non-scratch blocks for
    each sequence's live range, scratch block 0 past it; kv_len ragged,
    holding 1 and a full table, or (``"tick"``) as a decode tick finds them
    in the last 32 rows of the table (2,049 to 2,080 after 2,048-token
    prompts).  With ``shared`` > 0 every table starts with the same
    ``shared`` blocks (a prefix-cache hit's aliasing) and kv_len is ragged
    past them (one row past the prefix, and a full table, among them)."""
    n_blocks = 1 + shared + b * (nb - shared)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    kp = torch.randn((n_blocks, bs, hkv, d), generator=g,
                     device="cuda").to(dtype)
    vp = torch.randn((n_blocks, bs, hkv, d), generator=g,
                     device="cuda").to(dtype)
    rng = np.random.default_rng(seed)
    if lengths == "tick":
        kv_len = rng.integers(nb * bs - 31, nb * bs + 1,
                              size=b).astype(np.int32)
    else:
        lo = shared * bs + 1
        kv_len = rng.integers(lo, nb * bs + 1, size=b).astype(np.int32)
        kv_len[0], kv_len[1] = lo, nb * bs
    perm = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = np.zeros((b, nb), np.int32)
    tables[:, :shared] = perm[:shared]
    used = shared
    for i in range(b):
        live = -(-int(kv_len[i]) // bs)
        tables[i, shared:live] = perm[used:used + live - shared]
        used += live - shared
    return (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(kv_len, device="cuda"))


def attention_bound(q, kp, tables, kv_len):
    """Least time for one call: each distinct pool row that some sequence
    reads below its kv_len read once (a block several tables name, once),
    q read and out written once, live table entries and kv_len read once;
    4 FLOP per (query head, live row, channel) of every sequence."""
    b, h, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    lens = kv_len.long()
    elt = q.element_size()
    live_blocks = int(((lens + bs - 1) // bs).sum())
    rows_of = {}        # pool block -> rows some sequence reads
    for tbl, n in zip(tables.cpu().tolist(), lens.cpu().tolist()):
        for j in range(-(-n // bs)):
            rows_of[tbl[j]] = max(rows_of.get(tbl[j], 0),
                                  min(bs, n - j * bs))
    nbytes = (2 * q.numel() * elt + 2 * sum(rows_of.values()) * hkv * d * elt
              + 4 * live_blocks + 4 * b)
    ops = 4 * int(lens.sum()) * h * d
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


# paged_decode_attention: the serve tick after 32-token prompts (3 pool
# blocks of 16), 1k context, llama3-8b's GQA 4:1 at head_dim 128, pool
# blocks of 128 and 256 rows, the serve tick after 2,048-token prompts
# (2,048 + 32 rows paged in blocks of 16) and its contiguous layout (2,080
# rows as identity-table blocks of 32: two TMA loads a 64-row tile), both
# with a decode tick's lengths; then the identity-table blocks of 1, 2 and
# 8 rows that contiguous caches of other lengths give (TMA boxes of fewer
# than 8 rows; the VLM's self-attention, 8 query heads per KV head); last
# the prefix cache's aliasing: every table names the same 48 prefix blocks
# (768 rows), then 14 private blocks each, lengths ragged past the prefix;
# last hymba-1.5b's decode (25 / 5 heads of 64) over its contiguous rings
# through identity tables: 8 slots of 48 rows (32 + 16), 1,024 (992 +
# 32), 1,992 (1,984 + 8, blocks of 8) and 2,048 (the window: 1,984 + 128,
# wrapped), then one slot of 2,048 (the ring check) and of 64 (the exact
# ring check's window, float32)
PAGED_SHAPES = [
    ("serve", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=3)),
    ("long", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=64)),
    ("gqa", dict(b=4, h=32, hkv=8, d=128, bs=16, nb=64)),
    ("bs128", dict(b=8, h=16, hkv=16, d=64, bs=128, nb=8)),
    ("bs256", dict(b=8, h=16, hkv=16, d=64, bs=256, nb=4)),
    ("serve_2048", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=130,
                        lengths="tick")),
    ("bs32", dict(b=8, h=16, hkv=16, d=64, bs=32, nb=65, lengths="tick")),
    ("bs1_g4", dict(b=2, h=16, hkv=4, d=128, bs=1, nb=301)),
    ("bs2", dict(b=4, h=16, hkv=16, d=64, bs=2, nb=150)),
    ("bs8_g8", dict(b=2, h=64, hkv=8, d=128, bs=8, nb=40)),
    ("shared", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=62, shared=48)),
    ("hymba_48", dict(b=8, h=25, hkv=5, d=64, bs=16, nb=3)),
    ("hymba_1024", dict(b=8, h=25, hkv=5, d=64, bs=256, nb=4)),
    ("hymba_1992", dict(b=8, h=25, hkv=5, d=64, bs=8, nb=249)),
    ("hymba_ring", dict(b=8, h=25, hkv=5, d=64, bs=256, nb=8,
                        lengths="tick")),
    ("hymba_ring_1", dict(b=1, h=25, hkv=5, d=64, bs=256, nb=8,
                          lengths="tick")),
    ("hymba_window_64", dict(b=1, h=25, hkv=5, d=64, bs=64, nb=1,
                             lengths="tick")),
    # the MoE phases': moonshot-v1-16b-a3b (16 / 16 heads of 128, G 1)
    # over 32 + 16 (3 blocks of 16, paged, or 48 contiguous rows as
    # identity blocks of 16) and 2,048 + 32 (130 blocks); grok-1-314b
    # (48 / 8 heads of 128, G 6) over 32 + 16
    ("moonshot_48", dict(b=8, h=16, hkv=16, d=128, bs=16, nb=3)),
    ("moonshot_2080", dict(b=8, h=16, hkv=16, d=128, bs=16, nb=130,
                           lengths="tick")),
    ("grok_48", dict(b=8, h=48, hkv=8, d=128, bs=16, nb=3)),
    # the mesh phase's (2 x 2, rules_for's table: each rank its 4 slots'
    # block of the cache and its heads): llama3-8b's 16 / 4 heads over 48
    # rows (32 + 16) and 2,064 (2,048 + 16, identity blocks of 16),
    # moonshot's 8 / 8 and grok's 24 / 4 over 48
    ("mesh_llama_48", dict(b=4, h=16, hkv=4, d=128, bs=16, nb=3)),
    ("mesh_llama_2064", dict(b=4, h=16, hkv=4, d=128, bs=16, nb=129,
                             lengths="tick")),
    ("mesh_moonshot_48", dict(b=4, h=8, hkv=8, d=128, bs=16, nb=3)),
    ("mesh_grok_48", dict(b=4, h=24, hkv=4, d=128, bs=16, nb=3)),
]
# the return_lse launch of paged_decode_attention (the sequence-sharded
# decode's partials): the mesh phase's forced kv_seq table cuts each
# cache's rows over the model axis, so a rank walks all heads (llama3-8b
# 32 / 8) over its 24 of 48 rows (identity blocks of 8) or 1,032 of
# 2,064; then the same with half the rows at kv_len 0 (a rank whose
# slice lies past the position: zeros and -inf, no NaN)
LSE_SHAPES = [
    ("mesh_seq_24", dict(b=4, h=32, hkv=8, d=128, bs=8, nb=3)),
    ("mesh_seq_1032", dict(b=4, h=32, hkv=8, d=128, bs=8, nb=129,
                           lengths="tick")),
    ("mesh_seq_24_empty", dict(b=4, h=32, hkv=8, d=128, bs=8, nb=3),
     "empty"),
    ("mesh_seq_1032_empty", dict(b=4, h=32, hkv=8, d=128, bs=8, nb=129),
     "empty"),
]


def sdpa_call(q, kp, vp, tables, kv_len):
    """The library yardstick of a decode-attention call: SDPA over the
    gathered cache (gather and head expansion done here, outside the
    returned call)."""
    b, nb, bs = q.shape[0], tables.shape[1], kp.shape[1]
    g = q.shape[1] // kp.shape[2]
    idx = tables.long()
    k_log = kp[idx].reshape(b, nb * bs, *kp.shape[2:]).transpose(1, 2)
    v_log = vp[idx].reshape(b, nb * bs, *vp.shape[2:]).transpose(1, 2)
    k_log = k_log.repeat_interleave(g, dim=1).contiguous()
    v_log = v_log.repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(nb * bs, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(q4, k_log, v_log,
                                              attn_mask=mask)
    return lib


def paged_row(pda, pda_ref, q, kp, vp, tables, kv_len):
    """One paged_decode_attention row: the kernel's output, and its worst
    error against the plain version, two calls bitwise equal, the
    wrapper's host us per call, kernel / plain / SDPA time, the bound."""
    out = pda(q, kp, vp, tables, kv_len)
    ref = pda_ref(q, kp, vp, tables, kv_len)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[q.dtype]
    ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
    lib = sdpa_call(q, kp, vp, tables, kv_len)
    lib_err = float((lib()[:, :, 0].float() - ref.float()).abs().max())
    row = {
        "dtype": str(q.dtype).split(".")[-1],
        "max_abs_err": err, "tol": tol, "ok": bool(ok),
        "ms": device_ms(lambda: pda(q, kp, vp, tables, kv_len)),
        "plain_ms": device_ms(lambda: pda_ref(q, kp, vp, tables, kv_len)),
        "library_ms": device_ms(lib),
        "library_max_abs_err": lib_err,
        "host_us": host_us(lambda: pda(q, kp, vp, tables, kv_len)),
        "repeat_bitwise": bitwise_repeat(
            lambda: pda(q, kp, vp, tables, kv_len), out),
    }
    row["bound_ms"], row["bound_by"] = attention_bound(q, kp, tables, kv_len)
    row["bound_us"] = row["bound_ms"] * 1e3
    return out, row


def phase_kernel(pda, pda_ref):
    """paged_decode_attention against its plain version at PAGED_SHAPES,
    float32 and bfloat16 (``paged_row``)."""
    rows = {}
    for si, (name, shp) in enumerate(PAGED_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            _, row = paged_row(pda, pda_ref, *attention_case(
                **shp, dtype=dtype, seed=100 + si))
            row = {"shape": name, **shp, **row}
            emit("kernel", kernel="paged_decode_attention", **row)
            if not (row["ok"] and row["repeat_bitwise"]):
                raise AssertionError(
                    f"paged_decode_attention {name} {dtype}: kernel vs "
                    f"plain max abs err {row['max_abs_err']} beyond "
                    f"{row['tol']}, or two calls on the same inputs differ")
            rows[(name, dtype)] = row
    return rows


def phase_kernel_lse(pda, pda_lse_ref):
    """The ``return_lse`` launch of paged_decode_attention against its
    plain version at LSE_SHAPES, float32 and bfloat16: the float32 output
    and the log-sum-exp each within TOL, a row at kv_len 0 exactly zeros
    and -inf, no NaN, two calls bitwise equal; kernel / plain / SDPA time
    (SDPA computes the output alone) and the bound (bytes: q read, the
    live K/V rows read once, the float32 output and lse written)."""
    rows = {}
    for si, (name, shp, *kind) in enumerate(LSE_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tables, kv_len = attention_case(
                **shp, dtype=dtype, seed=300 + si)
            if kind == ["empty"]:
                kv_len[::2] = 0
            out, lse = pda(q, kp, vp, tables, kv_len, return_lse=True)
            ref, ref_lse = pda_lse_ref(q, kp, vp, tables, kv_len)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            empty = kv_len == 0
            live = ~empty
            ok = bool(
                out.dtype == lse.dtype == torch.float32
                and not torch.isnan(out).any() and not torch.isnan(lse).any()
                and torch.equal(out[empty], torch.zeros_like(out[empty]))
                and bool((lse[empty] == float("-inf")).all())
                and torch.allclose(out, ref, rtol=tol, atol=tol)
                and torch.allclose(lse[live], ref_lse[live], rtol=tol,
                                   atol=tol))
            again = pda(q, kp, vp, tables, kv_len, return_lse=True)
            torch.cuda.synchronize()
            b, h, d = q.shape
            elt = q.element_size()
            # attention_bound's bytes with the output written in float32
            # and the lse added
            extra = b * h * d * (4 - elt) + 4 * b * h
            bound, by = attention_bound(q, kp, tables, kv_len)
            bound += extra / HBM_BYTES_S * 1e3 if by == "bytes" else 0.0
            row = {"shape": name, **shp, "empty_rows": int(empty.sum()),
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": float((out - ref).abs().max()),
                   "lse_max_abs_err": float(
                       (lse[live] - ref_lse[live]).abs().max()),
                   "tol": tol, "ok": ok,
                   "repeat_bitwise": bool(torch.equal(again[0], out)
                                          and torch.equal(again[1], lse)),
                   "ms": device_ms(lambda: pda(q, kp, vp, tables, kv_len,
                                               return_lse=True)),
                   "plain_ms": device_ms(lambda: pda_lse_ref(
                       q, kp, vp, tables, kv_len)),
                   "library_ms": device_ms(sdpa_call(q, kp, vp, tables,
                                                     kv_len)),
                   "host_us": host_us(lambda: pda(q, kp, vp, tables, kv_len,
                                                  return_lse=True)),
                   "bound_ms": bound, "bound_by": by}
            emit("kernel_lse", kernel="paged_decode_attention_lse", **row)
            if not (row["ok"] and row["repeat_bitwise"]):
                raise AssertionError(
                    f"paged_decode_attention lse {name} {dtype}: {row}")
            rows[(name, dtype)] = row
    return rows


# ------------------------------------------------------------- lora -------
def lora_case(m, k, n, r, dtype, seed):
    """x, W, A, B as the model hands them over: W in storage padded to
    whole 16-byte rows where N is no multiple of 8 (``pad_columns``, as
    ``mamba2.pad_storage`` keeps it), B compact (the wrapper copies it
    into padded storage in the call)."""
    from repro_torch.kernels.lora_matmul import pad_columns
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    a = torch.randn((k, r), generator=g, device="cuda") / k ** 0.5
    b = torch.randn((r, n), generator=g, device="cuda") * 0.1
    x, w, a, b = (t.to(dtype) for t in (x, w, a, b))
    return x, pad_columns(w), a, b


def lora_bound(m, k, n, r, dtype):
    """Least time for one call: x, W, A, B read once, the output written
    once; 2 FLOP per multiply-add of x @ W, x @ A and (x @ A) @ B."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = (m * k + k * n + k * r + r * n + m * n) * elt
    ops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def _rel_err(out, ref):
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def check_views(lm, lm_ref):
    """bf16 operands as views the wrapper takes but a contiguous tensor
    never gives: x a K slice of a wider buffer, W and B column slices
    (N = 1,020, no multiple of 8: the M > 16 kernel stores those rows
    itself, the row stride being no whole 16 bytes for a TMA store),
    forward and the backward's transposed views, at M 8 and 300."""
    for m in (8, 300):
        x, w, a, b = lora_case(m, 520, 1024, 16, torch.bfloat16, 290 + m)
        xv, wv, av, bv = x[:, :516], w[:516, :1020], a[:516], b[:, :1020]
        dy = torch.randn((m, 1024), device="cuda").to(torch.bfloat16)
        dyv = dy[:, :1020]
        errs = {
            "forward": _rel_err(lm(xv, wv, av, bv, LORA_SCALING),
                                lm_ref(xv, wv, av, bv, LORA_SCALING)),
            "dx": _rel_err(lm(dyv, wv.t(), bv.t(), av.t(), LORA_SCALING),
                           lm_ref(dyv, wv.t(), bv.t(), av.t(),
                                  LORA_SCALING))}
        emit("kernel_views", kernel="lora_matmul", M=m, K=516, N=1020,
             rel_tol=LORA_TOL[torch.bfloat16],
             **{f"{k}_rel_err": e for k, e in errs.items()})
        if max(errs.values()) > LORA_TOL[torch.bfloat16]:
            raise AssertionError(f"lora_matmul views at M {m}: {errs}")


def phase_kernel_lora(lm, lm_ref, fn_cls):
    """lora_matmul against its plain version at the main path's shapes,
    then its backward at the train shapes and at the decode shape (the
    transposed operands on the M <= 16 tile)."""
    rows = {}
    for si, (name, m, k, n, r) in enumerate(LORA_SHAPES):
        for dtype in lora_dtypes(name):
            x, w, a, b = lora_case(m, k, n, r, dtype, 200 + si)
            out = lm(x, w, a, b, LORA_SCALING)
            ref = lm_ref(x, w, a, b, LORA_SCALING)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            rel = _rel_err(out, ref)
            # the library yardstick: one product with the merged weight
            # (the merge is outside the timed call; the port never merges)
            merged = w + LORA_SCALING * (a @ b)
            row = {
                "shape": name, "M": m, "K": k, "N": n, "r": r,
                "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                "rel_err": rel, "rel_tol": LORA_TOL[dtype],
                "ms": device_ms(lambda: lm(x, w, a, b, LORA_SCALING)),
                "plain_ms": device_ms(
                    lambda: lm_ref(x, w, a, b, LORA_SCALING)),
                "library_ms": device_ms(lambda: x @ merged),
                "base_only_ms": device_ms(lambda: x @ w),
                "host_us": host_us(lambda: lm(x, w, a, b, LORA_SCALING)),
                "repeat_bitwise": bitwise_repeat(
                    lambda: lm(x, w, a, b, LORA_SCALING), out),
            }
            row["bound_ms"], row["bound_by"] = lora_bound(m, k, n, r, dtype)
            emit("kernel", kernel="lora_matmul", **row)
            if not rel <= LORA_TOL[dtype]:
                raise AssertionError(
                    f"lora_matmul {name} {dtype}: kernel vs plain error "
                    f"{rel} of the largest output, beyond {LORA_TOL[dtype]}")
            if not row["repeat_bitwise"]:
                raise AssertionError(f"lora_matmul {name} {dtype}: two calls "
                                     "on the same inputs differ")
            rows[(name, dtype)] = row
    check_views(lm, lm_ref)
    for name, m, k, n, r in LORA_SHAPES:
        if not lora_has_backward(name):
            continue
        for dtype in lora_dtypes(name):
            x, w, a, b = lora_case(m, k, n, r, dtype, 300)
            dy = torch.randn((m, n), device="cuda").to(dtype)
            xk, ak, bk = (t.clone().requires_grad_() for t in (x, a, b))
            got = torch.autograd.grad(
                fn_cls.apply(xk, w, ak, bk, LORA_SCALING),
                (xk, ak, bk), dy)
            xr, ar, br = (t.clone().requires_grad_() for t in (x, a, b))
            want = torch.autograd.grad(
                lm_ref(xr, w, ar, br, LORA_SCALING), (xr, ar, br), dy)
            errs = {g: _rel_err(u, v)
                    for g, u, v in zip(("dx", "da", "db"), got, want)}
            # bf16: the kernel path rounds t = s dY B^T and x A to bf16
            # before the rank-r products, autograd of the plain version
            # only at the end: a bf16 ulp of those, as in the forward
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            emit("kernel_backward", kernel="lora_matmul", shape=name,
                 M=m, dtype=str(dtype).split(".")[-1], rel_tol=tol,
                 **{f"{g}_rel_err": e for g, e in errs.items()})
            if max(errs.values()) > tol:
                raise AssertionError(
                    f"LoRAMatmulFn {name} {dtype}: {errs} beyond {tol}")
    return rows


# --------------------------------------------------- segmented lora ------
# (name, M, K, N, r, slots, rows per sequence): qwen1.5-0.5b's q/k/v/o at
# decode (8 slots, one row each) with 1, 4 and 8 adapter slots, its
# prefill waves (8 sequences of 32, 992 and 2,048 tokens, a slot per
# sequence), a ragged shape with a slot per row, llama3-8b's decode
# projections (k/v: N 1024; q/o: N 4096), qwen's decode at 16 slots, and
# the 4-tenant suffix wave (8 x 224 over the cached prefix); then the
# 4-tenant fabric's (traffic (l)): a replica's decode at 4 slots and its
# prefill waves of 1 to 4 requests of 32
SEG_SHAPES = [("decode", 8, 1024, 1024, 16, 4, 1),
              ("decode_a1", 8, 1024, 1024, 16, 1, 1),
              ("decode_a8", 8, 1024, 1024, 16, 8, 1),
              ("prefill", 256, 1024, 1024, 16, 4, 32),
              ("prefill_992", 7936, 1024, 1024, 16, 4, 992),
              ("prefill_2048", 16384, 1024, 1024, 16, 4, 2048),
              ("ragged", 1000, 1000, 2816, 16, 4, 1),
              ("llama_decode_kv", 8, 4096, 1024, 16, 4, 1),
              ("llama_decode", 8, 4096, 4096, 16, 4, 1),
              ("decode_m16", 16, 1024, 1024, 16, 4, 1),
              ("suffix_224", 1792, 1024, 1024, 16, 4, 224),
              ("fabric_decode_4", 4, 1024, 1024, 16, 4, 1),
              ("fabric_prefill_32", 32, 1024, 1024, 16, 4, 32),
              ("fabric_prefill_64", 64, 1024, 1024, 16, 4, 32),
              ("fabric_prefill_96", 96, 1024, 1024, 16, 4, 32),
              ("fabric_prefill_128", 128, 1024, 1024, 16, 4, 32),
              # moonshot-v1-16b-a3b's 4-tenant decode and 8 x 32 wave
              ("moe_decode", 8, 2048, 2048, 16, 4, 1),
              ("moe_prefill", 256, 2048, 2048, 16, 4, 32)]
SEG_REPS = 30


def seg_case(m, k, n, r, na, seq, dtype, seed):
    """Inputs as the registry and the model give them: stacks [NA, K, r]
    / [NA, r, N]; one slot per sequence of ``seq`` rows, drawn over every
    slot and -1, each present where the sequences allow."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    a = torch.randn((na, k, r), generator=g, device="cuda") / k ** 0.5
    b = torch.randn((na, r, n), generator=g, device="cuda") * 0.1
    ns = m // seq
    idx = np.random.default_rng(seed).integers(-1, na, ns).astype(np.int32)
    idx[:min(ns, na + 1)] = np.arange(-1, na)[:ns]
    return tuple(t.to(dtype) for t in (x, w, a, b)) + (
        torch.tensor(np.repeat(idx, seq), device="cuda"),)


def seg_bound(m, k, n, r, idx, dtype):
    """Least time for one call: x, W, the stacks of the slots the rows
    use, the row index read once, the output written once; 2 FLOP per
    multiply-add of x @ W and of each adapter row's own x @ A and
    (x @ A) @ B."""
    elt = torch.empty((), dtype=dtype).element_size()
    used = int(torch.unique(idx[idx >= 0]).numel())
    rows = int((idx >= 0).sum())
    nbytes = (m * k + k * n + used * (k * r + r * n) + m * n) * elt + 4 * m
    ops = 2 * m * k * n + 2 * rows * (k * r + r * n)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_seg(seg, seg_ref, lm):
    """segmented_lora_matmul against its plain version at the main path's
    shapes, rows mixing every slot and -1 (error relative to the largest
    output).  In bf16 also: each row bitwise equal to lora_matmul with
    its own slot's A and B at the same M, each -1 row to lora_matmul with
    B = 0, and an output that does not move when a slot no row uses
    holds 1e6.  Times: kernel, plain version, lora_matmul of one adapter
    at the same M, and the base product alone (``torch.matmul``: no
    PyTorch call computes per-row adapters; the fused kernel cannot beat
    it)."""
    rows_out = {}
    for si, (name, m, k, n, r, na, seq) in enumerate(SEG_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, a, b, idx = seg_case(m, k, n, r, na, seq, dtype, 500 + si)
            out = seg(x, w, a, b, idx, LORA_SCALING)
            ref = seg_ref(x, w, a, b, idx, LORA_SCALING)
            torch.cuda.synchronize()
            rel = _rel_err(out, ref)
            row = {
                "shape": name, "M": m, "K": k, "N": n, "r": r, "slots": na,
                "rows_per_sequence": seq, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "rel_err": rel, "rel_tol": LORA_TOL[dtype],
            }
            ok = rel <= LORA_TOL[dtype]
            if dtype == torch.bfloat16:
                # every row against lora_matmul of its own slot, same M
                same = True
                for sl in range(-1, na):
                    bs = b[sl] if sl >= 0 else torch.zeros_like(b[0])
                    one = lm(x, w, a[max(sl, 0)], bs, LORA_SCALING)
                    mask = idx == sl
                    same &= bool(torch.equal(out[mask], one[mask]))
                # a slot no row reads may hold anything finite
                idx2 = torch.where(idx == na - 1, -1, idx)
                clean = seg(x, w, a, b, idx2, LORA_SCALING)
                a2, b2 = a.clone(), b.clone()
                a2[na - 1], b2[na - 1] = 1e6, 1e6
                poisoned = seg(x, w, a2, b2, idx2, LORA_SCALING)
                no_leak = bool(torch.equal(poisoned, clean)
                               and torch.isfinite(poisoned).all())
                row.update(rows_bitwise_lora_matmul=same,
                           poison_1e6_no_leak=no_leak)
                ok = ok and same and no_leak
                del clean, poisoned, a2, b2
            row.update(
                ms=device_ms(lambda: seg(x, w, a, b, idx, LORA_SCALING),
                             SEG_REPS),
                plain_ms=device_ms(
                    lambda: seg_ref(x, w, a, b, idx, LORA_SCALING), SEG_REPS),
                lora_matmul_ms=device_ms(
                    lambda: lm(x, w, a[0], b[0], LORA_SCALING), SEG_REPS),
                library_ms=device_ms(lambda: x @ w, SEG_REPS),
                library="base-only torch.matmul (a floor: no PyTorch call "
                        "computes the per-row adapters)",
                host_us=host_us(lambda: seg(x, w, a, b, idx, LORA_SCALING)),
                repeat_bitwise=bitwise_repeat(
                    lambda: seg(x, w, a, b, idx, LORA_SCALING), out))
            ok = ok and row["repeat_bitwise"]
            row["bound_ms"], row["bound_by"] = seg_bound(m, k, n, r, idx,
                                                         dtype)
            emit("kernel", kernel="segmented_lora_matmul", **row)
            if not ok:
                raise AssertionError(
                    f"segmented_lora_matmul {name} {dtype}: error {rel} of "
                    f"the largest output (tolerance {LORA_TOL[dtype]}), "
                    f"bitwise rows {row.get('rows_bitwise_lora_matmul')}, "
                    f"poison {row.get('poison_1e6_no_leak')}, repeat "
                    f"bitwise {row['repeat_bitwise']}")
            rows_out[(name, dtype)] = row
            del x, w, a, b, idx, out, ref
            torch.cuda.empty_cache()
    return rows_out


# ------------------------------------------------------- flash attention --
def causal_pairs(s, window, causal=True):
    """Allowed (query, key) pairs of one head of length s: all s^2 when
    not causal (no FLASH_SHAPES row windows a non-causal mask)."""
    if not causal:
        return s * s
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound(b, h, hkv, d, s, window, dtype, backward, causal=True):
    """Least time for one call.  Forward: q, k, v read, o and the f32 lse
    written; 4 FLOP per allowed (query, key) pair and channel (q k^T and
    P V).  Backward: q, k, v, o, dO and lse read, dq, dk, dv written;
    10 FLOP per pair and channel (q k^T again, dP, dV, dQ, dK)."""
    elt = torch.empty((), dtype=dtype).element_size()
    q_elems, kv_elems = b * h * s * d, b * hkv * s * d
    if backward:
        nbytes = (3 * q_elems + 2 * kv_elems) * elt + 4 * b * h * s \
            + (q_elems + 2 * kv_elems) * elt
        ops = 10 * d * causal_pairs(s, window, causal) * b * h
    else:
        nbytes = (2 * q_elems + 2 * kv_elems) * elt + 4 * b * h * s
        ops = 4 * d * causal_pairs(s, window, causal) * b * h
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_flash(fa):
    """flash_attention forward and backward against their plain versions
    (the dense f32 softmax and autograd of it) at the main path's
    shapes, inputs in the model's [B, S, H, D] layout passed as
    [B, H, S, D] views as the model passes them.  Errors relative to the
    largest output or gradient.  The backward runs twice on the same
    inputs: dK and dV bitwise equal, dQ within FLASH_DQ_REPEAT_TOL.
    Times: kernel, plain version, and scaled_dot_product_attention
    (forward; for the backward, autograd of its output) as the library
    yardstick, never called by the port; achieved TFLOP/s (the bound's
    operations over the time) of kernel and library."""
    rows = {}
    for si, (name, b, h, hkv, d, s, w, causal) in enumerate(FLASH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(400 + si)

            def draw(heads):
                return torch.randn((b, s, heads, d), generator=g,
                                   device="cuda").to(dtype).transpose(1, 2)

            q, k, v, do = draw(h), draw(hkv), draw(hkv), draw(h)
            kw = dict(causal=causal, window=w)
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            out = o
            ref = fa.flash_attention_ref(q, k, v, **kw)
            got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            again = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            want = fa.flash_attention_grad_ref(q, k, v, do, **kw)
            torch.cuda.synchronize()
            repeat = {"dk_bitwise": bool(torch.equal(got[1], again[1])),
                      "dv_bitwise": bool(torch.equal(got[2], again[2])),
                      "dq_rel_diff": _rel_err(again[0], got[0])}
            del again
            tol = TOL[dtype]
            err = _rel_err(out, ref)
            gerr = {n: _rel_err(x, y)
                    for n, x, y in zip(("dq", "dk", "dv"), got, want)}
            # the library yardstick: SDPA on the same views
            if w:
                qpos = torch.arange(s, device="cuda")
                mask = (qpos[None, :] <= qpos[:, None]) \
                    & (qpos[:, None] - qpos[None, :] < w)
                lib_kw = dict(attn_mask=mask)
            else:
                lib_kw = dict(is_causal=causal)

            def lib(q_, k_, v_):
                return F.scaled_dot_product_attention(
                    q_, k_, v_, enable_gqa=h != hkv, **lib_kw)

            lib_err = _rel_err(lib(q, k, v), ref)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            lib_out = lib(qs, ks, vs)
            row = {
                "shape": name, "B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                "window": w, "causal": causal,
                "dtype": str(dtype).split(".")[-1],
                "rel_err": err, "rel_tol": tol,
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                **{f"{n}_rel_err": e for n, e in gerr.items()},
                "bwd_max_abs_err": max(float((x.float() - y.float()).abs()
                                             .max())
                                       for x, y in zip(got, want)),
                "library_rel_err": lib_err,
                "ms": device_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                                FLASH_REPS),
                "plain_ms": device_ms(
                    lambda: fa.flash_attention_ref(q, k, v, **kw),
                    FLASH_REPS),
                "library_ms": device_ms(lambda: lib(q, k, v), FLASH_REPS),
                "bwd_ms": device_ms(
                    lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                        **kw), FLASH_REPS),
                # the plain backward recomputes its forward under autograd
                "bwd_plain_ms": device_ms(
                    lambda: fa.flash_attention_grad_ref(q, k, v, do, **kw),
                    FLASH_REPS),
                "bwd_library_ms": device_ms(
                    lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                retain_graph=True),
                    FLASH_REPS),
            }
            row["bound_ms"], row["bound_by"] = flash_bound(
                b, h, hkv, d, s, w, dtype, backward=False, causal=causal)
            row["bwd_bound_ms"], row["bwd_bound_by"] = flash_bound(
                b, h, hkv, d, s, w, dtype, backward=True, causal=causal)
            # achieved rate: the bound's operations over the kernel time
            ops = 4 * d * causal_pairs(s, w, causal) * b * h
            row["tflops"] = ops / row["ms"] * 1e-9
            row["bwd_tflops"] = 2.5 * ops / row["bwd_ms"] * 1e-9
            row["library_tflops"] = ops / row["library_ms"] * 1e-9
            row["bwd_library_tflops"] = 2.5 * ops / row["bwd_library_ms"] \
                * 1e-9
            row.update(backward_twice=repeat,
                       dq_repeat_tol=FLASH_DQ_REPEAT_TOL)
            emit("kernel", kernel="flash_attention", **row)
            if not (err <= tol and max(gerr.values()) <= tol):
                raise AssertionError(
                    f"flash_attention {name} {dtype}: forward {err}, "
                    f"backward {gerr} of the largest value, beyond {tol}")
            if not (repeat["dk_bitwise"] and repeat["dv_bitwise"]
                    and repeat["dq_rel_diff"] <= FLASH_DQ_REPEAT_TOL):
                raise AssertionError(
                    f"flash_attention {name} {dtype}: two backwards on the "
                    f"same inputs differ: {repeat}")
            rows[(name, dtype)] = row
            del q, k, v, do, out, ref, o, lse, got, want, qs, ks, vs, lib_out
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- ssd scan ---
# (name, B, S, H, P, N, random init_state, inputs): mamba2-780m's prefill
# (one request, 48 heads of P = 64, N = 128) at the serve runs' prompt
# lengths and 4,096, a length that is no multiple of any chunk, two
# requests continuing from a state, and hymba-1.5b's heads (H = 50,
# N = 16), with ``tests/test_kernels.py``'s distributions; then two of
# them with dt and a as the mixer makes them, where a chunk's decay
# leaves the state carried into the next one visible (with the test
# distributions it decays by about e^-50 over one 64-row chunk)
SSD_SHAPES = [("mamba_32", 1, 32, 48, 64, 128, False, "test"),
              ("mamba_992", 1, 992, 48, 64, 128, False, "test"),
              ("mamba_2048", 1, 2048, 48, 64, 128, False, "test"),
              ("mamba_4096", 1, 4096, 48, 64, 128, False, "test"),
              ("ragged_1000", 1, 1000, 48, 64, 128, False, "test"),
              ("init_b2_512", 2, 512, 48, 64, 128, True, "test"),
              ("hymba_2048", 1, 2048, 50, 64, 16, False, "test"),
              ("mixer_2048", 1, 2048, 48, 64, 128, False, "mixer"),
              ("mixer_init_b2_512", 2, 512, 48, 64, 128, True, "mixer")]
SSD_CHUNK = 256     # the plain version's chunk (mamba2-780m's ssm_chunk)
SSD_TOL_Y = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_TOL_STATE = 1e-4
SSD_REPS = 10
# ssd_scan launches per call: the prep pass (C B^T once per chunk), then
# the chunk-parallel scan
SSD_LAUNCHES = 2


def ssd_case(b, s, h, p, n, init, dtype, seed, inputs="test"):
    """Inputs as the mixer gives them: x and B/C slices of one conv output
    ``[B, S, H*P + 2N]`` in x's dtype (x a strided view, B and C cast to
    float32: a copy in bf16, the view itself in float32).  ``"test"``:
    dt = softplus of a normal, a = -exp(0.3 * normal), the distributions
    of ``tests/test_kernels.py::test_ssd_scan``; ``"mixer"``: dt =
    softplus(normal + dt_bias) and a = -exp(A_log) as ``mamba2.init_ssm``
    sets them (dt_bias = log(expm1(0.01)), A_log = log(linspace(1, 16)))."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    di = h * p
    conv = torch.randn((b, s, di + 2 * n), generator=g, device="cuda")
    conv[..., di:] *= 0.3
    conv = conv.to(dtype)
    x = conv[..., :di].reshape(b, s, h, p)
    bm = conv[..., di:di + n].float()
    cm = conv[..., di + n:].float()
    z = torch.randn((b, s, h), generator=g, device="cuda")
    if inputs == "mixer":
        dt = F.softplus(z + math.log(math.expm1(0.01)))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = F.softplus(z)
        a = -torch.exp(torch.randn((h,), generator=g, device="cuda") * 0.3)
    st = torch.randn((b, h, p, n), generator=g, device="cuda") if init \
        else None
    return x, dt, a, bm, cm, st


def ssd_bound(b, s, h, p, n, init, dtype, chunk=SSD_CHUNK):
    """Least time for one call: x, dt, a, B, C (and the initial state)
    read once, y and the final state written once; the float32 operations
    of the chunked form at the reference's chunk (2 FLOP per multiply-add):
    C B^T over each chunk's causal (i >= j) pairs once per (batch, chunk),
    as the single B/C group shares it across heads, and per head the
    scores' product with x over those pairs, C state^T and the state
    update in full."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * b * s * h * p * elt + 4 * (b * s * h + h + 2 * b * s * n) \
        + 4 * b * h * p * n * (2 if init else 1)
    shared = per_head = 0
    for lo in range(0, s, chunk):
        r = min(chunk, s - lo)
        pairs = r * (r + 1) // 2
        shared += 2 * pairs * n
        per_head += 2 * pairs * p + 4 * r * p * n
    ops = b * shared + b * h * per_head
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_ssd(ssd):
    """ssd_scan against its plain version (``ssd_chunked``'s arithmetic at
    the reference's chunk of 256) at the prefill shapes, x in float32 and
    bfloat16: y and the final state relative to their largest values.
    Times: kernel, plain version; no PyTorch call computes an SSD scan.
    Then the backward kernel (``kernel_ssd_bwd``)."""
    rows = {}
    for si, (name, b, s, h, p, n, init, inputs) in enumerate(SSD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm, st = ssd_case(b, s, h, p, n, init, dtype,
                                            600 + si, inputs)
            y, fin = ssd.ssd_scan(x, dt, a, bm, cm, init_state=st)
            yr, finr = ssd.ssd_scan_ref(x, dt, a, bm, cm, chunk=SSD_CHUNK,
                                        init_state=st)
            torch.cuda.synchronize()
            ey, es = _rel_err(y, yr), _rel_err(fin, finr)
            finite = bool(torch.isfinite(y).all() and torch.isfinite(fin).all())
            row = {
                "shape": name, "B": b, "S": s, "H": h, "P": p, "N": n,
                "init_state": init, "inputs": inputs,
                "dtype": str(dtype).split(".")[-1],
                "x_strides": list(x.stride()),
                "y_rel_err": ey, "y_rel_tol": SSD_TOL_Y[dtype],
                "state_rel_err": es, "state_rel_tol": SSD_TOL_STATE,
                "max_abs_err": float((y.float() - yr.float()).abs().max()),
                "state_max_abs_err": float((fin - finr).abs().max()),
                "finite": finite,
                "ms": device_ms(lambda: ssd.ssd_scan(x, dt, a, bm, cm,
                                                     init_state=st),
                                SSD_REPS),
                "plain_ms": device_ms(
                    lambda: ssd.ssd_scan_ref(x, dt, a, bm, cm,
                                             chunk=SSD_CHUNK, init_state=st),
                    SSD_REPS),
                "library_ms": None,
                "host_us": host_us(lambda: ssd.ssd_scan(
                    x, dt, a, bm, cm, init_state=st), 20),
            }
            y2, fin2 = ssd.ssd_scan(x, dt, a, bm, cm, init_state=st)
            torch.cuda.synchronize()
            row["repeat_bitwise"] = bool(torch.equal(y2, y)
                                         and torch.equal(fin2, fin))
            row["bound_ms"], row["bound_by"] = ssd_bound(b, s, h, p, n, init,
                                                         dtype)
            emit("kernel", kernel="ssd_scan", **row)
            if not (finite and ey <= SSD_TOL_Y[dtype] and es <= SSD_TOL_STATE
                    and row["repeat_bitwise"]):
                raise AssertionError(
                    f"ssd_scan {name} {dtype}: y {ey}, state {es} of the "
                    "largest value, beyond tolerance (or not finite), or two "
                    "calls on the same inputs differ")
            rows[(name, dtype)] = row
            del x, dt, a, bm, cm, st, y, fin, yr, finr, y2, fin2
            torch.cuda.empty_cache()
    rows.update(kernel_ssd_bwd(ssd))
    return rows


# (name, B, S, H, P, N, random init_state and d(final_state), inputs):
# the training shapes of the SSM co-training phases, mamba2-780m (48 heads
# of 64, N 128) and hymba-1.5b (50 heads of 64, N 16) at the combined runs'
# 4 x 32 rows and at 4 x 2,048; then a length that is no multiple of the
# 64-row chunk from a random state with a gradient on the final state, and
# the test distributions (a decay of ~e^-50 a chunk) at 2,048
# (name, B, S, H, P, N, init_state and d(final_state), inputs): mamba2 and
# hymba at the co-training ticks' train batches (4 x 2,048 and 4 x 32, and
# hymba's 4 x 1,984 of the combined_ssm run at 1,984 tokens) and the
# training CLI's (4 x 256); a ragged length from a state; the test
# distributions.  Every (B, S, H, P, N, dtype) the SSM phases launch the
# backward at has its row (SsdBwdShapeTap)
SSD_BWD_SHAPES = [
    ("bwd_mamba_4x2048", 4, 2048, 48, 64, 128, False, "mixer"),
    ("bwd_mamba_4x32", 4, 32, 48, 64, 128, False, "mixer"),
    ("bwd_hymba_4x2048", 4, 2048, 50, 64, 16, False, "mixer"),
    ("bwd_hymba_4x32", 4, 32, 50, 64, 16, False, "mixer"),
    ("bwd_hymba_4x1984", 4, 1984, 50, 64, 16, False, "mixer"),
    ("bwd_mamba_4x256", 4, 256, 48, 64, 128, False, "mixer"),
    ("bwd_hymba_4x256", 4, 256, 50, 64, 16, False, "mixer"),
    ("bwd_ragged_init_2x1000", 2, 1000, 48, 64, 128, True, "mixer"),
    ("bwd_test_1x2048", 1, 2048, 48, 64, 128, False, "test")]
SSD_BWD_CHUNK = 64    # the plain backward at the kernel's own chunk
SSD_BWD_GRADS = ("dx", "ddt", "da", "dB", "dC", "dinit")
# kernel vs plain, relative to each gradient's largest magnitude: float32
# sums over 64 positions, P and N in another order (and da over every
# position); dx in bf16 rounds once more (2^-8)
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_REPS = 5


def ssd_bwd_bound(b, s, h, p, n, init, dtype):
    """Least time for one backward call: x, dy, dt, a, B, C (and the
    entering state and d(final_state)) read once, dx, ddt, da, dB, dC
    (and d(init_state)) written once; the float32 operations of the
    chunk-wise backward at the kernel's 64-row chunk, counting what this
    length needs (2 FLOP per multiply-add): per (batch, chunk, head) the
    chunk's own state and reverse term, B G^T, x G and dy E (each 2 r P N
    over the chunk's r rows) and dy x^T and scores^T dy over the causal
    pairs (2 P each); per (batch, chunk) C B^T, dCB B and dCB^T C over
    the causal pairs (2 N each).  Returns (ms at float32's 67 TFLOP/s or
    the bytes, what bounds it, the FLOP, ms as 3xTF32: three TF32
    products for each float32 one at 495 TFLOP/s, or the bytes)."""
    elt = torch.empty((), dtype=dtype).element_size()
    io = 2 if init else 0
    nbytes = 3 * b * s * h * p * elt + 4 * (2 * b * s * h + 2 * h
                                            + 4 * b * s * n) \
        + 4 * b * h * p * n * io
    per_head = shared = 0
    for lo in range(0, s, SSD_BWD_CHUNK):
        r = min(SSD_BWD_CHUNK, s - lo)
        pairs = r * (r + 1) // 2
        per_head += 10 * r * p * n + 4 * pairs * p
        shared += 6 * pairs * n
    ops = b * h * per_head + b * shared
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[torch.float32]
    t_tc = max(t_bytes, 3 * ops / PEAK_TF32_S)
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), ops, t_tc * 1e3


def bwd_launches(ssd, b, s, h, p, n, init=False):
    """Launches of one ssd_scan backward call on this card (its plan)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return len(ssd.bwd_plan(b, s, h, p, n, init, sms).launches)


def arch_bwd_launches(get_config, arch, b, s):
    """Launches of one ssd_scan backward call of ``arch``'s SSM layers
    over a b x s train batch."""
    from repro_torch.kernels import ssd_scan as ssd
    cfg = get_config(arch)
    return bwd_launches(ssd, b, s, cfg.ssm_n_heads, cfg.ssm_head_dim,
                        cfg.ssm_state)


def kernel_ssd_bwd(ssd):
    """The ssd_scan backward kernel against ``ssd_scan_bwd_ref`` at the
    kernel's chunk, x (and dy) float32 and bfloat16: every gradient
    relative to its largest magnitude, two calls bitwise equal, kernel /
    plain time, each launch's device us (torch.profiler), host us; then
    autograd through ``ssd_scan`` on CUDA
    tensors reaches the kernel (``ssd_scan_bwd.launches``).  No PyTorch
    call computes the function."""
    rows = {}
    for si, (name, b, s, h, p, n, init, inputs) in enumerate(SSD_BWD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm, st = ssd_case(b, s, h, p, n, init, dtype,
                                            800 + si, inputs)
            g = torch.Generator(device="cuda").manual_seed(900 + si)
            dy = torch.randn((b, s, h, p), generator=g,
                             device="cuda").to(dtype)
            dfin = torch.randn((b, h, p, n), generator=g, device="cuda") \
                if init else None

            def run():
                return ssd.ssd_scan_bwd(x, dt, a, bm, cm, dy, dfin,
                                        init_state=st)

            def plain():
                return ssd.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dfin,
                                            chunk=SSD_BWD_CHUNK,
                                            init_state=st)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            want = plain()
            again = run()
            torch.cuda.synchronize()
            errs, finite = {}, True
            for gname, u, v in zip(SSD_BWD_GRADS, got, want):
                if v is None:
                    continue
                finite &= bool(torch.isfinite(u).all())
                errs[gname] = _rel_err(u, v)
            tol = {gname: SSD_BWD_TOL[dtype] if gname == "dx"
                   else SSD_BWD_TOL[torch.float32] for gname in errs}
            bitwise = all(torch.equal(u, v) for u, v in zip(got, again)
                          if u is not None)
            bound_ms, bound_by, ops, tc_ms = ssd_bwd_bound(b, s, h, p, n,
                                                           init, dtype)
            row = {
                "shape": name, "B": b, "S": s, "H": h, "P": p, "N": n,
                "init_state_and_dfinal": init, "inputs": inputs,
                "dtype": str(dtype).split(".")[-1],
                **{f"{k}_rel_err": e for k, e in errs.items()},
                "rel_tol": tol, "finite": finite,
                "max_abs_err": max(float((u.float() - v.float()).abs().max())
                                   for u, v in zip(got, want)
                                   if v is not None),
                "repeat_bitwise": bitwise,
                "workspace_and_outputs_peak_bytes": peak,
                "ms": device_ms(run, SSD_BWD_REPS),
                "plain_ms": device_ms(plain, SSD_BWD_REPS),
                "library_ms": None,
                "host_us": host_us(run, 20),
                "us_by_kernel": _kernel_us(run),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_3xtf32_ms": tc_ms, "gflop": ops / 1e9,
                "launches_a_call": bwd_launches(ssd, b, s, h, p, n, init),
            }
            emit("kernel", kernel="ssd_scan_backward", **row)
            if not (finite and bitwise
                    and all(errs[k] <= tol[k] for k in errs)):
                raise AssertionError(
                    f"ssd_scan_bwd {name} {dtype}: {errs} beyond {tol}, not "
                    "finite, or two calls on the same inputs differ")
            rows[(name, dtype)] = row
            del x, dt, a, bm, cm, st, dy, dfin, got, want, again
            torch.cuda.empty_cache()
    # autograd through the wrapper on CUDA tensors: the backward kernel,
    # never a plain version; chained (from a state) and a single chunk
    for b, s, init in ((2, 100, True), (4, 32, False)):
        x, dt, a, bm, cm, st = ssd_case(b, s, 48, 64, 128, init,
                                        torch.float32, 700, "mixer")
        ins = [t.detach().clone().requires_grad_()
               for t in (x, dt, a, bm, cm, st) if t is not None]
        _reset(ssd.ssd_scan, ssd.ssd_scan_bwd)
        y, fin = ssd.ssd_scan(*ins[:5], init_state=ins[5] if init else None)
        (y.square().sum() + fin.sum()).backward()
        torch.cuda.synchronize()
        launched = (ssd.ssd_scan.launches, ssd.ssd_scan_bwd.launches)
        _reset(ssd.ssd_scan, ssd.ssd_scan_bwd)
        want = ssd.ssd_scan_bwd_ref(x, dt, a, bm, cm, 2 * y.detach(),
                                    torch.ones_like(fin),
                                    chunk=SSD_BWD_CHUNK, init_state=st)
        errs = {k: _rel_err(t.grad, w)
                for k, t, w in zip(SSD_BWD_GRADS, ins, want)}
        derived = (SSD_LAUNCHES, bwd_launches(ssd, b, s, 48, 64, 128, init))
        emit("kernel_grad_check", kernel="ssd_scan", batch=[b, s],
             init_state=init, launches=launched, launches_derived=derived,
             **{f"{k}_rel_err": e for k, e in errs.items()})
        if launched != derived \
                or max(errs.values()) > SSD_BWD_TOL[torch.float32]:
            raise AssertionError(f"ssd_scan autograd on the card ({b} x "
                                 f"{s}): launches {launched}, derived "
                                 f"{derived}, errors {errs}")
    return rows


# ------------------------------------------- contiguous decode attention --
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 20     # 4 whole units of 4 dense blocks and a cross block
# decode_attention: (name, B, H, Hkv, D, S, layout, lengths) -- the VLM's
# cross-attention at decode (8 slots over 1,601 vision tokens, K/V the
# [B, T, Hkv, D] projection's transposed view), the same with ragged
# lengths and an empty row, then tests/test_kernels.py's three shapes
# (head-major contiguous caches, lengths from 1 to S)
DECODE_SHAPES = [("cross", 8, 64, 8, 128, 1601, "view", "full"),
                 ("cross_ragged", 8, 64, 8, 128, 1601, "view", "ragged"),
                 ("test_512", 2, 8, 2, 64, 512, "contiguous", "ragged"),
                 ("test_300", 3, 4, 4, 128, 300, "contiguous", "ragged"),
                 ("test_1024", 1, 16, 2, 64, 1024, "contiguous", "ragged")]


def decode_case(b, h, hkv, d, s, layout, lengths, dtype, seed):
    """q [B, H, D]; K/V [B, Hkv, S, D] as the model passes them (the
    transposed view of [B, S, Hkv, D]) or contiguous; kv_len all S, or
    ragged from 1 to S with the last row S (``cross_ragged``: the first
    row 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    shape = (b, s, hkv, d) if layout == "view" else (b, hkv, s, d)
    k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    if layout == "view":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    rng = np.random.default_rng(seed)
    kv_len = np.full(b, s, np.int32)
    if lengths == "ragged":
        kv_len[:-1] = rng.integers(1, s + 1, size=b - 1)
        if layout == "view":
            kv_len[0] = 0
    return q, k, v, torch.tensor(kv_len, device="cuda")


def decode_bound(q, k, kv_len):
    """Least time for one call: K/V rows up to kv_len read once, q read
    and out written once, kv_len read once; 4 FLOP per (query head, live
    row, channel)."""
    b, h, d = q.shape
    hkv, elt = k.shape[1], q.element_size()
    live = int(kv_len.long().sum())
    nbytes = 2 * q.numel() * elt + 2 * live * hkv * d * elt + 4 * b
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 4 * live * h * d / PEAK_OPS_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_decode(dattn, dattn_ref):
    """decode_attention against its plain version, float32 and bfloat16,
    at DECODE_SHAPES: the worst error (a kv_len == 0 row must be exactly
    zero), kernel / plain / SDPA time, the bound."""
    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    rows = {}
    for si, (name, b, h, hkv, d, s, layout, lengths) in \
            enumerate(DECODE_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kv_len = decode_case(b, h, hkv, d, s, layout, lengths,
                                          dtype, 800 + si)
            out = dattn(q, k, v, kv_len)
            ref = dattn_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = TOL[dtype]
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            empty = kv_len == 0
            zero_rows_exact = bool((out[empty] == 0).all())
            # the library yardstick: SDPA over the same K/V, masked at
            # kv_len (GQA natively where this PyTorch has it, else K/V
            # repeated to H heads outside the timed call)
            q4 = q[:, :, None, :]
            mask = (torch.arange(s, device="cuda")[None, :]
                    < kv_len[:, None])[:, None, None, :]
            if gqa:
                kl, vl, extra = k, v, {"enable_gqa": True}
            else:
                kl = k.repeat_interleave(h // hkv, dim=1)
                vl = v.repeat_interleave(h // hkv, dim=1)
                extra = {}

            def lib():
                return F.scaled_dot_product_attention(
                    q4, kl, vl, attn_mask=mask, **extra)

            live = ~empty            # SDPA gives NaN on an all-masked row
            lib_err = float((lib()[live, :, 0].float()
                             - ref[live].float()).abs().max())
            row = {
                "shape": name, "B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                "layout": layout, "lengths": lengths,
                "k_strides": list(k.stride()),
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "tol": tol, "ok": bool(ok),
                "empty_rows": int(empty.sum()),
                "empty_rows_exactly_zero": zero_rows_exact,
                "ms": device_ms(lambda: dattn(q, k, v, kv_len)),
                "plain_ms": device_ms(lambda: dattn_ref(q, k, v, kv_len)),
                "library_ms": device_ms(lib),
                "host_us": host_us(lambda: dattn(q, k, v, kv_len)),
                "repeat_bitwise": bitwise_repeat(
                    lambda: dattn(q, k, v, kv_len), out),
                "library": "SDPA" + (" enable_gqa" if gqa else
                                     " over K/V repeated to H heads"),
                "library_max_abs_err": lib_err,
            }
            row["bound_ms"], row["bound_by"] = decode_bound(q, k, kv_len)
            row["bound_us"] = row["bound_ms"] * 1e3
            emit("kernel", kernel="decode_attention", **row)
            if not (ok and zero_rows_exact and row["repeat_bitwise"]):
                raise AssertionError(
                    f"decode_attention {name} {dtype}: kernel vs plain max "
                    f"abs err {err} beyond {tol}, an empty row not zero, or "
                    "two calls on the same inputs differ")
            rows[(name, dtype)] = row
            del q, k, v, kv_len, out, ref, kl, vl, mask
            torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------- split sweeps --
def _kernel_us(fn, n=5):
    """Device us per call of each kernel ``fn`` launches (torch.profiler
    over ``n`` calls, L2 warm)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            out[name] = out.get(name, 0.0) + _device_us(e) / n
    return out


SWEEP_SPLITS = (1, 2, 4, 8, 13, 26)
SWEEP_LORA_SPLITS = (4, 8, 11, 16, 22, 32)


def phase_splits():
    """Bring-up: what the split plans rest on.  decode_attention (bf16)
    at the cross shape over SWEEP_SPLITS splits, with K/V as the model's
    transposed view and as a contiguous copy; ssd_scan (x bf16) at every
    SSD_SHAPES entry, with the errors the kernel phase checks and each
    of its kernels' device us (torch.profiler); lora_matmul and
    segmented_lora_matmul (bf16, one plan for both) at every decode shape
    over SWEEP_LORA_SPLITS splits and the plan's own; as
    yardsticks a torch sum over 128 MB of bf16 (a streaming read) and a
    device spin of one cycle (the timing's floor).  Device ms as the
    kernel phases time them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import lora_matmul as lmm
    big = torch.ones(64 << 20, dtype=torch.bfloat16, device="cuda")
    emit("splits", yardstick="sum of 128 MB bf16",
         ms=device_ms(lambda: big.sum()), bytes=big.numel() * 2)
    del big
    emit("splits", yardstick="torch.cuda._sleep(1)",
         ms=device_ms(lambda: torch.cuda._sleep(1)))
    b, h, hkv, d, s, layout, lengths = DECODE_SHAPES[0][1:]
    q, k, v, kv_len = decode_case(b, h, hkv, d, s, layout, lengths,
                                  torch.bfloat16, 800)
    kc, vc = k.contiguous(), v.contiguous()
    plan = da.split_plan_bf16
    tiles = -(-s // da.BF16_TILE_ROWS)
    try:
        for want in SWEEP_SPLITS:
            per = -(-tiles // want)
            da.split_plan_bf16 = \
                lambda *_, per=per: (-(-tiles // per), per * da.BF16_TILE_ROWS)
            emit("splits", kernel="decode_attention", shape="cross",
                 splits=-(-tiles // per),
                 view_ms=device_ms(lambda: da.decode_attention(q, k, v,
                                                               kv_len)),
                 contiguous_ms=device_ms(lambda: da.decode_attention(
                     q, kc, vc, kv_len)))
    finally:
        da.split_plan_bf16 = plan
    del q, k, v, kc, vc
    # ssd_scan: each of its two launches, checked against the plain
    # version as the kernel phase checks it
    from repro_torch.kernels import ssd_scan as ssd
    for si, (name, b, s, h, p, n, init, inputs) in enumerate(SSD_SHAPES):
        x, dts, a, bm, cm, st = ssd_case(b, s, h, p, n, init,
                                         torch.bfloat16, 600 + si, inputs)
        yr, finr = ssd.ssd_scan_ref(x, dts, a, bm, cm, chunk=SSD_CHUNK,
                                    init_state=st)

        def call():
            return ssd.ssd_scan(x, dts, a, bm, cm, init_state=st)

        y, fin = call()
        emit("splits", kernel="ssd_scan", shape=name,
             y_rel_err=_rel_err(y, yr), state_rel_err=_rel_err(fin, finr),
             ms=device_ms(call, SSD_REPS), us_by_kernel=_kernel_us(call))
    plan = lmm.decode_split_plan
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("lora_matmul", name, m, k, n, 200 + si, None)
             for si, (name, m, k, n, r) in enumerate(LORA_SHAPES)]
    cases += [("segmented_lora_matmul", name, m, k, n, 500 + si, (na, seq))
              for si, (name, m, k, n, r, na, seq) in enumerate(SEG_SHAPES)]
    for kernel, name, m, k, n, seed, slots in cases:
        if m > lmm.DECODE_MAX_M:
            continue
        if slots is None:
            x, w, a, b = lora_case(m, k, n, 16, torch.bfloat16, seed)

            def call():
                return lmm.lora_matmul(x, w, a, b, LORA_SCALING)
        else:
            x, w, a, b, idx = seg_case(m, k, n, 16, *slots, torch.bfloat16,
                                       seed)

            def call():
                return lmm.segmented_lora_matmul(x, w, a, b, idx,
                                                 LORA_SCALING)
        steps = -(-k // lmm.DECODE_STEP)
        own = plan(k, n, n_sm)[0]
        times = {}
        try:
            for want in sorted(set(SWEEP_LORA_SPLITS + (own,))):
                per = -(-steps // min(want, steps))
                lmm.decode_split_plan = lambda *_, per=per: (
                    -(-steps // per), per * lmm.DECODE_STEP)
                lmm.decode_workspace.cache_clear()   # it caches the plan
                times[-(-steps // per)] = device_ms(call)
        finally:
            lmm.decode_split_plan = plan
            lmm.decode_workspace.cache_clear()
        emit("splits", kernel=kernel, shape=name, M=m, K=k, N=n,
             slots=slots[0] if slots else 1, plan_splits=own,
             ms_by_splits=times)
    return None


# ------------------------------------------------------------ A / B -----
def time_kernels(families=()):
    """``--time-kernels SRC [FAMILY ...]``: of the package under SRC,
    lora_matmul and segmented_lora_matmul at every shape of LORA_SHAPES
    and SEG_SHAPES in bfloat16 (and float32 at M <= 16), lora_matmul's
    dX (the transposed operands) at its train shapes, decode_attention at
    DECODE_SHAPES, paged_decode_attention at PAGED_SHAPES, ssd_scan (y)
    at SSD_SHAPES and its backward (every gradient) at SSD_BWD_SHAPES
    (float32 and bfloat16), and flash_attention's bf16 forward and
    backward at their main shapes, on the kernel phases' inputs (same
    seeds): device ms (as the kernel phases time them), host us per call,
    max abs error against the plain version.  Named families (the part
    of a row's key before the first slash) alone when given.  One JSON
    line."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lmm
    from repro_torch.kernels import ssd_scan as ssd

    built = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(built)) as pool:
        list(pool.map(_build.library, built))
    rows = {}

    def want(family):
        return not families or family in families

    def add(key, fn, ref, reps=REPS, calls=100):
        if not want(key.split("/")[0]):
            return
        out = fn()
        rows[key] = {"ms": device_ms(fn, reps), "host_us": host_us(fn, calls),
                     "max_abs_err": float((out.float() - ref.float())
                                          .abs().max())}

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for si, (name, m, k, n, r) in enumerate(LORA_SHAPES):
            if m <= 16 or dtype == torch.bfloat16:
                x, w, a, b = lora_case(m, k, n, r, dtype, 200 + si)
                add(f"lora_matmul/{name}/{dt}",
                    lambda: lmm.lora_matmul(x, w, a, b, LORA_SCALING),
                    lmm.lora_matmul_ref(x, w, a, b, LORA_SCALING))
                if name.startswith("train") and dtype == torch.bfloat16:
                    dy = torch.randn((m, n), generator=torch.Generator(
                        device="cuda").manual_seed(300), device="cuda").to(
                            dtype)
                    add(f"lora_matmul_dx/{name}/{dt}",
                        lambda: lmm.lora_matmul(dy, w.t(), b.t(), a.t(),
                                                LORA_SCALING),
                        lmm.lora_matmul_ref(dy, w.t(), b.t(), a.t(),
                                            LORA_SCALING))
                del x, w, a, b
        for si, (name, m, k, n, r, na, seq) in enumerate(SEG_SHAPES):
            if m <= 16 or dtype == torch.bfloat16:
                x, w, a, b, idx = seg_case(m, k, n, r, na, seq, dtype,
                                           500 + si)
                add(f"segmented_lora_matmul/{name}/{dt}",
                    lambda: lmm.segmented_lora_matmul(x, w, a, b, idx,
                                                      LORA_SCALING),
                    lmm.segmented_lora_matmul_ref(x, w, a, b, idx,
                                                  LORA_SCALING))
        for si, (name, b, h, hkv, d, s, layout, lengths) in \
                enumerate(DECODE_SHAPES):
            q, k, v, kv_len = decode_case(b, h, hkv, d, s, layout, lengths,
                                          dtype, 800 + si)
            add(f"decode_attention/{name}/{dt}",
                lambda: da.decode_attention(q, k, v, kv_len),
                da.decode_attention_ref(q, k, v, kv_len))
        for si, (name, shp) in enumerate(PAGED_SHAPES):
            q, kp, vp, tables, kv_len = attention_case(**shp, dtype=dtype,
                                                       seed=100 + si)
            add(f"paged_decode_attention/{name}/{dt}",
                lambda: da.paged_decode_attention(q, kp, vp, tables, kv_len),
                da.paged_decode_attention_ref(q, kp, vp, tables, kv_len))
        for si, (name, b, s, h, p, n, init, inputs) in enumerate(SSD_SHAPES):
            x, dts, a, bm, cm, st = ssd_case(b, s, h, p, n, init, dtype,
                                             600 + si, inputs)
            add(f"ssd_scan/{name}/{dt}",
                lambda: ssd.ssd_scan(x, dts, a, bm, cm, init_state=st)[0],
                ssd.ssd_scan_ref(x, dts, a, bm, cm, chunk=SSD_CHUNK,
                                 init_state=st)[0], SSD_REPS, 20)
        for si, (name, b, s, h, p, n, init, inputs) in enumerate(
                SSD_BWD_SHAPES):
            if not want("ssd_scan_bwd"):
                break
            x, dts, a, bm, cm, st = ssd_case(b, s, h, p, n, init, dtype,
                                             800 + si, inputs)
            g = torch.Generator(device="cuda").manual_seed(900 + si)
            dy = torch.randn((b, s, h, p), generator=g,
                             device="cuda").to(dtype)
            dfin = torch.randn((b, h, p, n), generator=g, device="cuda") \
                if init else None

            def bwd():
                return ssd.ssd_scan_bwd(x, dts, a, bm, cm, dy, dfin,
                                        init_state=st)

            got = bwd()
            ref = ssd.ssd_scan_bwd_ref(x, dts, a, bm, cm, dy, dfin,
                                       chunk=SSD_BWD_CHUNK, init_state=st)
            rows[f"ssd_scan_bwd/{name}/{dt}"] = {
                "ms": device_ms(bwd, SSD_BWD_REPS),
                "host_us": host_us(bwd, 20),
                "max_abs_err": max(float((u.float() - v.float()).abs().max())
                                   for u, v in zip(got, ref)
                                   if v is not None)}
            del x, dts, a, bm, cm, st, dy, dfin, got, ref
            torch.cuda.empty_cache()
    # flash_attention shares csrc/hopper.cuh with them: its bf16 forward
    # at the qwen wave and backward at the qwen train batch
    for name, backward in (("qwen_prefill", False), ("qwen_train", True)):
        if not want("flash_attention" + ("_backward" if backward else "")):
            continue
        si = [f[0] for f in FLASH_SHAPES].index(name)
        _, b, h, hkv, d, s, w, causal = FLASH_SHAPES[si]
        g = torch.Generator(device="cuda").manual_seed(400 + si)
        q, k, v, do = (torch.randn((b, s, n, d), generator=g, device="cuda")
                       .to(torch.bfloat16).transpose(1, 2)
                       for n in (h, hkv, hkv, h))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=w)

        def fn():
            if backward:   # dQ
                return fa.flash_attention_backward(q, k, v, o, lse, do,
                                                   causal=causal,
                                                   window=w)[0]
            return fa.flash_attention_fwd(q, k, v, causal=causal,
                                          window=w)[0]

        ref = (fa.flash_attention_grad_ref(q, k, v, do, causal=causal,
                                           window=w)[0]
               if backward else fa.flash_attention_ref(q, k, v,
                                                       causal=causal,
                                                       window=w))
        rows[f"flash_attention{'_backward' if backward else ''}/{name}/"
             "bfloat16"] = {"ms": device_ms(fn, FLASH_REPS),
                            "host_us": host_us(fn, 20),
                            "max_abs_err": float((fn().float() - ref.float())
                                                 .abs().max())}
    print(json.dumps({"time_kernels": SRC, "rows": rows}), flush=True)


def run_ab(parent, families=()):
    """``--ab DIR [FAMILY ...]``: ``time_kernels`` on the package of the
    checkout at DIR (the parent commit, unpacked) and on this one in
    turn: parent, change, change, parent, each in a process of its own
    on this card.  One line per run, then one per call with the four
    times."""
    trees = [os.path.join(os.path.abspath(parent), "src"), SRC, SRC,
             os.path.join(os.path.abspath(parent), "src")]
    runs = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels",
             tree, *families], capture_output=True, text=True,
            timeout=1500)
        if proc.returncode != 0:
            raise RuntimeError(f"--time-kernels {tree} failed:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1])["rows"])
        emit("ab_run", tree=tree, rows=runs[-1])
    for key in runs[0]:
        emit("ab", call=key,
             **{f"{f}_parent_change_change_parent": [r[key][f] for r in runs]
                for f in ("ms", "host_us", "max_abs_err")})


# --------------------------------------------------------- reference -----
def phase_reference(get_config, build, make_engine, lm, scan, dattn):
    """The port on the card against the port on the CPU on the same
    float32 weights (reduced config): decode logits, then one train
    step; full-width logits sanity; a full-width combined step against
    a decode with the pre-update adapter; then mamba2 (``_reference_ssm``)
    and the VLM (``_reference_vlm``)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.paging import blocks_for
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(ARCH).scaled()
    cpu = build(cfg, "cpu")
    gpu = build(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))

    lens = torch.tensor([5, 9, 3], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (3, 12),
                         generator=torch.Generator().manual_seed(3))
    bs, steps = 4, 6
    nb = blocks_for(int(lens.max()) + steps, bs)
    tables = torch.arange(1, 1 + 3 * nb, dtype=torch.int32).reshape(3, nb)
    wave = tables[:, :3].clone().numpy()
    for j, n in enumerate(lens.tolist()):
        wave[j, blocks_for(n, bs):] = 1 + 3 * nb     # dropped
    outs, feed = {}, None
    lm.launches = 0
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        p, lo = (tree_map(lambda t: t.to(m.device), tree)
                 for tree in (params, lora))
        logits, pre = m.prefill_ragged(p, lo, {"tokens": toks.to(m.device)},
                                       lens.to(m.device))
        caches = m.write_prefill_blocks(m.init_paged_caches(1 + 3 * nb, bs),
                                        pre, wave)
        seq, fed = [logits.cpu()], []
        for s in range(steps):
            # both devices decode the CPU run's greedy tokens
            tok = feed[s] if feed is not None \
                else logits[:, -1].argmax(-1).cpu()
            fed.append(tok)
            logits, caches = m.decode_step_paged(
                p, lo, caches, tok[:, None].to(m.device),
                (lens + s).to(m.device), tables.to(m.device))
            seq.append(logits.cpu())
        outs[name], feed = seq, fed
    worst = max(float((a - b).abs().max() / (a.abs().max() + 1e-6))
                for a, b in zip(outs["cpu"], outs["cuda"]))
    if worst >= 5e-5:
        raise AssertionError(f"card vs CPU logits differ by {worst} "
                             "(relative to their largest magnitude)")
    if lm.launches == 0:
        raise AssertionError("the card's reference run never launched "
                             "lora_matmul")

    # one train step, card vs CPU, same weights and batch (lr 1e-3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (4, 25))
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:]),
             "mask": torch.ones((4, 24))}
    res = {}
    for dev in ("cpu", "cuda"):
        eng = make_engine(cfg, lr=1e-3, device=dev)
        p, lo, bt = (tree_map(lambda t: t.to(dev), tree)
                     for tree in (params, lora, batch))
        loss, _, grads = eng.loss_and_grads(p, lo, bt)
        new, _, met = eng.train_step(p, lo, eng.optimizer.init(lo), bt)
        res[dev] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)],
                    [t.cpu() for t in tree_leaves(new)], met["loss"].cpu())
    loss_err = float((res["cuda"][0] - res["cpu"][0]).abs()
                     / res["cpu"][0].abs())
    grad_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                   for a, b in zip(res["cuda"][1], res["cpu"][1]))
    lora_err = max(float((a - b).abs().max())
                   for a, b in zip(res["cuda"][2], res["cpu"][2]))
    lora_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                  for a, b in zip(res["cuda"][2], res["cpu"][2]))
    # tolerances: the loss is one float32 reduction (1e-5 relative);
    # gradients sum over every position in another order (1e-4 of each
    # leaf's largest); the adapter moves ~lr = 1e-3 per element, so 1e-6
    # absolute is 0.1% of the step
    emit("reference_train", reduced_config=cfg.name, dtype="float32",
         loss_rel_err=loss_err, loss_tol=1e-5, grad_rel_err=grad_err,
         grad_tol=1e-4, updated_lora_max_abs_err=lora_err,
         updated_lora_tol="rtol 1e-5, atol 1e-6",
         step_loss_cpu=float(res["cpu"][3]),
         step_loss_cuda=float(res["cuda"][3]))
    if not (loss_err < 1e-5 and grad_err < 1e-4 and lora_ok):
        raise AssertionError("train step: card vs CPU beyond tolerance")

    full = build(get_config(ARCH), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = full.init(gen)
    lora = full.init_lora(gen)
    toks = torch.randint(0, full.cfg.vocab_size, (8, 32), device="cuda",
                         generator=gen)
    logits, pre = full.prefill_ragged(params, lora, {"tokens": toks},
                                      torch.full((8,), 32, device="cuda"))
    caches = full.init_caches(8, 48)
    caches = full.write_prefill_slots(caches, pre, np.arange(8))
    dec, _ = full.decode_step(params, lora, caches,
                              logits[:, -1].argmax(-1)[:, None],
                              torch.full((8,), 32, dtype=torch.int32,
                                         device="cuda"))
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(dec).all())
    shape_ok = tuple(dec.shape) == (8, 1, full.cfg.vocab_size)
    emit("reference", reduced_config=cfg.name, dtype="float32",
         card_vs_cpu_max_rel_err=worst, tol=5e-5,
         full_width_logits_finite=finite, full_width_logits_shape=list(
             dec.shape))
    if not (finite and shape_ok):
        raise AssertionError("full-width logits not finite or misshapen")

    # full-width combined step: its logits come from the pre-update
    # adapter, so they equal a plain decode with that adapter on the
    # same cache (identical kernels on identical inputs: bitwise)
    eng = make_engine(full.cfg, lr=3e-3, device="cuda")
    for leaf in tree_leaves(lora):                # a live bypass: b != 0
        if leaf.shape[1] == full.cfg.lora.rank:
            leaf.normal_(0.0, 0.02, generator=gen)
    pool = full.init_paged_caches(1 + 8 * 2, 16)
    tables = torch.arange(1, 17, dtype=torch.int32,
                          device="cuda").reshape(8, 2)
    tok = toks[:, :1]
    pos = torch.zeros(8, dtype=torch.int32, device="cuda")
    data = SyntheticDataset("alpaca", vocab_size=full.cfg.vocab_size,
                            seq_len=256, seed=0)
    tb = {k: torch.as_tensor(v, device="cuda")
          for k, v in data.batch(4).items()}
    before = [t.clone() for t in tree_leaves(lora)]
    snap = {"kv": tuple(t.clone() for t in pool["kv"])}
    new_lora, _, comb, _, met = eng.combined_step_paged(
        params, lora, eng.optimizer.init(lora), tb, pool, tok, pos, tables)
    ref, _ = full.decode_step_paged(params, lora, snap, tok, pos, tables)
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(new_lora), before))
    untouched = all(torch.equal(a, b)
                    for a, b in zip(tree_leaves(lora), before))
    comb_err = float((comb.float() - ref.float()).abs().max())
    emit("reference_combined", config=full.cfg.name, dtype="bfloat16",
         logits_vs_pre_update_decode_max_abs_err=comb_err, tol=0.0,
         pre_update_adapter_untouched=untouched,
         adapter_max_move=moved, train_loss=float(met["ce_loss"]))
    if comb_err != 0.0 or not untouched or moved == 0.0 \
            or not np.isfinite(float(met["ce_loss"])):
        raise AssertionError("combined step: logits are not the pre-update "
                             "adapter's, or the adapter did not train")
    del full, eng, params, lora, new_lora, caches, pool, snap, pre, logits
    del dec, comb, ref, tb
    torch.cuda.empty_cache()
    _reference_ssm(get_config, build, scan)
    _reference_vlm(get_config, build, dattn)
    _reference_serving(get_config, make_engine)


def _reference_ssm(get_config, build, scan, steps=5):
    """mamba2 at its reduced float32 size (2 layers, 8 SSM heads of 32,
    state 16), the card against the CPU on the same weights: one
    exact-length prefill of two 100-token prompts (the kernel takes the
    mixer's strided views, and 100 is no multiple of its chunk): logits,
    conv tails and states; then both requests written into slots 2 and 0
    of a 3-slot pool and ``steps`` decode steps' logits.  The card's
    prefill calls ssd_scan once per layer (SSD_LAUNCHES launches)."""
    from repro_torch.tree import tree_map
    cfg = get_config(SSM_ARCH).scaled()
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen)
    feed = torch.randint(0, cfg.vocab_size, (steps, 3, 1), generator=gen)
    res = {}
    scan.launches = 0
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        p, lo = (tree_map(lambda t: t.to(dev), tree)
                 for tree in (params, lora))
        with torch.no_grad():
            logits, pre = m.prefill(p, lo, {"tokens": toks.to(dev)})
            pool = m.init_caches(3, 128)
            for src, slot in ((0, 2), (1, 0)):
                m.write_prefill_slot(pool, pre, slot, src)
            seq = [logits.cpu()]
            for s in range(steps):
                logits, pool = m.decode_step(
                    p, lo, pool, feed[s].to(dev),
                    torch.full((3,), 100 + s, device=dev))
                seq.append(logits.cpu())
        res[name] = (seq, {k: v.cpu() for k, v in pre["ssm"].items()})
    launches = scan.launches

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))

    (sc, cc), (sg, cg) = res["cpu"], res["cuda"]
    prefill_err = rel(sg[0], sc[0])
    decode_err = max(rel(a, b) for a, b in zip(sg[1:], sc[1:]))
    cache_err = {k: rel(cg[k], cc[k]) for k in ("conv", "state")}
    emit("reference_ssm", reduced_config=cfg.name, dtype="float32",
         prompts=[2, 100], decode_steps=steps,
         prefill_logits_rel_err=prefill_err, decode_logits_rel_err=decode_err,
         logits_tol=5e-5, conv_rel_err=cache_err["conv"],
         state_rel_err=cache_err["state"], cache_tol=5e-5,
         ssd_scan_launches=launches)
    if not (prefill_err < 5e-5 and decode_err < 5e-5
            and max(cache_err.values()) < 5e-5):
        raise AssertionError("mamba2: card vs CPU beyond tolerance")
    if launches != cfg.n_layers * SSD_LAUNCHES:
        raise AssertionError(f"mamba2 reference: {launches} ssd_scan "
                             f"launches for one prefill of {cfg.n_layers} "
                             f"layers ({SSD_LAUNCHES} a call)")


def _open_gates(params, gate=0.5):
    """Both gates of every cross block at ``gate``: the init's zeros make
    each cross block the identity, and a wrong cross-attention would not
    move one logit."""
    for key in ("gate_attn", "gate_mlp"):
        params["cross"][key].fill_(gate)


def _vlm_decode_caches(model, pre, b, s):
    """Decode caches of length ``s`` holding a prefill's K/V in their
    first rows and its vision K/V, by slice copy (a VLM stack has no
    cache-slot writes, as in the reference)."""
    caches = model.init_caches(b, s)
    p = pre["kv"][0].shape[3]
    for dst, src in zip(caches["kv"], pre["kv"]):
        dst[:, :, :, :p] = src
    for dst, src in zip(caches["cross_kv"], pre["cross_kv"]):
        dst.copy_(src)
    return caches


def _reference_vlm(get_config, build, dattn, steps=5):
    """The VLM at a reduced float32 size (2 units of 2 dense blocks and a
    cross block, d_model 128, 37 vision tokens so the decode kernel's
    walk is split and ragged), gates at 0.5, the card against the CPU on
    the same weights: prefill logits and cross_kv of two 9-token prompts,
    then ``steps`` decode steps' logits.  The card's decode launches
    decode_attention once per unit per step."""
    from repro_torch.tree import tree_map
    cfg = get_config(VLM_ARCH).scaled(n_layers=6, cross_attn_every=3,
                                      vision_tokens=37)
    units = cfg.n_layers // cfg.cross_attn_every
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    _open_gates(params)
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    vis = torch.randn((2, cfg.vision_tokens, cfg.d_model), generator=gen)
    res, feed, launches = {}, None, None
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        p, lo = (tree_map(lambda t: t.to(dev), tree)
                 for tree in (params, lora))
        with torch.no_grad():
            logits, pre = m.prefill(p, lo, {"tokens": toks.to(dev),
                                            "vision": vis.to(dev)})
            caches = _vlm_decode_caches(m, pre, 2, 9 + steps)
            seq, fed = [logits.cpu()], []
            dattn.launches = 0
            for s in range(steps):
                # both devices decode the CPU run's greedy tokens
                tok = feed[s] if feed is not None \
                    else logits[:, -1].argmax(-1).cpu()
                fed.append(tok)
                logits, caches = m.decode_step(p, lo, caches,
                                               tok[:, None].to(dev),
                                               torch.tensor(9 + s))
                seq.append(logits.cpu())
            if name == "cuda":
                launches = dattn.launches
        res[name], feed = (seq, [t.cpu() for t in pre["cross_kv"]]), fed

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))

    (sc, cc), (sg, cg) = res["cpu"], res["cuda"]
    prefill_err = rel(sg[0], sc[0])
    decode_err = max(rel(a, b) for a, b in zip(sg[1:], sc[1:]))
    cross_err = max(rel(a, b) for a, b in zip(cg, cc))
    emit("reference_vlm", reduced_config=cfg.name, dtype="float32",
         units=units, vision_tokens=cfg.vision_tokens, gates=0.5,
         prompts=[2, 9], decode_steps=steps,
         prefill_logits_rel_err=prefill_err, decode_logits_rel_err=decode_err,
         cross_kv_rel_err=cross_err, tol=5e-5,
         decode_attention_launches=launches,
         decode_attention_launches_derived=units * steps)
    if not (prefill_err < 5e-5 and decode_err < 5e-5 and cross_err < 5e-5):
        raise AssertionError("VLM: card vs CPU beyond tolerance")
    if launches != units * steps:
        raise AssertionError(f"VLM reference: {launches} decode_attention "
                             f"launches for {steps} steps of {units} units")


def _reference_serving(get_config, make_engine):
    """The batcher's prefix cache, chunked prefill, copy-on-write and
    oversubscription, the port on the card against the port on the CPU,
    reduced float32 config, the same weights (a live bypass): a
    repeated-prefix trace, cache off, on, and on with 8-token chunks; six
    prompts chunked (paged blocks of 8: chunks of 8 and 12; contiguous: 8
    and 10) and monolithic; a 16-token sliding window whose ring wrap
    re-enters aliased blocks, cache off and on; and the twins of
    tests/test_preemption.py's four traces on a pool far below their
    worst case (``oversubscribe`` 1.0): swap (under REPRO_SANITIZE=1),
    drop (``swap=False``), chunked, and shared prefixes with the prefix
    cache, each beside the same trace on an unbounded pool.  Within each
    trace every run emits the same greedy tokens, the card's equal the
    CPU's, every paged allocator drains, every oversubscribed run
    preempts, the sanitized run adds no report, and the windowed run
    copies at least one block (``Model.copy_blocks``)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models.model import Model
    from repro_torch.runtime import sanitize
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    from repro_torch.tree import tree_map

    def prompts(cfg, lens, seed):
        data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                                seq_len=max(lens), seed=seed)
        toks = data.sample_tokens(len(lens))
        return [toks[i, :n].astype(np.int32) for i, n in enumerate(lens)]

    def traces(cfg, wcfg):
        (head,) = prompts(cfg, [24], 3)
        rep = [np.concatenate([head, t]) for t in
               prompts(cfg, [4, 7, 2, 8, 5], 11)]
        rep_kw = dict(n_slots=2, max_seq=48, prompt_pad=32, paged=True,
                      block_size=8)
        six = prompts(cfg, [7, 24, 13, 24, 6, 19], 3)
        six_kw = dict(n_slots=3, max_seq=32, prompt_pad=24)
        (wh,) = prompts(wcfg, [12], 3)
        win = [wh] + [np.concatenate([wh, t])
                      for t in prompts(wcfg, [2, 2], 5)]
        win_kw = dict(n_slots=2, max_seq=40, prompt_pad=16, paged=True,
                      block_size=4, n_blocks=13)
        # tests/test_preemption.py's traces: heavy-tailed answers on 3
        # slots, and prompts sharing a 16-token head
        ov = prompts(cfg, [7, 16, 13, 10, 6, 15], 3)
        ov_kw = dict(n_slots=3, max_seq=48, prompt_pad=16, paged=True,
                     block_size=8)
        base = prompts(cfg, [16, 16], 3)
        ovp = [base[0], np.concatenate([base[0], base[1][:4]]),
               base[0].copy(), base[1], base[0][:10],
               np.concatenate([base[0], base[1][4:9]])]
        ovp_kw = {**ov_kw, "prompt_pad": 24, "prefix_cache": True}
        over = {"oversubscribe": 1.0}
        return {
            "repeated_prefix": (False, rep, [5, 3, 6, 2, 4], [
                ("cache_off", rep_kw), ("cache_on", {**rep_kw,
                                                     "prefix_cache": True}),
                ("cache_on_chunk8", {**rep_kw, "prefix_cache": True,
                                     "prefill_chunk": 8})]),
            "chunked": (False, six, [6] * 6, [
                ("paged_monolithic", {**six_kw, "paged": True,
                                      "block_size": 8}),
                ("paged_chunk8", {**six_kw, "paged": True, "block_size": 8,
                                  "prefill_chunk": 8}),
                ("paged_chunk12", {**six_kw, "paged": True, "block_size": 8,
                                   "prefill_chunk": 12}),
                ("contiguous_monolithic", six_kw),
                ("contiguous_chunk8", {**six_kw, "prefill_chunk": 8}),
                ("contiguous_chunk10", {**six_kw, "prefill_chunk": 10})]),
            "window_cow": (True, win, [4, 10, 10], [
                ("cache_off", win_kw),
                ("cache_on", {**win_kw, "prefix_cache": True})]),
            "oversub": (False, ov, [24, 4, 20, 4, 6, 18], [
                ("unbounded", {**ov_kw, "n_blocks": 64}),
                ("swap_sanitized", {**ov_kw, **over, "n_blocks": 10}),
                ("drop", {**ov_kw, **over, "n_blocks": 10, "swap": False}),
                ("chunked", {**ov_kw, **over, "n_blocks": 9,
                             "prefill_chunk": 8})]),
            "oversub_prefix": (False, ovp, [24, 6, 18, 20, 4, 4], [
                ("unbounded", {**ovp_kw, "n_blocks": 64}),
                ("swap", {**ovp_kw, **over, "n_blocks": 12})]),
        }

    cfg = get_config(ARCH).scaled()
    wcfg = get_config(ARCH).scaled(sliding_window=16)
    weights = {}
    for name, c in (("full", cfg), ("window", wcfg)):
        cpu = make_engine(c, device="cpu").model
        p = cpu.init(torch.Generator().manual_seed(0))
        lo = cpu.init_lora(torch.Generator().manual_seed(1))
        for pair in lo.values():            # a live bypass: b != 0
            pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                              .manual_seed(2))
        weights[name] = (c, p, lo)
    copies = []
    orig = Model.copy_blocks

    def spy(self, caches, src, dst):
        copies.append((self.device.type, len(src)))
        return orig(self, caches, src, dst)

    Model.copy_blocks = spy
    tokens, drained, preempted = {}, True, {}
    reports = len(sanitize.reports())
    try:
        for dev in ("cpu", "cuda"):
            for key, (windowed, ps, gens, runs) in traces(cfg, wcfg).items():
                c, p, lo = weights["window" if windowed else "full"]
                eng = make_engine(c, device=dev)
                p, lo = (tree_map(lambda t: t.to(dev), tree)
                         for tree in (p, lo))
                for run, kw in runs:
                    armed = run.endswith("sanitized")
                    if armed:           # the factories read it at init
                        os.environ["REPRO_SANITIZE"] = "1"
                    try:
                        b = ContinuousBatcher(eng, p, lo, **kw)
                    finally:
                        os.environ.pop("REPRO_SANITIZE", None)
                    if armed and b.allocator.san is None:
                        raise AssertionError("reference serving: the "
                                             "sanitizer did not arm")
                    reqs = [GenRequest(request_id=i, prompt=q.copy(),
                                       max_new_tokens=g)
                            for i, (q, g) in enumerate(zip(ps, gens))]
                    if key == "window_cow":
                        # a short request registers the prefix, then the
                        # two sharers decode past the window
                        b.run(reqs[:1])
                        b.run(reqs[1:])
                    else:
                        b.run(reqs)
                    tokens[(dev, key, run)] = [r.tokens for r in reqs]
                    if b.paged:
                        drained &= b.allocator.n_used == 0 \
                            and b.allocator.reserved == 0 \
                            and b.n_preempted == 0
                    if b.oversubscribe:
                        st = b.stats
                        preempted[f"{dev}/{key}/{run}"] = dict(
                            preemptions=st.preemptions,
                            swap_out_blocks=st.swap_out_blocks,
                            swap_in_blocks=st.swap_in_blocks,
                            reprefill_tokens=st.reprefill_tokens)
    finally:
        Model.copy_blocks = orig
    same = {key: all(tokens[(dev, key, run)] == tokens[("cpu", key,
                                                        runs[0][0])]
                     for dev in ("cpu", "cuda") for run, _ in runs)
            for key, (_, _, _, runs) in traces(cfg, wcfg).items()}
    cuda_copies = sum(n for dev, n in copies if dev == "cuda")
    emit("reference_serving", reduced_config=cfg.name, dtype="float32",
         runs={key: [run for run, _ in runs]
               for key, (_, _, _, runs) in traces(cfg, wcfg).items()},
         all_runs_and_card_equal_cpu_tokens=same, allocators_drained=drained,
         copy_blocks_calls={dev: sum(1 for d, _ in copies if d == dev)
                            for dev in ("cpu", "cuda")},
         blocks_copied_cuda=cuda_copies, preemption_counters=preempted,
         sanitizer_reports_added=len(sanitize.reports()) - reports)
    every_run_preempted = all(c["preemptions"] > 0
                              for c in preempted.values())
    if not (all(same.values()) and drained and cuda_copies > 0
            and every_run_preempted
            and len(sanitize.reports()) == reports):
        raise AssertionError(
            f"reference serving: tokens {same}, drained {drained}, "
            f"blocks copied on the card {cuda_copies}, preemptions "
            f"{preempted}, sanitizer reports {sanitize.reports()[reports:]}")


def phase_reference_blockwise(get_config, build, make_engine, fa):
    """The blockwise path: the port on the card against the port on the
    CPU at a reduced float32 config with ``attn_impl="blockwise"``
    (head_dim 64, GQA 2:1): prefill logits and caches, then one train
    step; and at full width in bf16 the blockwise and dense paths on the
    same 992-token inputs, where both can run."""
    import dataclasses
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(ARCH).scaled(attn_impl="blockwise", d_model=256,
                                  n_heads=4, n_kv_heads=2)
    cpu = build(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    lens = torch.tensor([40, 70, 33], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (3, 80),
                         generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    tt = rng.integers(0, cfg.vocab_size, (4, 97))
    batch = {"tokens": torch.tensor(tt[:, :-1]),
             "labels": torch.tensor(tt[:, 1:]), "mask": torch.ones((4, 96))}
    res = {}
    fa.flash_attention_fwd.launches = fa.flash_attention_backward.launches = 0
    for dev in ("cpu", "cuda"):
        eng = make_engine(cfg, lr=1e-3, device=dev)
        p, lo, bt = (tree_map(lambda t: t.to(dev), tree)
                     for tree in (params, lora, batch))
        logits, pre = eng.model.prefill_ragged(
            p, lo, {"tokens": toks.to(dev)}, lens.to(dev))
        loss, _, grads = eng.loss_and_grads(p, lo, bt)
        new, _, _ = eng.train_step(p, lo, eng.optimizer.init(lo), bt)
        res[dev] = (logits.cpu(), [c.cpu() for c in pre["kv"]], loss.cpu(),
                    [g.cpu() for g in tree_leaves(grads)],
                    [t.cpu() for t in tree_leaves(new)])
    launches = (fa.flash_attention_fwd.launches,
                fa.flash_attention_backward.launches)
    c, g = res["cpu"], res["cuda"]

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))

    logit_err = rel(g[0], c[0])
    cache_err = max(rel(a, b) for a, b in zip(g[1], c[1]))
    loss_err = rel(g[2], c[2])
    grad_err = max(rel(a, b) for a, b in zip(g[3], c[3]))
    # Adam's first step moves each element by lr * g / (|g| + eps): about
    # lr * sign(g), so an element whose gradient lies inside the gradient
    # tolerance (1e-4 of its leaf's largest) may move either way; every
    # other element must agree to rtol 1e-5, atol 1e-6
    lora_ok, loose, lora_err = True, 0, 0.0
    for a, b, gc in zip(g[4], c[4], c[3]):
        firm = gc.abs() >= 1e-4 * gc.abs().max()
        loose += int((~firm).sum())
        lora_err = max(lora_err, float((a - b).abs().max()))
        lora_ok &= torch.allclose(a[firm], b[firm], rtol=1e-5, atol=1e-6)
    emit("reference_blockwise", reduced_config=cfg.name, dtype="float32",
         head_dim=cfg.head_dim, n_kv_heads=cfg.n_kv_heads,
         prefill_logits_rel_err=logit_err, logits_tol=5e-5,
         cache_rel_err=cache_err, cache_tol=1e-5, loss_rel_err=loss_err,
         loss_tol=1e-5, grad_rel_err=grad_err, grad_tol=1e-4,
         updated_lora_ok=lora_ok, updated_lora_max_abs_err=lora_err,
         lora_elements_inside_grad_tol=loose,
         flash_attention_launches=launches[0],
         flash_attention_backward_launches=launches[1])
    if not (logit_err < 5e-5 and cache_err < 1e-5 and loss_err < 1e-5
            and grad_err < 1e-4 and lora_ok):
        raise AssertionError("blockwise path: card vs CPU beyond tolerance")
    # prefill, loss_and_grads and train_step: 2 layers forward each, and
    # FLASH_BWD launches per layer in the two backwards
    if launches != (3 * cfg.n_layers, 2 * FLASH_BWD * cfg.n_layers):
        raise AssertionError(f"blockwise reference: launches {launches}")

    # Full width, bf16, 2 x 992 tokens: every layer's attention, the
    # blockwise and the dense path on the same input (the dense model's
    # hidden state at that layer), within 2e-2 of the largest output (a
    # bf16 ulp is 2^-8..2^-7 of it).  The 24-layer logits, where bf16
    # rounding differences grow layer by layer, are read out beside a
    # float32 run of the same weights, not checked
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm, rope_tables
    full = get_config(ARCH)
    dense = build(dataclasses.replace(full, attn_impl="dense"), "cuda")
    blockwise = build(dataclasses.replace(full, attn_impl="blockwise"),
                      "cuda")
    f32 = build(dataclasses.replace(full, attn_impl="dense", dtype="float32",
                                    param_dtype="float32"), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = dense.init(gen)
    lora = dense.init_lora(gen)
    for leaf in tree_leaves(lora):                # a live bypass: b != 0
        if leaf.shape[1] == full.lora.rank:
            leaf.normal_(0.0, 0.02, generator=gen)
    toks = torch.randint(0, full.vocab_size, (2, 992), device="cuda",
                         generator=gen)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    with torch.no_grad():
        rope = rope_tables(torch.arange(992, device="cuda"), full.head_dim,
                           full.rope_theta)
        x = params["embed"][toks]
        layer_errs = []
        for i in range(full.n_layers):
            bp = tree_map(lambda t: t[i], params["blocks"])
            lo = tree_map(lambda t: t[i], lora)
            h = rms_norm(x, bp["ln1"])
            out = {m.cfg.attn_impl: tfm.attn_full(bp["attn"], h, m.cfg,
                                                  rope, lora=lo)[0]
                   for m in (dense, blockwise)}
            layer_errs.append(rel(out["blockwise"], out["dense"]))
            x, _, _ = tfm.block_full(bp, x, dense.cfg, rope, lora=lo)
        ld = dense.logits(params, lora, {"tokens": toks}).float()
        lb = blockwise.logits(params, lora, {"tokens": toks}).float()
        lt = f32.logits(tree_map(lambda t: t.float(), params), lora,
                        {"tokens": toks})
    emit("reference_blockwise_vs_dense", config=full.name, dtype="bfloat16",
         tokens=[2, 992], attention_rel_err_per_layer=layer_errs,
         attention_rel_err_max=max(layer_errs), layer_tol=2e-2,
         logits_blockwise_vs_dense_rel_err=rel(lb, ld),
         logits_dense_vs_f32_rel_err=rel(ld, lt),
         logits_blockwise_vs_f32_rel_err=rel(lb, lt))
    if max(layer_errs) >= 2e-2:
        raise AssertionError(
            f"blockwise vs dense attention beyond 2e-2 of the largest "
            f"output: per layer {layer_errs}")
    del params, lora, ld, lb, lt, out, h, x, dense, blockwise, f32
    torch.cuda.empty_cache()


# ------------------------------------------------------------- serving ----
def set_depth(registry, whole, cut):
    """Point ``registry``'s DEPTH_CUT archs, for this process, at their
    depth-cut configs (``cut``) or at ``whole``, the configs as the
    package has them; grok-1-314b at GROK_LAYERS layers either way."""
    import dataclasses
    for arch, n in DEPTH_CUT.items():
        registry._REGISTRY[arch] = dataclasses.replace(
            whole[arch], n_layers=n) if cut else whole[arch]
    registry._REGISTRY[GROK_ARCH] = dataclasses.replace(
        whole[GROK_ARCH], n_layers=GROK_LAYERS)


def cut_depth(registry):
    """``set_depth(cut=True)``; returns the whole configs."""
    whole = dict(registry._REGISTRY)
    set_depth(registry, whole, True)
    return whole


def arch_counts(get_config, arch):
    """(layers, adapter projections per forward, their dX launches per
    backward) of ``arch``: its LoRA targets in every layer; layer 0's
    projections of the frozen embedding's norm (q, k, v, ``ssm_in``) get
    no dX."""
    cfg = get_config(arch)
    n, targets = cfg.n_layers, set(cfg.lora.targets)
    return n, len(targets) * n, \
        len(targets) * n - len(targets & {"q", "k", "v", "ssm_in"})


def long_prompt(plen):
    """Whether prefill at ``plen`` tokens takes the blockwise path."""
    return plen * plen > 1024 * 1024


SERVE_RUNS = [
    ("paged", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16)),
    ("contiguous", ARCH, dict(paged=False, prompt_len=32, gen_tokens=16)),
    ("paged_992", ARCH, dict(paged=True, prompt_len=992, gen_tokens=32)),
    ("paged_992_bs128", ARCH, dict(paged=True, block_size=128,
                                   prompt_len=992, gen_tokens=32)),
    ("contiguous_992", ARCH, dict(paged=False, prompt_len=992,
                                  gen_tokens=32)),
    ("paged_2048", ARCH, dict(paged=True, prompt_len=2048, gen_tokens=32)),
    ("contiguous_2048", ARCH, dict(paged=False, prompt_len=2048,
                                   gen_tokens=32)),
    ("paged_4096", ARCH, dict(paged=True, prompt_len=4096, gen_tokens=32)),
    ("llama_paged_2048", "llama3-8b", dict(paged=True, prompt_len=2048,
                                           gen_tokens=32)),
]


def _reset(*counters):
    for c in counters:
        c.launches = 0


def latency_percentiles(out):
    """TTFT and TPOT p50 / p99 (ms) of a run from ``ServeStats.ttft`` /
    ``tpot``: arrival (all at the run's start) to the tick that admitted
    the request, and the seconds per later token, as the reference's
    batcher stamps them."""
    res = {}
    for key, vals in (("ttft", out["ttft_s"]), ("tpot", out["tpot_s"])):
        for pct in (50, 99):
            res[f"{key}_p{pct}_ms"] = float(np.percentile(vals, pct)) * 1e3
    return res


def phase_serve(run_serving, get_config, pda, lm, fa, seg):
    """Serving at full width, every launch count checked: the decode
    kernel once per layer per decode step, lora_matmul once per adapter
    projection per prefill wave and decode step, flash_attention once
    per layer per prefill wave past the dense limit and never below,
    segmented_lora_matmul never (one adapter)."""
    results = {}
    fwd = fa.flash_attention_fwd
    for name, arch, kw in SERVE_RUNS:
        n_layers, n_lora, _ = arch_counts(get_config, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg)                         # main path starts
        out = run_serving(arch, smoke=False, n_requests=16, batch_size=8,
                          seed=0, device="cuda", verbose=False, **kw)
        launches, lora_launches, flash = pda.launches, lm.launches, \
            fwd.launches                                  # path ends
        if seg.launches:
            raise AssertionError(f"{name}: {seg.launches} segmented "
                                 "launches with one adapter")
        gen = kw["gen_tokens"]
        flash_want = n_layers * out["prefill_waves"] \
            if long_prompt(kw["prompt_len"]) else 0
        row = {
            "run": name, "arch": arch, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen,
            "block_size": kw.get("block_size", 16) if kw["paged"] else None,
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": out["decode_steps"],
            "prefill_waves": out["prefill_waves"],
            "kernel_launches": launches,
            "lora_matmul_launches": lora_launches,
            "flash_attention_launches": flash,
            "flash_attention_launches_derived": flash_want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": out["cache_bytes"],
        }
        if kw["paged"]:
            row.update(peak_used_blocks=out["peak_used_blocks"],
                       pool_blocks=out["pool_blocks"],
                       blocks_used_at_end=out["blocks_used_at_end"],
                       blocks_reserved_at_end=out["blocks_reserved_at_end"])
        emit("serve", **row)
        if out["finished"] != 16 or out["tokens_generated"] != 16 * gen \
                or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"{name}: not every request finished")
        if launches != n_layers * out["decode_steps"]:
            raise AssertionError(
                f"{name}: {launches} kernel launches for "
                f"{out['decode_steps']} decode steps of {n_layers} layers")
        if lora_launches != n_lora * (out["decode_steps"]
                                      + out["prefill_waves"]):
            raise AssertionError(
                f"{name}: {lora_launches} lora_matmul launches for "
                f"{out['decode_steps']} decode steps and "
                f"{out['prefill_waves']} prefill waves")
        if flash != flash_want:
            raise AssertionError(f"{name}: {flash} flash_attention "
                                 f"launches, derived {flash_want}")
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            raise AssertionError(f"{name}: allocator did not drain")
        results[name] = (row, out["tokens"])
        del out
        torch.cuda.empty_cache()
    # the kernel walks logical rows whatever the pool's block size, so
    # every layout of one traffic computes the same logits
    short = results["paged"][1] == results["contiguous"][1]
    long_ = all(results[n][1] == results["paged_992"][1]
                for n in ("paged_992_bs128", "contiguous_992"))
    long2k = results["paged_2048"][1] == results["contiguous_2048"][1]
    emit("serve_check", short_paged_equals_contiguous_tokens=short,
         long_all_layouts_equal_tokens=long_,
         paged_2048_equals_contiguous_tokens=long2k)
    if not (short and long_ and long2k):
        raise AssertionError("layouts of one traffic emitted different "
                             "tokens")
    return results


# ------------------------------------------------------------ SSM serving -
SSM_ARCH = "mamba2-780m"
SSM_RUNS = [("ssm_32", dict(prompt_len=32, gen_tokens=16)),
            ("ssm_992", dict(prompt_len=992, gen_tokens=32)),
            ("ssm_2048", dict(prompt_len=2048, gen_tokens=32))]


def phase_serve_ssm(run_serving, get_config, pda, lm, fa, seg, scan):
    """mamba2-780m at full width (8 layers, d_model 1536, 48 SSM heads
    of 64, state 128, bf16, random weights from a seed), 16 requests on
    8 contiguous slots: every request finishes, and the launches are
    exactly as derived: ssd_scan once per layer per request (each prompt
    prefills alone, at its exact length; SSD_LAUNCHES launches a call),
    lora_matmul once per adapter projection (ssm_in, ssm_out) per layer
    per prefill call and decode step, and no attention or segmented
    kernel at all."""
    cfg = get_config(SSM_ARCH)
    n_lora = 2 * cfg.n_layers
    fwd = fa.flash_attention_fwd
    results = {}
    for name, kw in SSM_RUNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg, scan)                   # main path starts
        with LoraShapeTap() as ltap:
            out = run_serving(SSM_ARCH, smoke=False, n_requests=16,
                              batch_size=8, seed=0, device="cuda",
                              verbose=False, **kw)
        launches = {"ssd_scan": scan.launches, "lora_matmul": lm.launches,
                    "paged_decode_attention": pda.launches,
                    "flash_attention": fwd.launches,
                    "segmented_lora_matmul": seg.launches}   # path ends
        gen, steps = kw["gen_tokens"], out["decode_steps"]
        want = {"ssd_scan": cfg.n_layers * 16 * SSD_LAUNCHES,
                "lora_matmul": n_lora * (16 + steps),
                "paged_decode_attention": 0, "flash_attention": 0,
                "segmented_lora_matmul": 0}
        row = {
            "run": name, "arch": SSM_ARCH, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen, "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": steps, "prefill_waves": out["prefill_waves"],
            "launches": launches, "launches_derived": want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": out["cache_bytes"],
            "lora_shapes": lora_summary(ltap),
        }
        emit("serve_ssm", **row)
        require_checked(f"serve_ssm {name}", ltap)
        if out["finished"] != 16 or out["tokens_generated"] != 16 * gen \
                or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"serve_ssm {name}: not every request "
                                 "finished")
        if launches != want:
            raise AssertionError(f"serve_ssm {name}: launches {launches}, "
                                 f"derived {want}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------- hybrid serving ---------
HYBRID_ARCH = "hymba-1.5b"
HYBRID_RUNS = [("hybrid_32", 16, dict(prompt_len=32, gen_tokens=16)),
               ("hybrid_992", 16, dict(prompt_len=992, gen_tokens=32)),
               ("hybrid_wrap_1984", 8, dict(prompt_len=1984,
                                            gen_tokens=128))]
# the ring-wrap check: a 1,984-token prompt prefilled, then 128 tokens
# decoded through the 2,048-row ring (teacher-forced), whose logits past
# position 2,048 are held against Model.logits of the same 2,112 tokens
# (the windowed forward, flash_attention and the SSD scan), relative to
# the largest logit: bf16 over 16 layers of two paths that round in
# other places (reference_blockwise holds two bf16 attention paths over
# 24 layers at 2e-2), so 5e-2, and the argmax of at least 90% of the rows;
# and every ring slot of every layer, its K and V rows together, nearest
# (Euclidean) to the forward's at the position it must hold, among all
# 2,112: a stale, misplaced or off-by-one slot is nearer another
# position's (K carries the rotary position; V alone does not tell a
# repeated token's positions apart, so its count is shown, not held)
RING_PROMPT, RING_GEN = 1984, 128
RING_TOL, RING_ARGMAX = 5e-2, 0.9
# the exact ring check: hymba's widths (d_model 1,600, 25 / 5 heads of
# 64, 50 SSM heads of 64, state 16, vocab 32,001) at 4 layers in float32
# with a 64-row window; a 48-token prompt, then 208 tokens decoded
# teacher-forced (the ring wraps three times); every decode step's
# logits, each layer's ring K/V rows and SSM state after the last step
# against the plain versions: the same weights and tokens through
# Model.logits and Model.hidden_states on the CPU; relative to the
# largest value, float32 over 4 layers of paths that sum in other orders
RING_EXACT_LAYERS, RING_EXACT_WINDOW = 4, 64
RING_EXACT_PROMPT, RING_EXACT_GEN = 48, 208
RING_EXACT_TOL = 1e-4
# reduced float32 hymba on the card and on the CPU: a 16-token window
# that every request's decode wraps, 6 requests on 2 slots
HYBRID_REF_LENS, HYBRID_REF_GEN = [12, 16, 5, 9, 14, 7], 12


def _hybrid_reference(get_config, make_engine):
    """The reduced float32 hymba (window 16) on the card and on the CPU,
    one weight set: the batcher's greedy tokens equal, every request's
    decode wrapping its ring."""
    import dataclasses
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(HYBRID_ARCH).scaled(),
                              sliding_window=16)
    cpu = make_engine(cfg, device="cpu")
    params = cpu.model.init(torch.Generator().manual_seed(0))
    lora = tree_map(lambda t: t + 0.01,
                    cpu.model.init_lora(torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in HYBRID_REF_LENS]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = cpu if dev == "cpu" else make_engine(cfg, device="cuda")
        b = ContinuousBatcher(eng, tree_map(lambda t: t.to(dev), params),
                              tree_map(lambda t: t.to(dev), lora),
                              n_slots=2, max_seq=32, prompt_pad=16)
        reqs = [GenRequest(request_id=i, prompt=p.copy(),
                           max_new_tokens=HYBRID_REF_GEN)
                for i, p in enumerate(prompts)]
        b.run(reqs)
        tokens[dev] = [list(r.tokens) for r in reqs]
    equal = tokens["cpu"] == tokens["cuda"]
    emit("serve_hybrid_reference", config=cfg.name, dtype="float32",
         window=16, prompt_lens=HYBRID_REF_LENS, gen=HYBRID_REF_GEN,
         tokens_equal=equal, tokens=tokens["cuda"])
    if not equal or any(len(t) != HYBRID_REF_GEN for t in tokens["cuda"]):
        raise AssertionError(f"serve_hybrid reference: card {tokens['cuda']}"
                             f" against CPU {tokens['cpu']}")


def _ring_rows_nearest(ring_kv, full_kv, total, tokens):
    """Per layer, whether each ring slot (K ‖ V, [L, B=1, W, Hkv, D]
    each) is nearest (Euclidean, in float32) to the forward's (K ‖ V)
    [L, 1, T, Hkv, D] at the position it must hold after ``total``
    tokens (slot p % W holds the last position p < total), among all T.
    Returns, for K ‖ V, K alone and V alone, the count of slots that
    are, and of the V misses those whose nearest position holds the same
    token (V has no rotary term: a repeated token's V rows differ only
    by context)."""
    w = ring_kv[0].shape[2]
    slots = torch.tensor([p % w for p in range(total - w, total)],
                         device=ring_kv[0].device)
    want = torch.arange(total - w, total, device=ring_kv[0].device)
    hits = {"kv": 0, "k": 0, "v": 0, "v_same_token": 0}
    for layer in range(ring_kv[0].shape[0]):
        r = [t[layer, 0, slots].flatten(1).float() for t in ring_kv]
        f = [t[layer, 0, :total].flatten(1).float() for t in full_kv]
        for name, a, b in (("kv", torch.cat(r, 1), torch.cat(f, 1)),
                           ("k", r[0], f[0]), ("v", r[1], f[1])):
            got = torch.cdist(a, b).argmin(1)
            hits[name] += int((got == want).sum())
            if name == "v":
                miss = got != want
                hits["v_same_token"] += int(
                    (tokens[got[miss]] == tokens[want[miss]]).sum())
    return hits


def _ring_wrap(make_engine, get_config):
    """Full-width hymba: a 1,984-token prompt prefilled, its caches in a
    one-slot pool of the 2,048-row ring, 128 tokens decoded
    teacher-forced; the logits past position 2,048 against
    ``Model.logits`` of the 2,112 tokens, and every ring slot nearest
    the forward's K ‖ V at its position (``_ring_rows_nearest``)."""
    cfg = get_config(HYBRID_ARCH)
    eng = make_engine(cfg, device="cuda")
    model = eng.model
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.init(gen)
    lora = model.init_lora(gen)
    total = RING_PROMPT + RING_GEN
    toks = torch.randint(0, cfg.vocab_size, (1, total), generator=gen,
                         device="cuda")
    with AttnShapeTap() as tap, LoraShapeTap() as ltap, torch.no_grad():
        hidden, fwd = model.hidden_states(params, lora, {"tokens": toks},
                                          collect_caches=True)
        full = (hidden @ params["lm_head"])[0].float()   # Model.logits
        del hidden
        _, pre = model.prefill(params, lora,
                               {"tokens": toks[:, :RING_PROMPT]})
        pool = model.init_caches(1, total)
        model.write_prefill_slot(pool, pre, 0)
        del pre
        got = {}
        for t in range(RING_PROMPT, total):
            lg, pool = model.decode_step(params, lora, pool, toks[:, t:t + 1],
                                         torch.tensor([t], device="cuda"))
            if t >= cfg.sliding_window:
                got[t] = lg[0, 0].float()
    rows = sorted(got)
    dec = torch.stack([got[t] for t in rows])
    ref = full[rows]
    rel = float((dec - ref).abs().max() / ref.abs().max())
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    ring = pool["kv"][0].shape[2]
    n_rows = cfg.n_layers * ring
    nearest = _ring_rows_nearest(pool["kv"], fwd["kv"], total, toks[0])
    emit("serve_hybrid_ring", arch=HYBRID_ARCH, prompt=RING_PROMPT,
         decoded=RING_GEN, ring_rows=ring, positions_checked=len(rows),
         first_checked=rows[0], rel_err=rel, rel_tol=RING_TOL,
         argmax_agreement=agree, argmax_min=RING_ARGMAX,
         ring_slots_nearest_their_position=nearest, ring_slots_all=n_rows,
         attention_shapes=tap.summary(), lora_shapes=lora_summary(ltap))
    require_checked("serve_hybrid ring wrap", tap, ltap)
    if ring != cfg.sliding_window or not (rel <= RING_TOL
                                          and agree >= RING_ARGMAX):
        raise AssertionError(f"serve_hybrid ring wrap: ring {ring}, logits "
                             f"{rel} of the largest, argmax agreement "
                             f"{agree}")
    if nearest["kv"] != n_rows:
        raise AssertionError(f"serve_hybrid ring wrap: {n_rows - nearest['kv']}"
                             f" of {n_rows} ring slots are nearer another "
                             f"position's forward K ‖ V than their own "
                             f"({nearest})")
    return {"rel_err": rel, "argmax_agreement": agree,
            "ring_slots_nearest": nearest}


def ring_exact(make_engine, cfg, device="cuda", seed=11):
    """Hymba's float32 ring against the plain versions (see
    RING_EXACT_*): one weight set (adapters non-zero) on the CPU and on
    ``device``; the prompt prefilled and written into a one-slot pool,
    the rest decoded teacher-forced on ``device``.  Returns the worst
    errors relative to the largest reference value: logits of every
    decode step against ``Model.logits`` on the CPU, and after the last
    step each layer's ring K and V rows and SSM state against
    ``Model.hidden_states``' K/V at the positions the ring must hold and
    its final state."""
    from repro_torch.tree import tree_map
    total = RING_EXACT_PROMPT + RING_EXACT_GEN
    cpu = make_engine(cfg, device="cpu").model
    params = cpu.init(torch.Generator().manual_seed(seed))
    lora = tree_map(lambda t: t + 0.01,
                    cpu.init_lora(torch.Generator().manual_seed(seed + 1)))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, total)))
    with torch.no_grad():
        hidden, ref = cpu.hidden_states(params, lora, {"tokens": toks},
                                        collect_caches=True)
        ref_logits = (hidden @ params["lm_head"])[0, RING_EXACT_PROMPT:]
        del hidden
        model = make_engine(cfg, device=device).model
        p_dev, l_dev = (tree_map(lambda t: t.to(device), tr)
                        for tr in (params, lora))
        t_dev = toks.to(device)
        _, pre = model.prefill(p_dev, l_dev,
                               {"tokens": t_dev[:, :RING_EXACT_PROMPT]})
        pool = model.init_caches(1, total)
        model.write_prefill_slot(pool, pre, 0)
        del pre
        dec = []
        for t in range(RING_EXACT_PROMPT, total):
            lg, pool = model.decode_step(p_dev, l_dev, pool,
                                         t_dev[:, t:t + 1],
                                         torch.tensor([t], device=device))
            dec.append(lg[0, 0].cpu())
    w = cfg.sliding_window
    slots = [p % w for p in range(total - w, total)]

    def rel(got, want):
        return float((got.cpu().float() - want.float()).abs().max()
                     / want.float().abs().max())

    return {"logits": rel(torch.stack(dec), ref_logits),
            "k": rel(pool["kv"][0][:, 0, slots], ref["kv"][0][:, 0, -w:]),
            "v": rel(pool["kv"][1][:, 0, slots], ref["kv"][1][:, 0, -w:]),
            "ssm_state": rel(pool["ssm"]["state"], ref["ssm"]["state"]),
            "ring_rows": pool["kv"][0].shape[2]}


def _ring_exact_full(make_engine, get_config):
    """``ring_exact`` at hymba's widths on the card (RING_EXACT_*)."""
    import dataclasses
    cfg = dataclasses.replace(
        get_config(HYBRID_ARCH), n_layers=RING_EXACT_LAYERS,
        sliding_window=RING_EXACT_WINDOW, dtype="float32",
        param_dtype="float32")
    with AttnShapeTap() as tap:
        errs = ring_exact(make_engine, cfg)
    worst = max(v for k, v in errs.items() if k != "ring_rows")
    emit("serve_hybrid_ring_exact", arch=HYBRID_ARCH, dtype="float32",
         layers=RING_EXACT_LAYERS, window=RING_EXACT_WINDOW,
         prompt=RING_EXACT_PROMPT, decoded=RING_EXACT_GEN,
         rel_tol=RING_EXACT_TOL, **{f"{k}_rel_err" if k != "ring_rows"
                                    else k: v for k, v in errs.items()},
         attention_shapes=tap.summary())
    require_checked("serve_hybrid exact ring", tap)
    if errs["ring_rows"] != RING_EXACT_WINDOW or worst > RING_EXACT_TOL:
        raise AssertionError(f"serve_hybrid exact ring: {errs} beyond "
                             f"{RING_EXACT_TOL} of the largest value")
    return errs


def phase_serve_hybrid(run_serving, make_engine, get_config, pda, lm, fa,
                       seg, scan):
    """hymba-1.5b: the reduced float32 batcher on the card against the
    CPU (greedy tokens through ring wraps); at full width (16 layers,
    d_model 1,600, 25 / 5 heads of 64, window 2,048, 50 SSM heads of 64,
    state 16, bf16, random weights from a seed) through ``run_serving``
    on 8 contiguous slots at 32 + 16 and 992 + 32 (16 requests) and 1,984
    + 128 (8 requests, every decode wrapping the ring): every request
    finishes and the launches are exactly as derived (ssd_scan once per
    layer per request's exact-length prefill, flash_attention once per
    layer per prefill past 1,024 tokens, the paged decode kernel through
    identity tables once per layer per decode step, lora_matmul once per
    adapter projection per prefill call and decode step), every attention
    shape launched held against the plain version by a kernel phase
    (``AttnShapeTap``); then the ring wrap's logits and ring rows against
    the forward (``_ring_wrap``, its attention and lora_matmul shapes
    held likewise) and the float32 ring against the plain versions
    (``_ring_exact_full``)."""
    _hybrid_reference(get_config, make_engine)
    n_layers, n_lora, _ = arch_counts(get_config, HYBRID_ARCH)
    fwd = fa.flash_attention_fwd
    results = {}
    for name, n_req, kw in HYBRID_RUNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg, scan)                   # main path starts
        with AttnShapeTap() as tap, LoraShapeTap() as ltap:
            out = run_serving(HYBRID_ARCH, smoke=False, n_requests=n_req,
                              batch_size=8, seed=0, device="cuda",
                              verbose=False, **kw)
        launches = {"ssd_scan": scan.launches, "lora_matmul": lm.launches,
                    "paged_decode_attention": pda.launches,
                    "flash_attention": fwd.launches,
                    "segmented_lora_matmul": seg.launches}   # path ends
        gen, steps = kw["gen_tokens"], out["decode_steps"]
        want = {"ssd_scan": n_layers * n_req * SSD_LAUNCHES,
                "lora_matmul": n_lora * (n_req + steps),
                "paged_decode_attention": n_layers * steps,
                "flash_attention": n_layers * n_req
                if long_prompt(kw["prompt_len"]) else 0,
                "segmented_lora_matmul": 0}
        row = {
            "run": name, "arch": HYBRID_ARCH, "requests": n_req,
            "prompt_len": kw["prompt_len"], "gen_tokens": gen,
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": steps, "prefill_waves": out["prefill_waves"],
            "launches": launches, "launches_derived": want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"], **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": out["cache_bytes"],
            "attention_shapes": tap.summary(),
            "lora_shapes": lora_summary(ltap),
        }
        emit("serve_hybrid", **row)
        require_checked(f"serve_hybrid {name}", tap, ltap)
        if out["finished"] != n_req or out["tokens_generated"] != n_req * gen \
                or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"serve_hybrid {name}: not every request "
                                 "finished")
        if launches != want:
            raise AssertionError(f"serve_hybrid {name}: launches {launches}, "
                                 f"derived {want}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    results["ring"] = _ring_wrap(make_engine, get_config)
    torch.cuda.empty_cache()
    results["ring_exact"] = _ring_exact_full(make_engine, get_config)
    torch.cuda.empty_cache()
    return results


# --------------------------------------------------- SSM co-training ------
# (name, arch, requests, run): 16 requests at 32 + 16 and 2,048 + 8; 8
# at hymba's 1,984 + 8 (train batches of 4 x 1,984 through the
# flash_attention forward and backward, the window 2,048)
COMBINED_SSM_RUNS = [
    ("mamba2_32", SSM_ARCH, 16, dict(prompt_len=32, gen_tokens=16)),
    ("hymba_32", HYBRID_ARCH, 16, dict(prompt_len=32, gen_tokens=16)),
    ("mamba2_2048", SSM_ARCH, 16, dict(prompt_len=2048, gen_tokens=8)),
    ("hymba_1984", HYBRID_ARCH, 8, dict(prompt_len=1984, gen_tokens=8))]
FIXED_BATCH_STEPS = 6


def phase_combined_ssm(run_serving, make_engine, get_config, pda, lm, fa,
                       seg, scan, scan_bwd):
    """Serving while co-training on SSM stacks (``run_serving(combined=
    True)`` on 8 contiguous slots, a fresh 4 x prompt-length train batch
    every tick): mamba2-780m and hymba-1.5b at 32 + 16, mamba2 at 2,048 +
    8 (the backward at 4 x 2,048), hymba at 1,984 + 8 (COMBINED_SSM_RUNS).
    One train step per tick with finite losses, every request finishes,
    launches exactly as derived (ssd_scan: each request's prefill and
    each train step's forward, SSD_LAUNCHES a call; its backward
    ``arch_bwd_launches`` a layer per train step; lora_matmul: forward, and
    dX of every projection but layer 0's of the embedding; hymba past
    1,024 tokens, flash_attention once a layer per prefill and train
    step, its backward FLASH_BWD a layer per train step), every
    attention shape launched held against the plain version by a kernel
    phase; then the loss of each arch on a fixed batch falls over
    ``FIXED_BATCH_STEPS`` steps."""
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    results = {}
    for name, arch, n_req, kw in COMBINED_SSM_RUNS:
        n_layers, n_lora, n_lora_bwd = arch_counts(get_config, arch)
        hybrid = arch == HYBRID_ARCH
        flash = hybrid and long_prompt(kw["prompt_len"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, bwd, seg, scan, scan_bwd)    # main path starts
        with AttnShapeTap() as tap, LoraShapeTap() as ltap, \
                SsdBwdShapeTap() as btap:
            out = run_serving(arch, smoke=False, n_requests=n_req,
                              batch_size=8, combined=True, train_batch=4,
                              seed=0, device="cuda", verbose=False, **kw)
        launches = {"ssd_scan": scan.launches,
                    "ssd_scan_backward": scan_bwd.launches,
                    "lora_matmul": lm.launches,
                    "paged_decode_attention": pda.launches,
                    "flash_attention": fwd.launches,
                    "flash_attention_backward": bwd.launches,
                    "segmented_lora_matmul": seg.launches}   # path ends
        steps, ticks = out["train_steps"], out["decode_steps"]
        want = {"ssd_scan": n_layers * SSD_LAUNCHES * (n_req + steps),
                "ssd_scan_backward": n_layers * steps * arch_bwd_launches(
                    get_config, arch, 4, kw["prompt_len"]),
                "lora_matmul": n_lora * (n_req + ticks)
                + (n_lora + n_lora_bwd) * steps,
                "paged_decode_attention": n_layers * ticks if hybrid else 0,
                "flash_attention": n_layers * (n_req + steps) if flash
                else 0,
                "flash_attention_backward": FLASH_BWD * n_layers * steps
                if flash else 0,
                "segmented_lora_matmul": 0}
        losses = out["train_losses"]
        row = {
            "run": name, "arch": arch, "requests": n_req,
            "prompt_len": kw["prompt_len"], "gen_tokens": kw["gen_tokens"],
            "train_batch": [4, kw["prompt_len"]],
            "finished": out["finished"], "decode_steps": ticks,
            "train_steps": steps, "prefill_waves": out["prefill_waves"],
            "launches": launches, "launches_derived": want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"], **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "attention_shapes": tap.summary(),
            "lora_shapes": lora_summary(ltap),
            "ssd_scan_backward_shapes": btap.summary(),
        }
        emit("combined_ssm", **row)
        require_checked(f"combined_ssm {name}", tap, ltap, btap)
        if out["finished"] != n_req or any(len(t) != kw["gen_tokens"]
                                           for t in out["tokens"]):
            raise AssertionError(f"combined_ssm {name}: not every request "
                                 "finished")
        if steps != ticks or len(losses) != steps \
                or not np.isfinite(losses).all():
            raise AssertionError(f"combined_ssm {name}: {steps} train steps "
                                 f"for {ticks} ticks, losses {losses}")
        if launches != want:
            raise AssertionError(f"combined_ssm {name}: launches {launches},"
                                 f" derived {want}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    for arch in (SSM_ARCH, HYBRID_ARCH):
        with LoraShapeTap() as ltap, SsdBwdShapeTap() as btap:
            losses, times, _, peak = fixed_batch_steps(
                make_engine, get_config, arch, 32, FIXED_BATCH_STEPS, lm)
        require_checked(f"combined_ssm fixed batch {arch}", ltap, btap)
        emit("combined_ssm_fixed_batch", arch=arch, batch=[4, 32], lr=3e-3,
             losses=losses, step_ms=times, max_memory_allocated_bytes=peak)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"combined_ssm {arch}: the loss on a fixed "
                                 f"batch did not fall: {losses}")
        results[f"fixed_{arch}"] = losses
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------ SSM training CLI --------
SSM_TRAIN_ARCHS = (SSM_ARCH, HYBRID_ARCH)
# (b) saves at 3 and again at the end, (c) resumes to 4 and saves once:
# a save of mamba2's adapter and moments (116 MB) is ~6 s of zlib
SSM_TRAIN_STEPS, SSM_TRAIN_CKPT = 3, 3     # (b); (c) resumes to 4
SSM_TRAIN_SEQ = 256
# (a) card vs CPU, float32 reduced, 10 steps one at a time (``train_walk``,
# the qwen (a) bounds)
SSM_REF_STEPS = 10


def phase_train_cli_ssm(make_engine, get_config, lm, scan, scan_bwd):
    """The training CLI on SSM stacks, mamba2-780m and hymba-1.5b: (a)
    ``train_from_weights`` on one reduced float32 weight set on the card,
    10 steps with a checkpoint every 5, and its trajectory one step at a
    time, card against CPU (``train_walk``, the qwen (a) bounds); (b)
    ``run_training`` at full width, 4 x 256, 3 steps with a checkpoint
    at 3: finite losses, the last batch
    trained on has a lower CE under the trained adapter than under the
    initial one, launches as derived (ssd_scan forward and backward
    every layer every step, lora_matmul forward and dX), step ms, peak
    memory; (c) ``restore=True`` to 4 steps: resumes at 3, the restored
    tree bitwise (b)'s last, AdamW step 3."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch.train import (
        init_weights, run_training, train_from_weights)
    res = {}
    tmp = tempfile.mkdtemp()
    try:
        for arch in SSM_TRAIN_ARCHS:
            cfg = get_config(arch).scaled()
            params, lora = init_weights(make_engine(cfg, device="cpu"), 0)
            eng = make_engine(cfg, lr=TRAIN_ADAMW[0], device="cuda")
            with contextlib.redirect_stdout(io.StringIO()):
                gpu = train_from_weights(
                    eng, _to(params, "cuda"), _to(lora, "cuda"), arch=arch,
                    steps=SSM_REF_STEPS, batch=4, seq=32, ckpt_every=5,
                    ckpt_dir=os.path.join(tmp, f"a_{arch}"))
            start = (lora, make_engine(cfg, device="cpu").optimizer.init(
                lora))
            _, losses, worst = train_walk(make_engine, cfg, params, start,
                                          train_batches(cfg, SSM_REF_STEPS))
            emit("train_cli_ssm_reduced", arch=arch, dtype="float32",
                 batch=[4, 32], steps=gpu["steps"],
                 loss_rtol=TRAIN_LOSS_RTOL, lora_atol=TRAIN_LORA_ATOL,
                 m_tol=TRAIN_M_TOL, v_tol=TRAIN_V_TOL, walk=worst,
                 first_loss=gpu["losses"][0], last_loss=gpu["losses"][-1])
            if gpu["steps"] != SSM_REF_STEPS:
                raise AssertionError(f"train_cli_ssm (a) {arch}: "
                                     f"{gpu['steps']} steps")
            _runs_match_walk(f"train_cli_ssm (a) {arch}", gpu, losses)
            del eng, gpu

            n_layers, n_lora, n_lora_bwd = arch_counts(get_config, arch)
            ck = os.path.join(tmp, f"b_{arch}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(lm, scan, scan_bwd)                    # main path starts
            with TrainTap() as tap, AttnShapeTap() as attn, \
                    LoraShapeTap() as ltap, SsdBwdShapeTap() as btap:
                out_b = run_training(arch, smoke=False, steps=SSM_TRAIN_STEPS,
                                     batch=4, seq=SSM_TRAIN_SEQ, ckpt_dir=ck,
                                     ckpt_every=SSM_TRAIN_CKPT,
                                     verbose=False, device="cuda")
            launches = {"lora_matmul": lm.launches,
                        "ssd_scan": scan.launches,
                        "ssd_scan_backward": scan_bwd.launches}  # path ends
            peak = torch.cuda.max_memory_allocated()
            want = {"lora_matmul": SSM_TRAIN_STEPS * (n_lora + n_lora_bwd),
                    "ssd_scan": SSM_TRAIN_STEPS * n_layers * SSD_LAUNCHES,
                    "ssd_scan_backward": SSM_TRAIN_STEPS * n_layers
                    * arch_bwd_launches(get_config, arch, 4,
                                        SSM_TRAIN_SEQ)}
            eng = make_engine(get_config(arch), device="cuda")
            p0, l0 = init_weights(eng, 0)
            ce = _ce(eng.model, p0, [l0, out_b["lora"]], tap.last_batch)
            del p0, l0
            with TrainTap() as tap_c, LoraShapeTap() as ltap_c, \
                    SsdBwdShapeTap() as btap_c:
                out_c = run_training(arch, smoke=False,
                                     steps=SSM_TRAIN_STEPS + 1, batch=4,
                                     seq=SSM_TRAIN_SEQ, ckpt_dir=ck,
                                     restore=True, ckpt_every=SSM_TRAIN_CKPT,
                                     verbose=False, device="cuda")
            restored = tap_c.restored[0]
            bitwise = _bitwise(restored[0], out_b["lora"])
            row = {"arch": arch, "batch": [4, SSM_TRAIN_SEQ],
                   "steps": out_b["steps"], "losses": out_b["losses"],
                   "last_batch_ce_initial_trained": ce,
                   "launches": launches, "launches_derived": want,
                   "max_memory_allocated_bytes": peak, **tap.row(),
                   "attention_shapes": attn.summary(),
                   "lora_shapes": lora_summary(ltap),
                   "ssd_scan_backward_shapes": btap.summary(),
                   "restart_steps": out_c["steps"],
                   "restart_losses": out_c["losses"],
                   "restored_bitwise": bitwise,
                   "restored_adamw_step": int(restored[1].step)}
            emit("train_cli_ssm", **row)
            require_checked(f"train_cli_ssm (b, c) {arch}", attn, ltap, btap,
                            ltap_c, btap_c)
            if not (out_b["steps"] == SSM_TRAIN_STEPS
                    and np.isfinite(out_b["losses"]).all()
                    and ce[1] < ce[0]):
                raise AssertionError(f"train_cli_ssm (b) {arch}: {row}")
            if launches != want:
                raise AssertionError(f"train_cli_ssm (b) {arch}: launches "
                                     f"{launches}, derived {want}")
            if not (bitwise and row["restored_adamw_step"] == SSM_TRAIN_STEPS
                    and out_c["steps"] == SSM_TRAIN_STEPS + 1
                    and len(out_c["losses"]) == 1):
                raise AssertionError(f"train_cli_ssm (c) {arch}: {row}")
            res[arch] = row
            del eng, out_b, out_c, restored, tap, tap_c
            torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ------------------------------------------------------------------ MoE ---
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_AUX_REL = 1e-6
# moe_route: (name, groups, tokens a group, E, k, logits): moonshot's E 64
# / k 6 at a decode group of 8 slots and 512-token groups, grok's E 8 /
# k 2 at 8 slots and 128 train rows, exact ties planted across the top-k
# boundary, and one expert every token wants (capacity drops)
MOE_ROUTE_CASES = [("moonshot_8", 1, 8, 64, 6, "normal"),
                   ("moonshot_512", 4, 512, 64, 6, "normal"),
                   ("grok_8", 1, 8, 8, 2, "normal"),
                   ("grok_128", 2, 128, 8, 2, "normal"),
                   ("ties", 2, 64, 64, 6, "tie"),
                   ("one_expert", 1, 128, 8, 2, "one_expert")]


def moe_logits(g, t, e, kind, seed):
    """float32 router logits [G, T, E] from a seed (numpy): normal, with
    exact ties planted, or every token wanting expert 0."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((g, t, e)) * 2).astype(np.float32)
    if kind == "tie":
        x[..., 1] = x[..., 3] = x[..., 0]
        x[:, ::2, 5 % e] = x[:, ::2, 0]
    elif kind == "one_expert":
        x[..., 0] = 5.0
        x[..., 1:] = -5.0
    return x


def phase_moe_route():
    """``moe._routing`` on the card against the CPU on the same float32
    logits (MOE_ROUTE_CASES, capacity as ``moe_mlp`` sets it for the
    group): dispatch and combine bitwise equal, aux within 1e-6 of its
    magnitude, the choices dropped; and ``moe_mlp`` at moonshot's decode
    group on the card, device ms."""
    from repro_torch.models import moe
    rows = {}
    for i, (name, g, t, e, k, kind) in enumerate(MOE_ROUTE_CASES):
        x = torch.from_numpy(moe_logits(g, t, e, kind, 300 + i))
        cap = max(k, math.ceil(t * k * 1.25 / e))
        cd, cc, ca = moe._routing(x, k, cap)
        gd, gc, ga = moe._routing(x.cuda(), k, cap)
        row = {"case": name, "groups": g, "tokens": t, "experts": e,
               "top_k": k, "capacity": cap,
               "dispatch_bitwise": torch.equal(gd.cpu(), cd),
               "combine_bitwise": torch.equal(gc.cpu(), cc),
               "aux_abs_err": abs(float(ga) - float(ca)), "aux": float(ca),
               "choices_dropped": int(g * t * k - cd.sum())}
        emit("moe_route", **row)
        if not (row["dispatch_bitwise"] and row["combine_bitwise"]
                and row["aux_abs_err"] <= MOE_AUX_REL * abs(float(ca))):
            raise AssertionError(f"moe_route {name}: card against CPU {row}")
        rows[name] = row
    if not rows["one_expert"]["choices_dropped"]:
        raise AssertionError("moe_route: one wanted expert dropped nothing")
    return rows


class AuxTap:
    """Records every ``Engine.train_step``'s ``aux_loss`` metric (device
    tensors, read after the run) while entered."""

    def __enter__(self):
        from repro_torch.core.engine import Engine
        self._cls, self._orig = Engine, Engine.train_step
        orig, self.aux = self._orig, []

        def train_step(eng, *a, **kw):
            out = orig(eng, *a, **kw)
            self.aux.append(out[2]["aux_loss"])
            return out

        Engine.train_step = train_step
        return self

    def __exit__(self, *exc):
        self._cls.train_step = self._orig
        return False

    def values(self):
        return [float(a) for a in self.aux]


# serve_moe: (name, arch, run): moonshot at DEPTH_CUT's 8 layers, paged
# and contiguous 32 + 16, paged 2,048 + 32, 4 tenants paged 32 + 16;
# grok at GROK_LAYERS, paged 32 + 16; 16 requests of one length and
# budget on 8 slots.  Paged equals contiguous bit for bit (a free slot
# feeds token 0 at position 0 in both layouts)
MOE_SERVE_RUNS = [
    ("paged", MOE_ARCH, dict(paged=True, prompt_len=32, gen_tokens=16)),
    ("contiguous", MOE_ARCH, dict(paged=False, prompt_len=32,
                                  gen_tokens=16)),
    ("paged_2048", MOE_ARCH, dict(paged=True, prompt_len=2048,
                                  gen_tokens=32)),
    ("tenants_4", MOE_ARCH, dict(paged=True, prompt_len=32, gen_tokens=16,
                                 n_adapters=4)),
    ("grok_paged", GROK_ARCH, dict(paged=True, prompt_len=32,
                                   gen_tokens=16)),
]


def moe_launches(pda, lm, fa, seg):
    """The kernels' launch counters as the MoE phases read them."""
    return {"paged_decode_attention": pda.launches,
            "lora_matmul": lm.launches,
            "flash_attention": fa.flash_attention_fwd.launches,
            "flash_attention_backward": fa.flash_attention_backward.launches,
            "segmented_lora_matmul": seg.launches}


def phase_serve_moe(run_serving, get_config, pda, lm, fa, seg):
    """The MoE stacks through ``run_serving`` (MOE_SERVE_RUNS): every
    request finishes, the allocator drains, the launches are exactly as
    derived (the decode kernel once per layer per decode step; lora_matmul,
    or with tenants segmented_lora_matmul, once per adapter projection
    per prefill wave and decode step; flash_attention once per layer per
    wave past 1,024 tokens), every attention and lora_matmul shape one a
    kernel phase checked; moonshot's paged and contiguous tokens bitwise
    equal; tok/s, TTFT / TPOT p50 / p99, peak memory."""
    from repro_torch.configs import grok1_314b, moonshot_v1_16b_a3b
    published = {MOE_ARCH: moonshot_v1_16b_a3b.CONFIG.n_layers,
                 GROK_ARCH: grok1_314b.CONFIG.n_layers}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    results = {}
    for name, arch, kw in MOE_SERVE_RUNS:
        n_layers, n_lora, _ = arch_counts(get_config, arch)
        tenants = kw.get("n_adapters", 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, bwd, seg)                    # main path starts
        with AttnShapeTap() as tap, LoraShapeTap() as ltap:
            out = run_serving(arch, smoke=False, n_requests=16,
                              batch_size=8, seed=0, device="cuda",
                              verbose=False, **kw)
        launches = moe_launches(pda, lm, fa, seg)         # path ends
        gen, steps, waves = kw["gen_tokens"], out["decode_steps"], \
            out["prefill_waves"]
        proj = n_lora * (steps + waves)
        want = {"paged_decode_attention": n_layers * steps,
                "lora_matmul": 0 if tenants else proj,
                "flash_attention": n_layers * waves
                if long_prompt(kw["prompt_len"]) else 0,
                "flash_attention_backward": 0,
                "segmented_lora_matmul": proj if tenants else 0}
        row = {
            "run": name, "arch": arch,
            "n_layers": n_layers, "published_n_layers": published[arch],
            "prompt_len": kw["prompt_len"], "gen_tokens": gen,
            "tenants": tenants, "paged": kw["paged"],
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": steps, "prefill_waves": waves,
            "launches": launches, "launches_derived": want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"], **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": out["cache_bytes"],
            "attention_shapes": tap.summary(),
            "lora_shapes": lora_summary(ltap),
        }
        emit("serve_moe", **row)
        require_checked(f"serve_moe {name}", tap, ltap)
        if out["finished"] != 16 or out["tokens_generated"] != 16 * gen \
                or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"serve_moe {name}: not every request "
                                 "finished")
        if launches != want:
            raise AssertionError(f"serve_moe {name}: launches {launches}, "
                                 f"derived {want}")
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            raise AssertionError(f"serve_moe {name}: allocator did not "
                                 "drain")
        results[name] = (row, out["tokens"])
        del out
        torch.cuda.empty_cache()
    same = results["paged"][1] == results["contiguous"][1]
    emit("serve_moe_check", paged_equals_contiguous_tokens=same)
    if not same:
        raise AssertionError("serve_moe: paged and contiguous emitted "
                             "different tokens")
    return {k: r for k, (r, _) in results.items()}


MOE_COMBINED_RUNS = [("moonshot", MOE_ARCH), ("grok", GROK_ARCH)]


def phase_combined_moe(run_serving, get_config, pda, lm, fa, seg):
    """The MoE stacks co-training while they serve (``run_serving(
    combined=True)``, paged, 16 requests of 32 + 16 on 8 slots, a fresh 4
    x 32 train batch every tick): one train step per tick, the loss and
    the load-balancing aux loss finite (aux > 0) on every step, launches
    exactly as derived (lora_matmul: forward, and dX of every projection
    but layer 0's q/k/v), every attention and lora_matmul shape, dX
    included, one a kernel phase checked."""
    results = {}
    for name, arch in MOE_COMBINED_RUNS:
        n_layers, n_lora, n_lora_bwd = arch_counts(get_config, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fa.flash_attention_fwd, fa.flash_attention_backward,
               seg)                                       # main path starts
        with AttnShapeTap() as tap, LoraShapeTap() as ltap, AuxTap() as aux:
            out = run_serving(arch, smoke=False, n_requests=16, batch_size=8,
                              paged=True, prompt_len=32, gen_tokens=16,
                              combined=True, train_batch=4, seed=0,
                              device="cuda", verbose=False)
        launches = moe_launches(pda, lm, fa, seg)         # path ends
        steps, ticks = out["train_steps"], out["decode_steps"]
        want = {"paged_decode_attention": n_layers * ticks,
                "lora_matmul": n_lora * (out["prefill_waves"] + ticks)
                + (n_lora + n_lora_bwd) * steps,
                "flash_attention": 0, "flash_attention_backward": 0,
                "segmented_lora_matmul": 0}
        losses, auxes = out["train_losses"], aux.values()
        row = {
            "run": name, "arch": arch, "n_layers": n_layers,
            "prompt_len": 32, "gen_tokens": 16, "train_batch": [4, 32],
            "finished": out["finished"], "decode_steps": ticks,
            "train_steps": steps, "prefill_waves": out["prefill_waves"],
            "launches": launches, "launches_derived": want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"], **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "ce_loss_first_last": [losses[0], losses[-1]] if losses else None,
            "aux_loss_first_last": [auxes[0], auxes[-1]] if auxes else None,
            "attention_shapes": tap.summary(),
            "lora_shapes": lora_summary(ltap),
        }
        emit("combined_moe", **row)
        require_checked(f"combined_moe {name}", tap, ltap)
        if out["finished"] != 16 or any(len(t) != 16 for t in out["tokens"]):
            raise AssertionError(f"combined_moe {name}: not every request "
                                 "finished")
        if not (steps == ticks == len(losses) == len(auxes) > 0
                and np.isfinite(losses).all() and np.isfinite(auxes).all()
                and min(auxes) > 0):
            raise AssertionError(f"combined_moe {name}: {steps} steps for "
                                 f"{ticks} ticks, losses {losses}, aux "
                                 f"{auxes}")
        if launches != want:
            raise AssertionError(f"combined_moe {name}: launches {launches},"
                                 f" derived {want}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


class RouteTap:
    """Records every ``moe._route`` call's device, experts and kept flags
    while entered (a train step's forward routes each MoE layer once)."""

    def __enter__(self):
        from repro_torch.models import moe
        self._mod, self._orig = moe, moe._route
        orig, self.calls = self._orig, []

        def route(logits, *a):
            out = orig(logits, *a)
            self.calls.append((logits.device.type, out[0].cpu(),
                               out[2].cpu()))
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        self._mod._route = self._orig
        return False

    def flips(self):
        """(layer, group, token) of every token routed otherwise on the
        card than on the CPU, the calls paired in order by device."""
        cpu = [c for c in self.calls if c[0] == "cpu"]
        card = [c for c in self.calls if c[0] != "cpu"]
        out = []
        for layer, (c, g) in enumerate(zip(cpu, card)):
            diff = (c[1] != g[1]).any(-1) | (c[2] != g[2]).any(-1)
            out += [(layer, int(gi), int(ti))
                    for gi, ti in torch.nonzero(diff).tolist()]
        return out


MOE_REF_STEPS = 10
MOE_REL = 5e-5          # the reference's MoE rule (test_decode_parity)


def moe_walk(make_engine, cfg, params, batches):
    """``train_walk`` one step at a time under ``RouteTap``: a step whose
    routing matches the CPU's token for token is held to the walk's
    bounds; a step where a token's experts flip between card and CPU is
    named (step, layer, group, token) and, if it misses the bounds, held
    to the reference's MoE rule (60% of the batch's positions and the
    median within 5e-5 of the largest logit, card against CPU, from the
    step's state).  Returns the CPU losses, the walk's worst gaps and the
    flips."""
    from repro_torch.launch.train import init_weights
    cpu = make_engine(cfg, lr=TRAIN_ADAMW[0], device="cpu")
    card = make_engine(cfg, device="cuda").model
    gparams = _to(params, "cuda")
    lora = init_weights(cpu, 0)[1]
    state = (lora, cpu.optimizer.init(lora))
    losses, flips, worst = [], [], {}
    for k, b in enumerate(batches):
        with RouteTap() as tap:
            try:
                _, step_losses, step_worst = train_walk(
                    make_engine, cfg, params, state, [b])
                missed = None
            except AssertionError as err:
                missed = str(err)
        step_flips = tap.flips()
        flips += [(k, *f) for f in step_flips]
        if missed is not None:
            if not step_flips:
                raise AssertionError(f"moe_walk step {k}: {missed} (no "
                                     "routing flip)")
            tb = {n: torch.as_tensor(x) for n, x in b.items()}
            with torch.no_grad():
                lc = cpu.model.logits(params, state[0], tb)
                lg = card.logits(gparams, _to(state[0], "cuda"),
                                 {n: x.cuda() for n, x in tb.items()}).cpu()
            scale = float(lc.abs().max())
            rels = sorted(((lg - lc).abs().amax(-1) / scale).flatten()
                          .tolist())
            if sum(r < MOE_REL for r in rels) < 0.6 * len(rels) \
                    or rels[len(rels) // 2] >= MOE_REL:
                raise AssertionError(f"moe_walk step {k}: flips "
                                     f"{step_flips}, MoE rule missed")
        for key, v in (step_worst if missed is None else {}).items():
            worst[key] = max(worst.get(key, 0.0), v)
        lora, opt = state
        new_lora, new_opt, m = cpu.train_step(
            params, lora, opt, {n: torch.as_tensor(x) for n, x in b.items()})
        state = (new_lora, new_opt)
        losses.append(float(m["ce_loss"]))
    return losses, worst, flips


MOE_TRAIN_STEPS, MOE_TRAIN_SEQ = 3, 256


def phase_train_cli_moe(make_engine, get_config, lm, fa):
    """The training CLI on the MoE family: (a) a reduced float32
    moonshot with its published 64 experts, top 6 (``scaled(n_experts=
    64, top_k=6)``: 2 layers, d_model 128), the card against the CPU one
    step at a time (``moe_walk``), MOE_REF_STEPS steps of 4 x 32; (b)
    ``run_training`` on moonshot at published width (DEPTH_CUT's 8
    layers), 4 x 256, 3 steps with a checkpoint at 3: finite losses and
    aux losses, the last batch's CE lower under the trained adapter,
    launches as derived, step ms, peak memory; (c) ``restore=True`` to 4
    steps: resumes at 3, the restored tree bitwise (b)'s, AdamW step 3;
    every attention and lora_matmul shape of (b) and (c) one that a kernel
    phase checked."""
    import shutil
    import tempfile
    from repro_torch.launch.train import init_weights, run_training
    cfg = get_config(MOE_ARCH).scaled(n_experts=64, top_k=6)
    params = init_weights(make_engine(cfg, device="cpu"), 0)[0]
    batches = train_batches(cfg, MOE_REF_STEPS)
    losses, worst, flips = moe_walk(make_engine, cfg, params, batches)
    emit("train_cli_moe_reduced", arch=MOE_ARCH, dtype="float32",
         n_experts=64, top_k=6, batch=[4, 32], steps=MOE_REF_STEPS,
         loss_rtol=TRAIN_LOSS_RTOL, lora_atol=TRAIN_LORA_ATOL,
         m_tol=TRAIN_M_TOL, v_tol=TRAIN_V_TOL, walk=worst,
         routing_flips=flips, first_loss=losses[0], last_loss=losses[-1])
    res = {"reduced": {"walk": worst, "routing_flips": flips}}
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, MOE_ARCH)
    tmp = tempfile.mkdtemp()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(lm, fa.flash_attention_fwd)                # main path starts
        with TrainTap() as tap, AttnShapeTap() as attn, \
                LoraShapeTap() as ltap, AuxTap() as aux:
            out_b = run_training(MOE_ARCH, smoke=False,
                                 steps=MOE_TRAIN_STEPS, batch=4,
                                 seq=MOE_TRAIN_SEQ, ckpt_dir=tmp,
                                 ckpt_every=MOE_TRAIN_STEPS, verbose=False,
                                 device="cuda")
        launches = {"lora_matmul": lm.launches,
                    "flash_attention": fa.flash_attention_fwd.launches}
        peak = torch.cuda.max_memory_allocated()       # path ends
        want = {"lora_matmul": MOE_TRAIN_STEPS * (n_lora + n_lora_bwd),
                "flash_attention": 0}
        eng = make_engine(get_config(MOE_ARCH), device="cuda")
        p0, l0 = init_weights(eng, 0)
        with torch.no_grad():
            ce = [float(eng.model.forward_loss(p0, lo, tap.last_batch)[1][
                "ce_loss"]) for lo in (l0, out_b["lora"])]
        del p0, l0
        with TrainTap() as tap_c, LoraShapeTap() as ltap_c:
            out_c = run_training(MOE_ARCH, smoke=False,
                                 steps=MOE_TRAIN_STEPS + 1, batch=4,
                                 seq=MOE_TRAIN_SEQ, ckpt_dir=tmp,
                                 restore=True, ckpt_every=MOE_TRAIN_STEPS,
                                 verbose=False, device="cuda")
        restored = tap_c.restored[0]
        bitwise = _bitwise(restored[0], out_b["lora"])
        auxes = aux.values()
        row = {"arch": MOE_ARCH, "n_layers": n_layers,
               "batch": [4, MOE_TRAIN_SEQ], "steps": out_b["steps"],
               "losses": out_b["losses"], "aux_losses": auxes,
               "last_batch_ce_initial_trained": ce,
               "launches": launches, "launches_derived": want,
               "max_memory_allocated_bytes": peak, **tap.row(),
               "attention_shapes": attn.summary(),
               "lora_shapes": lora_summary(ltap),
               "restart_steps": out_c["steps"],
               "restart_losses": out_c["losses"],
               "restored_bitwise": bitwise,
               "restored_adamw_step": int(restored[1].step)}
        emit("train_cli_moe", **row)
        require_checked("train_cli_moe (b, c)", attn, ltap, ltap_c)
        if not (out_b["steps"] == MOE_TRAIN_STEPS
                and np.isfinite(out_b["losses"]).all()
                and len(auxes) == MOE_TRAIN_STEPS and min(auxes) > 0
                and ce[1] < ce[0]):
            raise AssertionError(f"train_cli_moe (b): {row}")
        if launches != want:
            raise AssertionError(f"train_cli_moe (b): launches {launches}, "
                                 f"derived {want}")
        if not (bitwise and row["restored_adamw_step"] == MOE_TRAIN_STEPS
                and out_c["steps"] == MOE_TRAIN_STEPS + 1
                and len(out_c["losses"]) == 1):
            raise AssertionError(f"train_cli_moe (c): {row}")
        res["cli"] = row
        del eng, out_b, out_c, restored, tap, tap_c
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ------------------------------------------------------------- encoder ---
ENC_ARCH = "hubert-xlarge"
# encoder_serve_step waves (name, rows, frames): 8 x 512 takes the dense
# attention, 4 x 2,048 (past s*s <= 1M) flash_attention, non-causal
ENC_WAVES = [("dense_512", 8, 512), ("flash_2048", 4, 2048)]
ENC_REPS = 3                 # timed waves of each shape, after a warm one
ENC_REF_FRAMES = 1040        # the card-vs-CPU check: no multiple of 128
ENC_REF_REL = 5e-5           # tests/test_decode_parity.py's logit bound
ENC_TRAIN = (4, 256)         # the CLI's batch: rows x frames
ENC_TRAIN_STEPS = 3
# no checkpoint before each run's end-of-run save: one zlib write of the
# 48 layers' adapters and moments takes ~5 s, and a write at the last
# step would repeat it
ENC_CKPT_EVERY = 100
ENC_FLASH_TRAIN = (2, 2048)  # one train step past the dense limit
ENC_REF_STEPS = 5


def _enc_reduced(get_config):
    """hubert at full width, 2 layers, float32: the card-vs-CPU copy."""
    import dataclasses
    return dataclasses.replace(get_config(ENC_ARCH), n_layers=2,
                               dtype="float32", param_dtype="float32")


def _enc_reference(get_config, make_engine):
    """The reduced float32 hubert (full width, 2 layers) on the card and
    the CPU on the same weights: ``encoder_serve_step`` logits of one
    ENC_REF_FRAMES-frame sequence (the blockwise path: flash_attention's
    f32 kernel at D 80, non-causal, with a ragged last tile), within
    ENC_REF_REL of the largest."""
    from repro_torch.launch.train import init_weights
    from repro_torch.tree import tree_map
    cfg = _enc_reduced(get_config)
    cpu = make_engine(cfg, device="cpu")
    params, lora = init_weights(cpu, 0)
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    emb = torch.randn((1, ENC_REF_FRAMES, cfg.d_model),
                      generator=torch.Generator().manual_seed(3))
    out = {}
    for name, eng in (("cpu", cpu), ("cuda", make_engine(cfg,
                                                         device="cuda"))):
        dev = eng.model.device
        out[name] = eng.encoder_serve_step(
            tree_map(lambda t: t.to(dev), params),
            tree_map(lambda t: t.to(dev), lora),
            {"embeds": emb.to(dev)}).cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max()
                / out["cpu"].abs().max())
    row = {"reduced_config": "hubert-xlarge, 2 layers, float32",
           "frames": [1, ENC_REF_FRAMES], "logits_rel_err": err,
           "tol": ENC_REF_REL}
    emit("serve_encoder_reference", **row)
    if not err < ENC_REF_REL:
        raise AssertionError(f"serve_encoder: card vs CPU logits {err}")
    return row


def phase_serve_encoder(make_engine, get_config, pda, lm, fa, seg):
    """hubert-xlarge at published depth (48 layers) and width, bf16,
    random weights from seed 0: ``Engine.encoder_serve_step`` over waves
    of seeded frame embeddings (ENC_WAVES), a warm wave then ENC_REPS
    timed ones each: frames per second, ms per wave, logits finite and
    [B, S, 504], launches exactly as derived (lora_matmul once per
    adapter projection per layer per wave, flash_attention once per layer
    per wave past the dense limit, nothing else), peak memory; then the
    reduced float32 copy card against CPU (``_enc_reference``).  All
    under the shape taps: every launch at a shape a kernel phase
    checked."""
    from repro_torch.launch.train import init_weights
    engine = make_engine(get_config(ENC_ARCH), device="cuda")
    cfg = engine.model.cfg
    params, lora = init_weights(engine, 0)
    n_layers, n_lora, _ = arch_counts(get_config, ENC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {"arch": ENC_ARCH, "n_layers": n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "dtype": cfg.dtype, "waves": {}}
    with AttnShapeTap() as attn, LoraShapeTap() as ltap:
        for name, b, s in ENC_WAVES:
            embeds = [torch.randn((b, s, cfg.d_model), generator=gen,
                                  device="cuda")
                      for _ in range(ENC_REPS + 1)]
            engine.encoder_serve_step(params, lora, {"embeds": embeds[0]})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(pda, lm, fa.flash_attention_fwd,
                   fa.flash_attention_backward, seg)  # main path starts
            ms = []
            for e in embeds[1:]:
                t0 = time.perf_counter()
                logits = engine.encoder_serve_step(params, lora,
                                                   {"embeds": e})
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = {"lora_matmul": lm.launches,
                        "flash_attention": fa.flash_attention_fwd.launches,
                        "flash_attention_backward":
                            fa.flash_attention_backward.launches,
                        "paged_decode_attention": pda.launches,
                        "segmented_lora_matmul": seg.launches}  # path ends
            peak = torch.cuda.max_memory_allocated()
            flash = long_prompt(s)
            want = {"lora_matmul": n_lora * ENC_REPS,
                    "flash_attention": n_layers * ENC_REPS if flash else 0,
                    "flash_attention_backward": 0,
                    "paged_decode_attention": 0,
                    "segmented_lora_matmul": 0}
            ok = bool(torch.isfinite(logits).all()) \
                and tuple(logits.shape) == (b, s, cfg.vocab_size)
            med = float(np.median(ms))
            row = {"wave": [b, s], "attention": "flash" if flash else
                   "dense", "ms_per_wave": ms, "median_ms": med,
                   "frames_per_s": b * s / med * 1e3,
                   "logits_finite_and_shaped": ok,
                   "launches": launches, "launches_derived": want,
                   "max_memory_allocated_bytes": peak}
            emit("serve_encoder", name=name, **row)
            if not ok:
                raise AssertionError(f"serve_encoder {name}: logits "
                                     f"{tuple(logits.shape)} not finite or "
                                     "misshaped")
            if launches != want:
                raise AssertionError(f"serve_encoder {name}: launches "
                                     f"{launches}, derived {want}")
            res["waves"][name] = row
            del embeds, logits
        del params, lora, engine
        torch.cuda.empty_cache()
        res["reference"] = _enc_reference(get_config, make_engine)
    res["attention_shapes"] = attn.summary()
    res["lora_shapes"] = lora_summary(ltap)
    emit("serve_encoder_shapes", attention_shapes=res["attention_shapes"],
         lora_shapes=res["lora_shapes"])
    require_checked("serve_encoder", attn, ltap)
    return res


def _enc_batches(cfg, n, seq=32, rows=4):
    """``train_batches`` with the frame embeddings an encoder batch
    carries (numpy, seeded), drawn once for both devices."""
    rng = np.random.default_rng(6)
    out = []
    for b in train_batches(cfg, n, seq=seq, rows=rows):
        b["embeds"] = rng.standard_normal((rows, seq, cfg.d_model)) \
            .astype(np.float32)
        out.append(b)
    return out


def phase_train_encoder(make_engine, get_config, lm, fa):
    """Training the encoder: (a) the reduced float32 hubert (full width,
    2 layers), the card against the CPU one step at a time from the
    CPU's state (``train_walk``), ENC_REF_STEPS steps of 4 x 32 frames;
    (b) ``run_training`` on hubert at published depth and width, 4 x
    256 frames, ENC_TRAIN_STEPS steps with a checkpoint at the last:
    finite losses, launches as derived, step ms, peak memory; (c)
    ``restore=True`` to one more step: resumes there, the restored tree
    bitwise (b)'s; (d) one ``Engine.train_step`` at 2 x 2,048 frames on
    (b)'s weights, through the D-80 non-causal flash_attention forward
    and backward: finite loss, launches as derived.  (b)-(d) under the
    shape taps."""
    import shutil
    import tempfile
    from repro_torch.launch.train import init_weights, run_training
    cfg = _enc_reduced(get_config)
    cpu = make_engine(cfg, device="cpu")
    params, lora = init_weights(cpu, 0)
    _, losses, worst = train_walk(make_engine, cfg, params,
                                  (lora, cpu.optimizer.init(lora)),
                                  _enc_batches(cfg, ENC_REF_STEPS))
    emit("train_encoder_reduced", reduced_config="hubert-xlarge, 2 layers, "
         "float32", batch=[4, 32], steps=ENC_REF_STEPS,
         loss_rtol=TRAIN_LOSS_RTOL, lora_atol=TRAIN_LORA_ATOL,
         m_tol=TRAIN_M_TOL, v_tol=TRAIN_V_TOL, walk=worst,
         first_loss=losses[0], last_loss=losses[-1])
    res = {"reduced": {"walk": worst, "losses": losses}}
    del params, lora, cpu
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ENC_ARCH)
    rows, seq = ENC_TRAIN
    tmp = tempfile.mkdtemp()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(lm, fa.flash_attention_fwd, fa.flash_attention_backward)
        with TrainTap() as tap, AttnShapeTap() as attn, \
                LoraShapeTap() as ltap:              # main path starts
            out_b = run_training(ENC_ARCH, smoke=False,
                                 steps=ENC_TRAIN_STEPS, batch=rows, seq=seq,
                                 ckpt_dir=tmp, ckpt_every=ENC_CKPT_EVERY,
                                 verbose=False, device="cuda")
        launches = {"lora_matmul": lm.launches,
                    "flash_attention": fa.flash_attention_fwd.launches,
                    "flash_attention_backward":
                        fa.flash_attention_backward.launches}
        peak = torch.cuda.max_memory_allocated()       # path ends
        want = {"lora_matmul": ENC_TRAIN_STEPS * (n_lora + n_lora_bwd),
                "flash_attention": 0, "flash_attention_backward": 0}
        with TrainTap() as tap_c, LoraShapeTap() as ltap_c:
            out_c = run_training(ENC_ARCH, smoke=False,
                                 steps=ENC_TRAIN_STEPS + 1, batch=rows,
                                 seq=seq, ckpt_dir=tmp, restore=True,
                                 ckpt_every=ENC_CKPT_EVERY, verbose=False,
                                 device="cuda")
        restored = tap_c.restored[0]
        bitwise = _bitwise(restored[0], out_b["lora"])
        # (d) one step at 2 x 2,048 frames on (b)'s weights and adapters
        eng = make_engine(get_config(ENC_ARCH), lr=TRAIN_ADAMW[0],
                          device="cuda")
        p0, _ = init_weights(eng, 0)
        fb, fs = ENC_FLASH_TRAIN
        gen = torch.Generator(device="cuda").manual_seed(7)
        batch = {"embeds": torch.randn((fb, fs, eng.model.cfg.d_model),
                                       generator=gen, device="cuda"),
                 "labels": torch.randint(0, eng.model.cfg.vocab_size,
                                         (fb, fs), generator=gen,
                                         device="cuda"),
                 "mask": torch.ones((fb, fs), device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(lm, fa.flash_attention_fwd, fa.flash_attention_backward)
        with AttnShapeTap() as attn_d, LoraShapeTap() as ltap_d:
            t0 = time.perf_counter()
            _, _, met = eng.train_step(p0, out_b["lora"],
                                       eng.optimizer.init(out_b["lora"]),
                                       batch)
            d_loss = float(met["ce_loss"])
            d_ms = (time.perf_counter() - t0) * 1e3
        d_launches = {"lora_matmul": lm.launches,
                      "flash_attention": fa.flash_attention_fwd.launches,
                      "flash_attention_backward":
                          fa.flash_attention_backward.launches}
        d_peak = torch.cuda.max_memory_allocated()
        d_want = {"lora_matmul": n_lora + n_lora_bwd,
                  "flash_attention": n_layers,
                  "flash_attention_backward": FLASH_BWD * n_layers}
        row = {"arch": ENC_ARCH, "n_layers": n_layers,
               "batch": [rows, seq], "steps": out_b["steps"],
               "losses": out_b["losses"], "launches": launches,
               "launches_derived": want, "max_memory_allocated_bytes": peak,
               **tap.row(), "attention_shapes": attn.summary(),
               "lora_shapes": lora_summary(ltap),
               "restart_steps": out_c["steps"],
               "restart_losses": out_c["losses"],
               "restored_bitwise": bitwise,
               "restored_adamw_step": int(restored[1].step),
               "flash_train": {"batch": [fb, fs], "ce_loss": d_loss,
                               "step_ms_first_call": d_ms,
                               "launches": d_launches,
                               "launches_derived": d_want,
                               "max_memory_allocated_bytes": d_peak,
                               "attention_shapes": attn_d.summary(),
                               "lora_shapes": lora_summary(ltap_d)}}
        emit("train_encoder", **row)
        require_checked("train_encoder (b, c, d)", attn, ltap, ltap_c,
                        attn_d, ltap_d)
        if not (out_b["steps"] == ENC_TRAIN_STEPS
                and np.isfinite(out_b["losses"]).all()):
            raise AssertionError(f"train_encoder (b): {row}")
        if launches != want:
            raise AssertionError(f"train_encoder (b): launches {launches}, "
                                 f"derived {want}")
        if not (bitwise and row["restored_adamw_step"] == ENC_TRAIN_STEPS
                and out_c["steps"] == ENC_TRAIN_STEPS + 1
                and len(out_c["losses"]) == 1
                and np.isfinite(out_c["losses"]).all()):
            raise AssertionError(f"train_encoder (c): {row}")
        if not (math.isfinite(d_loss) and d_launches == d_want):
            raise AssertionError(f"train_encoder (d): loss {d_loss}, "
                                 f"launches {d_launches}, derived {d_want}")
        res["cli"] = row
        del eng, p0, batch, out_b, out_c, restored, tap, tap_c
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ------------------------------------------------------------ VLM serving -
def _vlm_full(make_engine, get_config):
    """llama-3.2-vision-90b at published width, depth cut to VLM_LAYERS
    (whole units), bf16 random weights from a seed, gates at 0.5."""
    import dataclasses
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    engine = make_engine(cfg, lr=3e-3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = engine.model.init(gen)
    _open_gates(params)
    return engine, params, engine.model.init_lora(gen), gen


def phase_serve_vlm(make_engine, get_config, pda, lm, fa, seg, scan, dattn):
    """VLM serving through the engine API (the batcher refuses VLM stacks,
    as in the reference): 16 requests on 8 slots in two waves, each an
    ``Engine.prefill_step`` of 8 32-token prompts with their own vision
    inputs (random patch embeddings [8, 1,601, 8,192] from a seed, the
    stub frontend's), the caches copied into decode caches, then 15
    greedy ``Engine.decode_step``s.  Launches exactly as derived:
    decode_attention once per unit per decode step, the paged kernel
    once per dense block per decode step, lora_matmul once per adapter
    projection per prefill wave and decode step.  Then one unit's
    cross-attention at decode through the kernel against the dense
    non-causal attention on the same q/K/V (bf16, 2e-2)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import attention_dense
    n_requests, slots, plen, gen_tokens = 16, 8, 32, 16
    torch.cuda.empty_cache()
    engine, params, lora, gen = _vlm_full(make_engine, get_config)
    model, cfg = engine.model, engine.model.cfg
    units, per = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=plen, seed=0)
    prompts = torch.as_tensor(data.sample_tokens(n_requests)[:, :plen],
                              device="cuda")
    visions = [torch.randn((slots, cfg.vision_tokens, cfg.d_model),
                           generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for _ in range(n_requests // slots)]
    steps = gen_tokens - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(pda, lm, fa.flash_attention_fwd, seg, scan, dattn)  # path starts
    t_start = time.perf_counter()
    tokens, ttft_ms, tick_ms = [], [], []
    for w, vis in enumerate(visions):
        t0 = time.perf_counter()
        logits, pre = engine.prefill_step(
            params, lora, {"tokens": prompts[w * slots:(w + 1) * slots],
                           "vision": vis})
        tok = logits[:, -1].argmax(-1)
        caches = _vlm_decode_caches(model, pre, slots, plen + steps)
        del pre, logits
        torch.cuda.synchronize()
        ttft_ms.append((time.perf_counter() - t0) * 1e3)
        wave = [tok]
        t0 = time.perf_counter()
        for s in range(steps):
            pos = torch.full((slots,), plen + s, dtype=torch.int32,
                             device="cuda")
            logits, caches = engine.decode_step(params, lora, caches,
                                                tok[:, None], pos)
            tok = logits[:, -1].argmax(-1)
            wave.append(tok)
        finite = bool(torch.isfinite(logits).all())
        tick_ms.append((time.perf_counter() - t0) / steps * 1e3)
        tokens += torch.stack(wave, 1).tolist()
        if not finite:
            raise AssertionError(f"serve_vlm wave {w}: logits not finite")
    wall = time.perf_counter() - t_start
    launches = {"decode_attention": dattn.launches,
                "paged_decode_attention": pda.launches,
                "lora_matmul": lm.launches,
                "flash_attention": fa.flash_attention_fwd.launches,
                "segmented_lora_matmul": seg.launches,
                "ssd_scan": scan.launches}                    # path ends
    waves = len(visions)
    want = {"decode_attention": units * steps * waves,
            "paged_decode_attention": units * per * steps * waves,
            "lora_matmul": 4 * units * per * (steps + 1) * waves,
            "flash_attention": 0, "segmented_lora_matmul": 0, "ssd_scan": 0}
    peak = torch.cuda.max_memory_allocated()

    # one unit's cross-attention at decode: the kernel against the dense
    # non-causal attention on the same q/K/V
    cp = {k: v[0] for k, v in params["cross"]["attn"].items()}
    vkv = (caches["cross_kv"][0][0], caches["cross_kv"][1][0])
    x = torch.randn((slots, 1, cfg.d_model), generator=gen, device="cuda",
                    dtype=cp["wq"].dtype)
    with torch.no_grad():
        got = tfm.cross_attn(cp, x, vkv, cfg)
        q = (x @ cp["wq"]).reshape(slots, 1, cfg.n_heads, cfg.head_dim)
        o = attention_dense(q, *vkv, causal=False)
        want_o = o.reshape(slots, 1, -1) @ cp["wo"]
    cross_err = float((got.float() - want_o.float()).abs().max()
                      / want_o.float().abs().max())
    row = {
        "arch": VLM_ARCH, "n_layers": cfg.n_layers, "units": units,
        "dense_blocks_per_unit": per, "vision_tokens": cfg.vision_tokens,
        "gates": 0.5, "requests": n_requests, "slots": slots,
        "prompt_len": plen, "gen_tokens": gen_tokens, "prefill_waves": waves,
        "decode_steps": steps * waves,
        "finished": sum(len(t) == gen_tokens for t in tokens),
        "tokens_generated": sum(len(t) for t in tokens),
        "throughput_tok_s": sum(len(t) for t in tokens) / wall,
        "wall_s": wall, "prefill_wave_ms": ttft_ms,
        "host_ms_per_decode_tick": tick_ms,
        "max_memory_allocated_bytes": peak,
        "launches": launches, "launches_derived": want,
        "cross_attn_kernel_vs_dense_rel_err": cross_err,
        "cross_attn_tol": 2e-2,
    }
    emit("serve_vlm", **row)
    if row["finished"] != n_requests:
        raise AssertionError("serve_vlm: not every request finished")
    if launches != want:
        raise AssertionError(f"serve_vlm: launches {launches}, derived "
                             f"{want}")
    if not cross_err < 2e-2:
        raise AssertionError(f"serve_vlm: cross-attention through the "
                             f"kernel {cross_err} from the dense path")
    del caches, visions, vkv, x, got, o
    # combined_vlm, the next phase, co-trains on these weights: one draw
    # of the 38.4 GB tree serves both
    _VLM_WEIGHTS["full"] = (engine, params, lora, gen)
    del engine, params, lora
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------- VLM co-training --
_VLM_WEIGHTS = {}       # serve_vlm's full-width weights, for combined_vlm
VLM_TRAIN = (4, 32)     # the co-training batch: rows x tokens
VLM_COMBINED_STEPS = 3
VLM_CLI_STEPS = 2
VLM_GRAD_REL = 1e-4     # tests/test_torch_train.py's LoRA gradient bound


def _vlm_grads_reference(get_config, make_engine):
    """The reduced float32 VLM (2 units of 2 dense blocks and a cross
    block, 37 vision tokens), both gates at 0.5: the LoRA gradients of
    one batch through ``Engine.loss_and_grads``, the card against the
    CPU, within VLM_GRAD_REL of each leaf's largest magnitude; the loss
    within TRAIN_LOSS_RTOL."""
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(VLM_ARCH).scaled(n_layers=6, cross_attn_every=3,
                                      vision_tokens=37)
    cpu = make_engine(cfg, device="cpu")
    params = cpu.model.init(torch.Generator().manual_seed(0))
    _open_gates(params)
    lora = cpu.model.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    batch = train_batches(cfg, 1, seq=10, rows=2)[0]
    batch["vision"] = np.random.default_rng(3).standard_normal(
        (2, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    out = {}
    for name, eng in (("cpu", cpu), ("cuda", make_engine(cfg,
                                                         device="cuda"))):
        dev = eng.model.device
        loss, _, grads = eng.loss_and_grads(
            tree_map(lambda t: t.to(dev), params),
            tree_map(lambda t: t.to(dev), lora),
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        out[name] = (float(loss), [g.cpu() for g in tree_leaves(grads)])
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    grad_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                   for a, b in zip(gg, gc))
    row = {"reduced_config": cfg.name, "dtype": "float32", "gates": 0.5,
           "vision_tokens": cfg.vision_tokens, "batch": [2, 10],
           "loss_rel_err": abs(lg - lc) / abs(lc), "loss_rtol":
           TRAIN_LOSS_RTOL, "grad_rel_err": grad_err,
           "grad_rel_tol": VLM_GRAD_REL}
    emit("combined_vlm_reference", **row)
    if not (row["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and grad_err < VLM_GRAD_REL):
        raise AssertionError(f"combined_vlm: card vs CPU gradients: {row}")
    return row


def phase_combined_vlm(make_engine, get_config, pda, lm, fa, seg, dattn):
    """VLM co-training on serve_vlm's weights (llama-3.2-vision-90b at
    published width, VLM_LAYERS of 100 layers, bf16, gates 0.5): a
    prefill of 8 32-token prompts with their vision inputs fills 8
    decode slots, then VLM_COMBINED_STEPS ``Engine.combined_step``s,
    each a decode tick over the slots (``decode_step``: the paged kernel
    per dense block, ``decode_attention`` per cross block) and an AdamW
    step on a 4 x 32 batch with vision [4, 1,601, 8,192] (the cross
    attention dense under autograd, as the reference computes it): the
    first tick's logits equal a plain ``decode_step``'s with the
    pre-update adapter, losses and logits finite, launches as derived;
    then ``launch/train.py``'s loop (``train_from_weights``, zero vision
    inputs as the reference's CLI) for VLM_CLI_STEPS steps; then the
    reduced float32 VLM's gradients card against CPU."""
    from repro_torch.launch.train import train_from_weights
    if "full" not in _VLM_WEIGHTS:          # named alone (bring-up)
        engine, params, lora, gen = _vlm_full(make_engine, get_config)
    else:
        engine, params, lora, gen = _VLM_WEIGHTS.pop("full")
    model, cfg = engine.model, engine.model.cfg
    units, per = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    slots, plen, steps = 8, 32, VLM_COMBINED_STEPS
    rows, seq = VLM_TRAIN
    n_dense = units * per
    n_lora = len(cfg.lora.targets) * n_dense   # adapter projections
    prompts = torch.randint(0, cfg.vocab_size, (slots, plen), generator=gen,
                            device="cuda")
    vis = torch.randn((slots, cfg.vision_tokens, cfg.d_model),
                      generator=gen, device="cuda", dtype=torch.bfloat16)
    logits, pre = engine.prefill_step(params, lora, {"tokens": prompts,
                                                     "vision": vis})
    tok = logits[:, -1].argmax(-1)
    caches = _vlm_decode_caches(model, pre, slots, plen + steps)
    del pre, vis, logits
    data_gen = torch.Generator(device="cuda").manual_seed(5)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (rows, seq),
                                        generator=data_gen, device="cuda"),
                "labels": torch.randint(0, cfg.vocab_size, (rows, seq),
                                        generator=data_gen, device="cuda"),
                "mask": torch.ones((rows, seq), device="cuda"),
                "vision": torch.randn((rows, cfg.vision_tokens, cfg.d_model),
                                      generator=data_gen, device="cuda",
                                      dtype=torch.bfloat16)}
               for _ in range(steps)]
    # the first tick's decode alone, with the pre-update adapter, on a
    # copy of the caches: the combined step's logits must equal it
    with torch.no_grad():
        plain, _ = model.decode_step(
            params, lora, {k: tuple(t.clone() for t in v)
                           for k, v in caches.items()},
            tok[:, None], torch.full((slots,), plen, dtype=torch.int32,
                                     device="cuda"))
    opt = engine.optimizer.init(lora)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(pda, lm, fa.flash_attention_fwd, fa.flash_attention_backward,
           seg, dattn)                                 # main path starts
    losses, step_ms, first = [], [], None
    with LoraShapeTap() as ltap:
        for s in range(steps):
            t0 = time.perf_counter()
            pos = torch.full((slots,), plen + s, dtype=torch.int32,
                             device="cuda")
            lora, opt, logits, caches, met = engine.combined_step(
                params, lora, opt, batches[s], caches, tok[:, None], pos)
            losses.append(float(met["ce_loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = logits
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"combined_vlm step {s}: logits not "
                                     "finite")
            tok = logits[:, -1].argmax(-1)
    launches = {"decode_attention": dattn.launches,
                "paged_decode_attention": pda.launches,
                "lora_matmul": lm.launches,
                "flash_attention": fa.flash_attention_fwd.launches,
                "flash_attention_backward":
                    fa.flash_attention_backward.launches,
                "segmented_lora_matmul": seg.launches}  # path ends
    peak = torch.cuda.max_memory_allocated()
    # a tick: 4 adapter projections per dense block; a train step: those
    # forward and their dX, but layer 0's q, k, v (its input is frozen)
    want = {"decode_attention": units * steps,
            "paged_decode_attention": n_dense * steps,
            "lora_matmul": (n_lora + n_lora + n_lora - 3) * steps,
            "flash_attention": 0, "flash_attention_backward": 0,
            "segmented_lora_matmul": 0}
    first_vs_plain = bool(torch.equal(first, plain))
    del batches, plain, first, logits
    with TrainTap() as tap, LoraShapeTap() as ltap_cli:
        cli = train_from_weights(engine, params, lora, arch=VLM_ARCH,
                                 steps=VLM_CLI_STEPS, batch=rows, seq=seq,
                                 verbose=False)
    row = {"arch": VLM_ARCH, "n_layers": cfg.n_layers,
           "n_layers_published": 100, "units": units,
           "dense_blocks_per_unit": per, "vision_tokens": cfg.vision_tokens,
           "gates": 0.5, "slots": slots, "prompt_len": plen,
           "train_batch": [rows, seq], "combined_steps": steps,
           "losses": losses, "step_ms": step_ms,
           "first_tick_logits_equal_plain_decode": first_vs_plain,
           "launches": launches, "launches_derived": want,
           "max_memory_allocated_bytes": peak,
           "lora_shapes": lora_summary(ltap),
           "cli_steps": cli["steps"], "cli_losses": cli["losses"],
           "cli_step_ms": tap.row()["step_ms"],
           "cli_lora_shapes": lora_summary(ltap_cli)}
    emit("combined_vlm", **row)
    require_checked("combined_vlm", ltap, ltap_cli)
    if not (np.isfinite(losses).all() and np.isfinite(cli["losses"]).all()
            and cli["steps"] == VLM_CLI_STEPS):
        raise AssertionError(f"combined_vlm: a loss not finite: {row}")
    if not first_vs_plain:
        raise AssertionError("combined_vlm: the combined step's logits are "
                             "not the pre-update adapter's decode")
    if launches != want:
        raise AssertionError(f"combined_vlm: launches {launches}, derived "
                             f"{want}")
    del engine, params, lora, opt, caches, cli, tap
    torch.cuda.empty_cache()
    row["reference"] = _vlm_grads_reference(get_config, make_engine)
    return row


# ------------------------------------------------------------ combined ----
COMBINED_RUNS = [
    ("paged", ARCH, 4, dict(paged=True, prompt_len=32, gen_tokens=16)),
    ("contiguous", ARCH, 4, dict(paged=False, prompt_len=32,
                                 gen_tokens=16)),
    ("paged_992", ARCH, 4, dict(paged=True, prompt_len=992, gen_tokens=16)),
    ("paged_2048", ARCH, 4, dict(paged=True, prompt_len=2048,
                                 gen_tokens=16)),
    ("llama_paged_2048", "llama3-8b", 1, dict(paged=True, prompt_len=2048,
                                              gen_tokens=16)),
]


def phase_combined(run_serving, get_config, pda, lm, fa, seg):
    """Serving while co-training the adapter on every tick (a fresh
    train batch of ``train_batch`` x prompt length rows)."""
    results = {}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    for name, arch, tbatch, kw in COMBINED_RUNS:
        n_layers, n_lora, n_lora_bwd = arch_counts(get_config, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, bwd, seg)                    # main path starts
        out = run_serving(arch, smoke=False, n_requests=16, batch_size=8,
                          combined=True, train_batch=tbatch, seed=0,
                          device="cuda", verbose=False, **kw)
        if seg.launches:
            raise AssertionError(f"combined {name}: {seg.launches} "
                                 "segmented launches with one adapter")
        launches, lora_launches = pda.launches, lm.launches
        flash, flash_bwd = fwd.launches, bwd.launches     # path ends
        gen, losses = kw["gen_tokens"], out["train_losses"]
        want = (n_lora * out["prefill_waves"] + n_lora * out["decode_steps"]
                + (n_lora + n_lora_bwd) * out["train_steps"])
        long = long_prompt(kw["prompt_len"])
        flash_want = n_layers * (out["prefill_waves"] + out["train_steps"]) \
            if long else 0
        flash_bwd_want = FLASH_BWD * n_layers * out["train_steps"] \
            if long else 0
        row = {
            "run": name, "arch": arch, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen, "train_batch": [tbatch, kw["prompt_len"]],
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": out["decode_steps"],
            "prefill_waves": out["prefill_waves"],
            "train_steps": out["train_steps"],
            "lora_matmul_launches": lora_launches,
            "lora_matmul_launches_derived": want,
            "attention_launches": launches,
            "flash_attention_launches": flash,
            "flash_attention_launches_derived": flash_want,
            "flash_attention_backward_launches": flash_bwd,
            "flash_attention_backward_launches_derived": flash_bwd_want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
        }
        if kw["paged"]:
            row.update(blocks_used_at_end=out["blocks_used_at_end"],
                       blocks_reserved_at_end=out["blocks_reserved_at_end"])
        emit("combined", **row)
        if out["finished"] != 16 or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"combined {name}: not every request "
                                 "finished")
        # every tick had an active slot, so ticks == decode steps
        if out["train_steps"] != out["decode_steps"] \
                or len(losses) != out["train_steps"]:
            raise AssertionError(f"combined {name}: {out['train_steps']} "
                                 f"train steps for {out['decode_steps']} "
                                 "ticks")
        if not np.isfinite(losses).all():
            raise AssertionError(f"combined {name}: non-finite loss")
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            raise AssertionError(f"combined {name}: allocator did not "
                                 "drain")
        if lora_launches != want:
            raise AssertionError(f"combined {name}: {lora_launches} "
                                 f"lora_matmul launches, derived {want}")
        if launches != n_layers * out["decode_steps"]:
            raise AssertionError(f"combined {name}: {launches} attention "
                                 "launches")
        if (flash, flash_bwd) != (flash_want, flash_bwd_want):
            raise AssertionError(
                f"combined {name}: flash_attention launches {flash} / "
                f"{flash_bwd}, derived {flash_want} / {flash_bwd_want}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------- prefix cache, chunks, budget -
PREFIX_HEAD, PREFIX_GEN, CHUNK = 768, 32, 256


def prefix_trace(vocab, paired=False, seed=7):
    """16 prompts of two families sharing a 768-token prefix (48 blocks of
    16), each with a tail of 32 to 224 tokens (prompts of 800 to 992).
    Request i takes family i % 2 and tail i; ``paired``: requests 2k and
    2k + 1 take tail k and family k % 2 (identical prompts)."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, vocab, (2, PREFIX_HEAD))
    lens = rng.permutation(np.linspace(32, 224, 16).astype(int))
    tails = [rng.integers(0, vocab, n) for n in lens]
    out = []
    for i in range(16):
        k = i // 2 if paired else i
        out.append(np.concatenate([heads[k % 2], tails[k]]).astype(np.int32))
    return out


def full_engine(make_engine, get_config, arch, seed=0):
    """A full-width engine and its random weights from ``seed``, drawn as
    ``run_serving`` draws them (params, then the adapter: b = 0)."""
    eng = make_engine(get_config(arch), lr=3e-3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = eng.model.init(gen)
    return eng, params, eng.model.init_lora(gen)


def _rel(a, b):
    """max |a - b| over the largest |b| (float32)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def serve_tapped(eng, params, lora, prompts, gen, *, registry=None,
                 aids=None, **kw):
    """``ContinuousBatcher.run`` over ``prompts`` on 8 slots, with taps on
    its prefill programs and admissions: each request's first-token
    logits (the row its monolithic or suffix wave, or its final chunk,
    computed), each wave's time between CUDA events around its program
    (the host runs ahead of the card, so the later of its host and device
    work), and each admission's blocks and matched-block count.  Returns
    (batcher, requests, stats, first logits by request id, {wave kind:
    [ms]}, admissions)."""
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    pad = max(len(p) for p in prompts)
    b = ContinuousBatcher(eng, params, lora, n_slots=8, max_seq=pad + gen,
                          prompt_pad=pad, adapters=registry, **kw)
    first, events, admitted = {}, [], []
    wave, chunk, admit = b._prefill_wave, b._chunk_wave, b.admit

    def timed(kind, fn, *args):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = fn(*args)
        e.record()
        events.append((kind, s, e))
        return out

    def tap_wave(reqs, matched=None):
        kind = "suffix" if matched is not None and any(matched) else "full"
        firsts, pre, last = timed(kind, wave, reqs, matched)
        for r, row in zip(reqs, last):
            first[r.request_id] = row.float()
        return firsts, pre, last

    def tap_chunk(rows, pre_lens):
        logits = timed("chunk", chunk, rows, pre_lens)
        for j, (i, _) in enumerate(rows):   # the final chunk's row stays
            first[b.slot_req[i].request_id] = logits[j, -1].float()
        return logits

    def tap_admit(now=0.0):
        held = set(b.active_slots())
        out = admit(now)
        for i in b.active_slots():
            if i not in held and b.paged:
                admitted.append((b.slot_req[i], list(b.slot_blocks[i]),
                                 int(b.slot_cached[i]) // b.block_size))
        return out

    b._prefill_wave, b._chunk_wave, b.admit = tap_wave, tap_chunk, tap_admit
    reqs = [GenRequest(request_id=i, prompt=p, max_new_tokens=gen,
                       adapter_id=aids[i] if aids else None)
            for i, p in enumerate(prompts)]
    stats = b.run(reqs)
    # the taps close over the batcher: drop them, so the batcher (and the
    # weights and pool it holds) dies with the caller's last reference
    del b._prefill_wave, b._chunk_wave, b.admit
    torch.cuda.synchronize()
    times = {}
    for kind, s, e in events:
        times.setdefault(kind, []).append(s.elapsed_time(e))
    return b, reqs, stats, first, times, admitted


def cross_tenant_hits(admitted):
    """Aliased blocks that a request of another tenant wrote, replaying
    the admissions in order: each request's fresh blocks belong to its
    tenant from then on, and each of its matched blocks must already
    belong to it."""
    owner, crossed = {}, 0
    for req, blocks, matched in admitted:
        crossed += sum(owner.get(blk) != req.adapter_id
                       for blk in blocks[:matched])
        owner.update((blk, req.adapter_id) for blk in blocks[matched:])
    return crossed


def serve_row(name, arch, b, reqs, stats, times, gen, launches):
    """One result line of a tapped run and its checks: every request
    finished, the allocator drained (no block used or reserved, free and
    retained blocks the whole pool)."""
    row = {"run": name, "arch": arch, "finished": stats.finished,
           "decode_steps": stats.decode_steps,
           "prefill_waves": b.prefill_waves,
           "prefill_tokens_computed": stats.prefill_tokens,
           "cached_prefix_tokens": stats.cached_prefix_tokens,
           "throughput_tok_s": stats.throughput(), "wall_s": stats.wall_time,
           **latency_percentiles({"ttft_s": stats.ttft,
                                  "tpot_s": stats.tpot}),
           "wave_ms_mean": {k: statistics.mean(v) for k, v in times.items()},
           "waves": {k: len(v) for k, v in times.items()},
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    if b.paged:
        a = b.allocator
        row.update(peak_used_blocks=a.peak_used, pool_blocks=a.capacity,
                   blocks_used_at_end=a.n_used,
                   blocks_reserved_at_end=a.reserved,
                   blocks_free_at_end=a.n_free,
                   blocks_retained_at_end=a.n_retained)
    if b.prefix_cache is not None:
        row.update(prefix_cache_hits=b.prefix_cache.hits,
                   prefix_cache_misses=b.prefix_cache.misses,
                   prefix_cache_reclaimed=b.prefix_cache.reclaimed)
    if stats.finished != 16 or any(len(r.tokens) != gen for r in reqs):
        raise AssertionError(f"{name}: not every request finished")
    if b.paged and (b.allocator.n_used or b.allocator.reserved
                    or b.allocator.n_free + b.allocator.n_retained
                    != b.allocator.capacity):
        raise AssertionError(f"{name}: allocator did not drain")
    return row


def serve_launches(pda, lm, seg, fwd):
    return {"paged_decode_attention": pda.launches, "lora_matmul":
            lm.launches, "segmented_lora_matmul": seg.launches,
            "flash_attention": fwd.launches}


def check_launches(name, got, want):
    if got != want:
        raise AssertionError(f"{name}: launches {got}, derived {want}")


def phase_serve_prefix(make_engine, get_config, pda, lm, fa, seg):
    """Prefix caching at full width: qwen1.5-0.5b paged (blocks of 16),
    16 requests on 8 slots, two families sharing a 768-token prefix,
    tails of 32 to 224 tokens (prompt_pad 992: dense prefill), 32 tokens
    each, with the cache off and on; the same trace off and on for
    llama3-8b (GQA 4:1, head_dim 128); and with 4 tenants tagged
    round-robin, each pair of identical prompts to two tenants.  Every
    request finishes, the
    allocator drains, the cache hits, launches exactly as derived
    (lora_matmul, or with tenants segmented_lora_matmul, once per adapter
    projection per prefill wave and decode step; the decode kernel once
    per layer per step; flash_attention never), each request's first-token
    logits with the cache on within 2e-2 of the largest with it off
    (bf16), and no request aliases a block another tenant wrote."""
    from repro_torch.runtime.fabric import make_tenant_adapters
    from repro_torch.runtime.serving_loop import AdapterRegistry
    fwd = fa.flash_attention_fwd
    results = {}
    for arch, runs in ((ARCH, ("off", "on", "tenants")),
                       ("llama3-8b", ("off", "on"))):
        n_layers, n_lora, _ = arch_counts(get_config, arch)
        eng, params, lora = full_engine(make_engine, get_config, arch)
        for run in runs:
            tenants = run == "tenants"
            registry = aids = None
            if tenants:
                registry = AdapterRegistry(eng.model, capacity=4)
                for t, tree in enumerate(make_tenant_adapters(
                        eng.model, 4, seed=1)):
                    registry.register(f"tenant{t}", tree)
                aids = [f"tenant{i % 4}" for i in range(16)]
            prompts = prefix_trace(eng.model.cfg.vocab_size, paired=tenants)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(pda, lm, fwd, seg)                     # main path starts
            b, reqs, stats, first, times, admitted = serve_tapped(
                eng, params, lora, prompts, PREFIX_GEN, registry=registry,
                aids=aids, paged=True, block_size=16,
                prefix_cache=run != "off")
            got = serve_launches(pda, lm, seg, fwd)       # path ends
            name = run if arch == ARCH else f"llama_{run}"
            per = n_lora * (b.prefill_waves + stats.decode_steps)
            check_launches(f"serve_prefix {name}", got, {
                "paged_decode_attention": n_layers * stats.decode_steps,
                "lora_matmul": 0 if tenants else per,
                "segmented_lora_matmul": per if tenants else 0,
                "flash_attention": 0})
            row = serve_row(name, arch, b, reqs, stats, times, PREFIX_GEN,
                            got)
            results[name] = (row, [r.tokens for r in reqs], first)
            if run != "off" and not b.prefix_cache.hits:
                raise AssertionError(f"serve_prefix {name}: no cache hit")
            if tenants:
                row["cross_tenant_aliased_blocks"] = \
                    cross_tenant_hits(admitted)
                row["adapter_refs_at_end"] = sum(
                    registry.refcount(a) for a in registry.registered())
                if row["cross_tenant_aliased_blocks"] \
                        or row["adapter_refs_at_end"]:
                    raise AssertionError(
                        "serve_prefix tenants: a request aliased another "
                        "tenant's blocks, or an adapter ref leaked")
            if run == "on":
                off_row, off_tok, off_first = results[
                    name.replace("on", "off")]
                errs = [_rel(first[i], off_first[i]) for i in range(16)]
                row.update(
                    first_logits_rel_err_vs_off=max(errs), tol=2e-2,
                    identical_token_streams_vs_off=sum(
                        t == o for t, o in zip(results[name][1], off_tok)),
                    prefill_tokens_computed_off=off_row[
                        "prefill_tokens_computed"])
                if max(errs) >= 2e-2:
                    raise AssertionError(
                        f"serve_prefix {name}: first-token logits with the "
                        f"cache on {max(errs)} from off, beyond 2e-2")
            emit("serve_prefix", **row)
            del b, first, registry
            torch.cuda.empty_cache()
        del eng, params, lora
        torch.cuda.empty_cache()
    return {k: v[0] for k, v in results.items()}


def phase_serve_chunked(make_engine, get_config, pda, lm, fa, seg):
    """Chunked prefill at full width: qwen1.5-0.5b, the serve phase's
    992 + 32 traffic (16 synthetic prompts on 8 slots), paged (blocks of
    16) and contiguous, prefill_chunk 256 against monolithic.  Every
    request finishes, the allocator drains, launches exactly as derived
    (a chunk wave is a prefill wave), and each request's final-chunk
    logits within 2e-2 of the largest of its monolithic prefill's."""
    from repro_torch.data.synthetic import SyntheticDataset
    fwd = fa.flash_attention_fwd
    n_layers, n_lora, _ = arch_counts(get_config, ARCH)
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                            seq_len=992, seed=0)
    prompts = list(data.sample_tokens(16)[:, :992].astype(np.int32))
    results = {}
    for paged in (True, False):
        for chunk in (0, CHUNK):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(pda, lm, fwd, seg)                     # main path starts
            b, reqs, stats, first, times, _ = serve_tapped(
                eng, params, lora, prompts, 32, paged=paged,
                prefill_chunk=chunk)
            got = serve_launches(pda, lm, seg, fwd)       # path ends
            name = f"{'paged' if paged else 'contiguous'}_" \
                f"{'chunk256' if chunk else 'monolithic'}"
            check_launches(f"serve_chunked {name}", got, {
                "paged_decode_attention": n_layers * stats.decode_steps,
                "lora_matmul": n_lora * (b.prefill_waves
                                         + stats.decode_steps),
                "segmented_lora_matmul": 0, "flash_attention": 0})
            row = serve_row(name, ARCH, b, reqs, stats, times, 32, got)
            results[(paged, chunk)] = (row, [r.tokens for r in reqs], first)
            if chunk:
                mono_tok, mono_first = results[(paged, 0)][1:]
                errs = [_rel(first[i], mono_first[i]) for i in range(16)]
                row.update(final_chunk_logits_rel_err_vs_monolithic=max(
                    errs), tol=2e-2, identical_token_streams_vs_monolithic=sum(
                        t == o for t, o in zip(results[(paged, chunk)][1],
                                               mono_tok)))
                if max(errs) >= 2e-2:
                    raise AssertionError(
                        f"serve_chunked {name}: final-chunk logits "
                        f"{max(errs)} from monolithic, beyond 2e-2")
            emit("serve_chunked", **row)
            del b, first
            torch.cuda.empty_cache()
    return {k: v[0] for k, v in results.items()}


# oversubscription at full width: 16 requests on 8 slots, 64-token
# prompts, 64 tokens each (max_seq 128: a request's worst case is 8
# blocks of 16, so 64 blocks hold 8 slots and 40 hold 5); pools in
# blocks, scratch block 0 not counted
OVERSUB_PROMPT, OVERSUB_GEN, OVERSUB_SWAP_CHAIN = 64, 64, 62
OVERSUB_RUNS = [
    ("a_pool64", ARCH, 64, {}),             # every slot's worst case fits
    ("b_pool40", ARCH, 40, {}),             # admission holds 5 slots
    ("c_pool40_swap", ARCH, 40, dict(oversubscribe=1.0)),
    ("c_pool40_swap_sanitized", ARCH, 40, dict(oversubscribe=1.0)),
    ("d_pool40_drop", ARCH, 40, dict(oversubscribe=1.0, swap=False)),
    ("e_llama_pool40_swap", "llama3-8b", 40, dict(oversubscribe=1.0)),
]


def swap_round_trip(model, pda, pda_ref, reps=5):
    """A 62-block chain of a full-width bf16 pool (random from a seed)
    through the swap path as the batcher drives it: ``gather_blocks`` and
    the copy to host memory, ``swap_out``, ``swap_in`` onto fresh ids,
    ``scatter_blocks``.  The moved blocks must equal the originals
    bitwise, and paged_decode_attention (layer 0, 8 queries over the
    chain, 769-992 rows) over the remapped table must return bitwise its
    output over the original table.  Times: the host clock around each
    direction, synchronized (median of ``reps``), and ``paged_row``'s."""
    from repro_torch.runtime.paging import BlockAllocator
    cfg, bs, nb = model.cfg, 16, OVERSUB_SWAP_CHAIN
    pool = model.init_paged_caches(2 * nb + 1, bs)
    g = torch.Generator(device="cuda").manual_seed(11)
    for t in pool["kv"]:
        for layer in t:
            layer.copy_(torch.randn(layer.shape, generator=g,
                                    device="cuda"))
    alloc = BlockAllocator(2 * nb + 1, bs)
    alloc.reserve(nb)
    chain = [int(b) for b in np.random.default_rng(11).permutation(
        alloc.take(nb))]
    outs, ins = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = tuple(t.cpu() for t in model.gather_blocks(pool, chain)["kv"])
        outs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        model.scatter_blocks(pool, chain, host)     # the same ids: a no-op
        torch.cuda.synchronize()
        ins.append(time.perf_counter() - t0)
    alloc.swap_out(chain)
    fresh = alloc.swap_in(nb)
    model.scatter_blocks(pool, fresh, host)
    torch.cuda.synchronize()
    moved_bitwise = all(torch.equal(t[:, fresh], t[:, chain])
                        for t in pool["kv"])
    block_bytes = sum(t[:, :1].numel() * t.element_size()
                      for t in pool["kv"])
    rng = np.random.default_rng(12)
    kv_len = rng.integers((nb - 14) * bs + 1, nb * bs + 1,
                          size=8).astype(np.int32)
    kv_len[0] = nb * bs
    kv_len = torch.tensor(kv_len, device="cuda")
    q = torch.randn((8, cfg.n_heads, cfg.head_dim), generator=g,
                    device="cuda").to(pool["kv"][0].dtype)
    kp, vp = pool["kv"][0][0], pool["kv"][1][0]
    orig = pda(q, kp, vp, torch.tensor([chain] * 8, dtype=torch.int32,
                                       device="cuda"), kv_len)
    tables = torch.tensor([fresh] * 8, dtype=torch.int32, device="cuda")
    out, row = paged_row(pda, pda_ref, q, kp, vp, tables, kv_len)
    swap_out_s, swap_in_s = statistics.median(outs), statistics.median(ins)
    row.update(
        blocks=nb, block_bytes=block_bytes, moved_bitwise=moved_bitwise,
        remapped_output_bitwise=bool(torch.equal(out, orig)),
        swap_out_ms_per_block=swap_out_s / nb * 1e3,
        swap_in_ms_per_block=swap_in_s / nb * 1e3,
        swap_out_gb_s=nb * block_bytes / swap_out_s / 1e9,
        swap_in_gb_s=nb * block_bytes / swap_in_s / 1e9)
    emit("serve_oversub", step="swap_round_trip", **row)
    if not (moved_bitwise and row["remapped_output_bitwise"] and row["ok"]
            and row["repeat_bitwise"]):
        raise AssertionError(f"swap round trip: {row}")
    return row


def oversub_run(eng, params, lora, prompts, n_blocks, sanitized=False,
                **kw):
    """One ``ContinuousBatcher.run`` of the oversubscription traffic
    (paged, blocks of 16, ``n_blocks`` + scratch), with taps: each
    swap-out's bytes and host seconds (as ``_SwapCost`` observes them),
    each swap-in's (``Model.scatter_blocks``, synchronized), each
    ``prefer_swap`` answer, each preemption's path, the ticks and, when
    ``sanitized`` (REPRO_SANITIZE=1 at construction), the host seconds of
    the decode-wave checks.  Returns (batcher, requests, stats, taps)."""
    from repro_torch.models.model import Model
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    if sanitized:
        os.environ["REPRO_SANITIZE"] = "1"
    try:
        b = ContinuousBatcher(eng, params, lora, n_slots=8,
                              max_seq=OVERSUB_PROMPT + OVERSUB_GEN,
                              prompt_pad=OVERSUB_PROMPT, paged=True,
                              block_size=16, n_blocks=n_blocks + 1, **kw)
    finally:
        os.environ.pop("REPRO_SANITIZE", None)
    if sanitized and b.allocator.san is None:
        raise AssertionError("serve_oversub: the sanitizer did not arm")
    taps = {"swap_out": [], "swap_in": [], "prefer_swap": [], "paths": [],
            "ticks": 0, "sanitize_s": 0.0}
    if b.swap_cost is not None:
        observe, prefer = b.swap_cost.observe_swap, b.swap_cost.prefer_swap

        def tap_observe(nbytes, dt):
            taps["swap_out"].append((nbytes, dt))
            observe(nbytes, dt)

        def tap_prefer(tail_bytes, tokens):
            taps["prefer_swap"].append(prefer(tail_bytes, tokens))
            return taps["prefer_swap"][-1]

        b.swap_cost.observe_swap = tap_observe
        b.swap_cost.prefer_swap = tap_prefer
    preempt, step, check = b._preempt, b.step, b._sanitize_wave

    def tap_preempt(i, now):
        before = b.stats.swap_out_blocks
        preempt(i, now)
        taps["paths"].append("swap" if b.stats.swap_out_blocks > before
                             else "drop")

    def tap_step(*a, **k):
        taps["ticks"] += 1
        return step(*a, **k)

    def tap_check(active):
        t0 = time.perf_counter()
        check(active)
        taps["sanitize_s"] += time.perf_counter() - t0

    scatter = Model.scatter_blocks

    def tap_scatter(self, caches, ids, host_kv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scatter(self, caches, ids, host_kv)
        torch.cuda.synchronize()
        taps["swap_in"].append((len(ids), time.perf_counter() - t0))
        return out

    b._preempt, b.step, b._sanitize_wave = tap_preempt, tap_step, tap_check
    Model.scatter_blocks = tap_scatter
    reqs = [GenRequest(request_id=i, prompt=p, max_new_tokens=OVERSUB_GEN)
            for i, p in enumerate(prompts)]
    try:
        stats = b.run(reqs)
    finally:
        Model.scatter_blocks = scatter
        del b._preempt, b.step, b._sanitize_wave
        if b.swap_cost is not None:
            del b.swap_cost.observe_swap, b.swap_cost.prefer_swap
    torch.cuda.synchronize()
    return b, reqs, stats, taps


def phase_serve_oversub(make_engine, get_config, pda, pda_ref, lm, fa, seg):
    """KV-pool oversubscription at full width: first ``swap_round_trip``
    on qwen1.5-0.5b's pool, then OVERSUB_RUNS (16 requests on 8 slots,
    64 + 64 tokens, paged in blocks of 16): qwen on 64 blocks without
    oversubscription (every slot fits), on 40 without (admission holds 5
    slots), on 40 at ``oversubscribe`` 1.0 with swap and with
    ``swap=False``, llama3-8b on 40 with swap, and qwen's swap run again
    under REPRO_SANITIZE=1.  Every request finishes, the allocator drains,
    launches exactly as derived (a re-prefill is a prefill wave; swaps
    launch no kernel; flash_attention never), the oversubscribed runs
    preempt, the swap runs swap and the drop run re-prefills; the
    sanitized run adds no report.  Per run: tok/s, TTFT / TPOT, peak
    blocks, the four counters, ``_SwapCost``'s answers and the paths
    taken, swap-out / swap-in ms per block and GB/s, streams equal to
    run (a)'s (not asserted: waves of another composition can take
    other cuBLAS kernels)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime import sanitize
    fwd = fa.flash_attention_fwd
    results, engines = {}, {}
    reports = len(sanitize.reports())
    for name, arch, n_blocks, kw in OVERSUB_RUNS:
        if arch not in engines:
            engines.clear()
            torch.cuda.empty_cache()
            engines[arch] = full_engine(make_engine, get_config, arch)
            if arch == ARCH:
                round_trip = swap_round_trip(engines[arch][0].model, pda,
                                             pda_ref)
        eng, params, lora = engines[arch]
        n_layers, n_lora, _ = arch_counts(get_config, arch)
        data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                                seq_len=OVERSUB_PROMPT, seed=0)
        prompts = list(data.sample_tokens(16)[:, :OVERSUB_PROMPT]
                       .astype(np.int32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg)                     # main path starts
        b, reqs, stats, taps = oversub_run(
            eng, params, lora, prompts, n_blocks,
            sanitized=name.endswith("sanitized"), **kw)
        got = serve_launches(pda, lm, seg, fwd)       # path ends
        check_launches(f"serve_oversub {name}", got, {
            "paged_decode_attention": n_layers * stats.decode_steps,
            "lora_matmul": n_lora * (b.prefill_waves + stats.decode_steps),
            "segmented_lora_matmul": 0, "flash_attention": 0})
        row = serve_row(name, arch, b, reqs, stats, {}, OVERSUB_GEN, got)
        out_b = sum(n for n, _ in taps["swap_out"])
        out_s = sum(dt for _, dt in taps["swap_out"])
        in_n = sum(n for n, _ in taps["swap_in"])
        in_s = sum(dt for _, dt in taps["swap_in"])
        block_bytes = b._block_bytes()
        row.update(
            pool_blocks_asked=n_blocks, ticks=taps["ticks"],
            host_ms_per_tick=stats.wall_time / taps["ticks"] * 1e3,
            preemptions=stats.preemptions,
            swap_out_blocks=stats.swap_out_blocks,
            swap_in_blocks=stats.swap_in_blocks,
            reprefill_tokens=stats.reprefill_tokens,
            preempted_by_path={p: taps["paths"].count(p)
                               for p in ("swap", "drop")},
            swap_cost_answers={"swap": taps["prefer_swap"].count(True),
                               "drop": taps["prefer_swap"].count(False)},
            swap_cost_state=None if b.swap_cost is None else {
                "swap_byte_s": b.swap_cost.swap_byte_s,
                "prefill_tok_s": b.swap_cost.prefill_tok_s},
            block_bytes=block_bytes,
            swap_out_ms_per_block=out_s / (out_b / block_bytes) * 1e3
            if out_b else None,
            swap_out_gb_s=out_b / out_s / 1e9 if out_b else None,
            swap_in_ms_per_block=in_s / in_n * 1e3 if in_n else None,
            swap_in_gb_s=in_n * block_bytes / in_s / 1e9 if in_n else None,
            tokens=[r.tokens for r in reqs])
        if name.endswith("sanitized"):
            row.update(sanitize_ms_per_tick=taps["sanitize_s"]
                       / taps["ticks"] * 1e3,
                       sanitizer_reports_added=len(sanitize.reports())
                       - reports)
        results[name] = row
        over = kw.get("oversubscribe", 0) > 0
        swapping = over and kw.get("swap", True)
        if (over and stats.preemptions == 0) \
                or (swapping and stats.swap_out_blocks == 0) \
                or (over and not swapping and stats.reprefill_tokens == 0):
            raise AssertionError(f"serve_oversub {name}: preemptions "
                                 f"{stats.preemptions}, swapped out / in "
                                 f"{stats.swap_out_blocks} / "
                                 f"{stats.swap_in_blocks}, re-prefilled "
                                 f"{stats.reprefill_tokens}")
        del b, reqs
        torch.cuda.empty_cache()
    engines.clear()
    a = results["a_pool64"]
    for name, row in results.items():
        if row["arch"] == ARCH and name != "a_pool64":
            row["identical_streams_vs_a"] = sum(
                t == o for t, o in zip(row["tokens"], a["tokens"]))
    san, plain = results["c_pool40_swap_sanitized"], \
        results["c_pool40_swap"]
    san["host_ms_per_tick_added"] = san["host_ms_per_tick"] \
        - plain["host_ms_per_tick"]
    for row in results.values():
        emit("serve_oversub", **{k: v for k, v in row.items()
                                 if k != "tokens"})
    if san["sanitizer_reports_added"]:
        raise AssertionError(f"serve_oversub: the sanitized run reported "
                             f"{sanitize.reports()[reports:]}")
    return {"round_trip": round_trip, **results}


def phase_static(make_engine, get_config, pda, lm, fa, seg):
    """The lock-step baseline against the batcher at full width:
    qwen1.5-0.5b, 16 requests of 32 + 16 tokens, ``static_batch_serve``
    in batches of 8 and ``ContinuousBatcher`` on 8 contiguous slots, with
    no EOS and then with an EOS id that request 0 emits (its third
    token).  Every request finishes under the same EOS rule (its tokens
    end at their first EOS, or hold all 16), launches exactly as derived
    (the static decode reaches the paged kernel through identity tables),
    tok/s of each; streams equal between the two, not asserted."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.serving_loop import (
        ContinuousBatcher, GenRequest, static_batch_serve,
    )
    fwd = fa.flash_attention_fwd
    n_layers, n_lora, _ = arch_counts(get_config, ARCH)
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                            seq_len=32, seed=0)
    prompts = list(data.sample_tokens(16)[:, :32].astype(np.int32))
    rows, tokens, eos = {}, {}, None
    for eos_run in (False, True):
        for kind in ("continuous", "static"):
            reqs = [GenRequest(request_id=i, prompt=p.copy(),
                               max_new_tokens=16)
                    for i, p in enumerate(prompts)]
            _reset(pda, lm, fwd, seg)                 # main path starts
            if kind == "static":
                stats = static_batch_serve(eng, params, lora, reqs,
                                           batch_size=8, prompt_pad=32,
                                           max_seq=48, eos_id=eos)
                waves = 2
            else:
                b = ContinuousBatcher(eng, params, lora, n_slots=8,
                                      max_seq=48, prompt_pad=32, eos_id=eos)
                stats = b.run(reqs)
                waves = b.prefill_waves
            got = serve_launches(pda, lm, seg, fwd)   # path ends
            name = f"{kind}{'_eos' if eos_run else ''}"
            check_launches(f"static {name}", got, {
                "paged_decode_attention": n_layers * stats.decode_steps,
                "lora_matmul": n_lora * (waves + stats.decode_steps),
                "segmented_lora_matmul": 0, "flash_attention": 0})
            rule = all(
                len(r.tokens) == (r.tokens.index(eos) + 1
                                  if eos in r.tokens else 16)
                for r in reqs)
            rows[name] = {"run": name, "eos_id": eos,
                          "finished": stats.finished,
                          "generated_tokens": stats.generated_tokens,
                          "decode_steps": stats.decode_steps,
                          "throughput_tok_s": stats.throughput(),
                          "wall_s": stats.wall_time, "eos_rule_held": rule,
                          "launches": got}
            tokens[name] = [r.tokens for r in reqs]
            if stats.finished != 16 or not rule \
                    or any(r.finished_wall is None for r in reqs):
                raise AssertionError(f"static {name}: {rows[name]}")
        if not eos_run:
            eos = tokens["continuous"][0][2]
    for suffix in ("", "_eos"):
        rows["static" + suffix]["identical_streams_vs_continuous"] = sum(
            t == o for t, o in zip(tokens["static" + suffix],
                                   tokens["continuous" + suffix]))
    for row in rows.values():
        emit("static", **row)
    if not any(len(t) < 16 for t in tokens["static_eos"]):
        raise AssertionError("static: the EOS id never fired")
    return rows


# ------------------------------------------------------------- mesh -------
# the serving half of the mesh (models/sharding.py, models/collectives.py,
# launch/mesh.py): four ranks on a (data 2, model 2) mesh, one process a
# rank, spawned once; each model's unsharded port runs first on the card
# (its logits kept, then freed).  The models: (arch, layers, float32,
# rule tables, traffic (name, requests, prompt tokens, new tokens)):
# llama3-8b at DEPTH_CUT's 8 layers under rules_for's table (each rank
# its heads and its slots' block of the caches) and the forced one
# (kv_seq on model: every rank all heads over its half of each cache,
# the sequence-sharded decode through the lse launch), 8 x (32 + 16) and
# 8 x (2,048 + 16) (the wave cut by rows, flash on each rank's heads);
# a 2-layer float32 copy of it; moonshot-v1-16b-a3b (EP) at 8 layers and
# grok-1-314b (TP) at 2, 8 x (32 + 16), and float32 copies of them at 2
# and 1 layers
MESH_SHAPE = (2, 2)
MESH_MODELS = [
    ("llama3-8b", 8, False, ("rules", "forced"),
     (("s32", 8, 32, 16), ("s2048", 8, 2048, 16))),
    ("llama3-8b", 2, True, ("rules", "forced"), (("s32", 8, 32, 16),)),
    ("moonshot-v1-16b-a3b", 8, False, ("rules",), (("s32", 8, 32, 16),)),
    ("grok-1-314b", 2, False, ("rules",), (("s32", 8, 32, 16),)),
    ("moonshot-v1-16b-a3b", 2, True, ("rules",), (("s32", 8, 32, 16),)),
    ("grok-1-314b", 1, True, ("rules",), (("s32", 8, 32, 16),)),
]
# sharded vs unsharded logits, relative to the largest: bf16 rounds in
# other places (each rank's partial products, the lse combine), the rule
# the script holds two bf16 paths of a model to; float32 as
# tests/test_shardmap_decode.py holds JAX.  Every compared step is held.
# An MoE stack is held to its run on a 1 x 1 mesh of the same weights
# (moe_decode_shardmap with every collective the identity): the mesh
# path keeps the expert sums in float32 where the plain moe_mlp rounds
# them to bf16 (the reference's two paths do the same), so the unsharded
# run is the wrong yardstick for it; its gap to that run is printed.
# The mesh's MoE routings take the 1 x 1 run's experts (MeshRouteTap's
# replay): one choice that rounding tips across a near tie makes two
# free runs compute different functions from there on (a bf16 free run
# of moonshot against the 1 x 1 one: 0.117 of the largest logit at its
# worst step, median 2.2e-2; my chip run R0, PR 29), so the choices are
# held apart: over the prefill wave (the same prompts in every run) the
# (token, layer) expert sets the mesh's own router picks otherwise than
# the replayed ones may number MESH_TIPPED_SLACK times those two correct
# single-process paths (the unsharded run replaying the 1 x 1 one's)
# tip between themselves, plus MESH_TIPPED_FLOOR of the choices (a
# count of a few is noise: grok's 2 of 512 against the mesh's 4, my
# chip run R3, PR 29); a router that reads a wrong weight or token
# block tips most of them
MESH_TOL = {False: 2e-2, True: 5e-5}
MESH_TIPPED_SLACK = 2
MESH_TIPPED_FLOOR = 0.005
# the rule-table names launch.mesh's parameter table cuts weights by: two
# tables equal in these cut the weights alike
WEIGHT_AXES = ("vocab", "w_embed", "heads", "ff", "experts", "expert_ff")


def mesh_key(arch, layers, f32):
    return f"{arch}_{layers}L" + ("_f32" if f32 else "")


def mesh_config(get_config, arch, layers, f32):
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32") \
        if f32 else cfg


def mesh_adapter(model, gen):
    """The adapter both runs serve: ``init_lora`` from ``gen`` (drawn after
    the weights), B drawn too (N(0, 0.01^2)), so the bypass is no no-op
    and a wrongly cut A or B shows in the logits."""
    lora = model.init_lora(gen)
    for pair in lora.values():
        pair["b"].copy_(0.01 * torch.randn(pair["b"].shape, generator=gen,
                                           device=gen.device))
    return lora


def mesh_prompts(vocab, n, plen):
    """``n`` prompts of ``plen`` tokens, the same in every process (the
    synthetic dataset seeds from Python's salted hash)."""
    rng = np.random.default_rng(plen)
    return list(rng.integers(0, vocab, (n, plen), dtype=np.int32))


class LogitsTap:
    """Records the last-position logits of every ``Model.prefill_ragged``
    and ``Model.decode_step`` call while it is entered (on the host, in
    their dtype)."""

    def __enter__(self):
        from repro_torch.models.model import Model
        self._model = Model
        self._orig = (Model.prefill_ragged, Model.decode_step)
        pre, dec = self._orig
        self.logits = []

        def keep(out):
            self.logits.append(out[0][:, -1].cpu())  # lint: host-sync-ok the check's copy, one a step
            return out

        Model.prefill_ragged = lambda *a, **k: keep(pre(*a, **k))
        Model.decode_step = lambda *a, **k: keep(dec(*a, **k))
        return self

    def __exit__(self, *exc):
        self._model.prefill_ragged, self._model.decode_step = self._orig
        return False


def forced_route(logits, expert, capacity):
    """``moe._route`` with the experts given (``expert`` [G, T, K]): the
    gates, slots, kept flags and aux it computes for those choices."""
    g, t, e = logits.shape
    k = expert.shape[-1]
    probs = torch.softmax(logits.double(), dim=-1).float()
    gates = probs.gather(-1, expert)
    total = gates[..., 0]
    for j in range(1, k):
        total = total + gates[..., j]
    gates = gates / torch.clamp(total, min=1e-9)[..., None]
    me = probs.mean(dim=1)
    ce = F.one_hot(expert[..., 0], e).float().mean(dim=1)
    aux = (me * ce).sum(-1).mean() * e
    oh = F.one_hot(expert.transpose(1, 2).reshape(g, k * t), e)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)
    slot = pos.reshape(g, k, t).transpose(1, 2)
    return expert, slot, slot < capacity, gates, aux


class MeshRouteTap:
    """Records the experts every MoE routing picks while it is entered
    (``moe._route``, which ``moe_mlp`` and ``moe_decode_shardmap`` call
    once a layer a step): one [tokens, top_k] tensor a call, the tokens
    batch-major, on the host.  Given ``replay`` (another run's record),
    each routing takes the replayed experts in place of its own
    (``forced_route``) and counts the tokens whose own set of experts
    differed (``tipped``: (tokens, tipped) a call); where none did, the
    forced routing is held bitwise to the routing's own.  Neither
    recording nor replaying (``record`` False, no ``replay``), it leaves
    the routing alone."""

    def __init__(self, replay=None, record=False):
        self.replay, self.record = replay, record or replay is not None
        self.tipped = []
        self.experts = []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._orig = moe, moe._route
        if not self.record:
            return self

        def route(logits, top_k, capacity):
            out = self._orig(logits, top_k, capacity)
            if self.replay is not None:
                want = self.replay[len(self.experts)].to(
                    out[0].device).reshape(out[0].shape)
                forced = forced_route(logits, want, capacity)
                if torch.equal(want, out[0]) and not all(
                        torch.equal(x, y) for x, y in zip(forced, out)):
                    raise AssertionError("forced_route is not moe._route")
                differ = (want.sort(-1)[0] != out[0].sort(-1)[0]).any(-1)
                self.tipped.append((differ.numel(), int(differ.sum())))  # lint: host-sync-ok the check's count, one a layer a step
                out = forced
            self.experts.append(out[0].reshape(-1, top_k).cpu())  # lint: host-sync-ok the check's copy, one a layer a step
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._orig
        return False


def mesh_serve(eng, params, lora, n, plen, gen, replay=None,
               record=False):
    """``static_batch_serve`` of ``n`` requests of ``plen`` + ``gen``
    tokens in one batch; (tokens, stats, logits of each step, the
    ``MeshRouteTap``: the MoE routings' experts of each layer and step
    where ``record``ed or replayed from ``replay``)."""
    from repro_torch.runtime.serving_loop import (
        GenRequest, static_batch_serve,
    )
    reqs = [GenRequest(request_id=i, prompt=p.copy(), max_new_tokens=gen)
            for i, p in enumerate(mesh_prompts(eng.model.cfg.vocab_size, n,
                                               plen))]
    with LogitsTap() as tap, MeshRouteTap(replay, record) as routes:
        stats = static_batch_serve(eng, params, lora, reqs, batch_size=n,
                                   prompt_pad=plen, max_seq=plen + gen)
    torch.cuda.synchronize()
    if replay is not None and len(routes.experts) != len(replay):
        raise AssertionError(f"{len(routes.experts)} routings replayed "
                             f"{len(replay)}")
    return [list(r.tokens) for r in reqs], stats, tap.logits, routes


def prefill_tipped(routes, tokens):
    """(choices, tipped) of a ``MeshRouteTap``'s replayed routings over
    the prefill wave's ``tokens`` (the same prompts in both runs; a
    decode step's token may differ once the greedy tokens part)."""
    calls = [c for c in routes.tipped if c[0] == tokens]
    return sum(c for c, _ in calls), sum(k for _, k in calls)


def mesh_rank(mesh, replays):
    """One rank of the mesh phase: every model of MESH_MODELS under each
    of its tables, its weights ``init_sharded`` from the unsharded run's
    seed (an MoE stack's routings replayed from ``replays``, the 1 x 1
    mesh's record); per run the tokens, each rank's launch counts (set
    to 0 just before the run, read just after, held against the derived
    ones), peak memory while serving, wall time, the routings' tipped
    choices; rank 0 also the logits."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention as pda,
    )
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.lora_matmul import lora_matmul as lm
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.sharding import ShardingRules, sharding_context
    from repro_torch.models.transformer import mesh_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    forced = dataclasses.replace(ShardingRules(), kv_seq="model",
                                 kv_batch="data")
    out = {}
    for arch, layers, f32, tables, traffic in MESH_MODELS:
        cfg = mesh_config(get_config, arch, layers, f32)
        eng = make_engine(cfg, device="cuda")
        params, cut = None, None
        n_targets = len(cfg.lora.targets)
        for table in tables:
            rules = rules_for(cfg, mesh, "decode") if table == "rules" \
                else forced
            with sharding_context(mesh, rules):
                # the weights' cut: the rule table's names of weight dims
                if cut != [getattr(rules, f) for f in WEIGHT_AXES]:
                    params = None
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    gen = torch.Generator(device="cuda").manual_seed(0)
                    t0 = time.perf_counter()
                    params = eng.model.init_sharded(gen, mesh, rules)
                    lora = mesh_adapter(eng.model, gen)
                    init_s = time.perf_counter() - t0
                    init_peak = torch.cuda.max_memory_allocated()
                    cut = [getattr(rules, f) for f in WEIGHT_AXES]
                for name, n, plen, gen_tokens in traffic:
                    seq = bool(mesh_plan(cfg, mesh, rules, n, n).kv_seq)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    _reset(pda, lm, flash_attention_fwd)
                    pda.lse_launches = 0                  # main path starts
                    t0 = time.perf_counter()
                    with LoraShapeTap() as ltap, AttnShapeTap() as atap:
                        tokens, stats, logits, routes = mesh_serve(
                            eng, params, lora, n, plen, gen_tokens,
                            replays.get((mesh_key(arch, layers, f32),
                                         name)))
                    wall = time.perf_counter() - t0
                    got = {"paged_decode_attention": pda.launches,
                           "paged_decode_attention_lse": pda.lse_launches,
                           "lora_matmul": lm.launches,
                           "flash_attention": flash_attention_fwd.launches}
                    steps = stats.decode_steps              # path ends
                    want = {"paged_decode_attention":
                            0 if seq else layers * steps,
                            "paged_decode_attention_lse":
                            layers * steps if seq else 0,
                            "lora_matmul": n_targets * layers * (1 + steps),
                            "flash_attention":
                            layers if long_prompt(plen) else 0}
                    key = (mesh_key(arch, layers, f32), table, name)
                    check_launches(f"mesh {key} rank {mesh.rank}", got, want)
                    require_checked(f"mesh {key}", ltap, atap)
                    out[key] = {
                        "tokens": tokens, "launches": got,
                        "decode_steps": steps, "seq_sharded": seq,
                        "wall_s": wall, "tok_s": stats.throughput(),
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "init_s": init_s, "init_peak_bytes": init_peak,
                        "param_bytes": _param_bytes(params),
                        "logits": logits if mesh.rank == 0 else None,
                        "tipped": prefill_tipped(routes, n * plen),
                        "lora_shapes": lora_summary(ltap),
                        "attn_shapes": atap.summary()}
        params = lora = eng = None
        torch.cuda.empty_cache()
    return out


def phase_mesh(make_engine, get_config):
    """The serving half of the mesh on the card: each model of
    MESH_MODELS unsharded first (logits, tokens, time; its weights and
    caches' bytes), then four ranks of a 2 x 2 mesh, one process a rank
    (NCCL with a card a rank where the machine has four; else gloo, the
    ranks sharing card 0: times then measure no sharding speed), serving
    the same requests on the same weights (an MoE stack's also on a 1 x
    1 mesh in this process, its yardstick).  Held: every rank's tokens
    equal; the logits of every step whose earlier tokens agree within
    MESH_TOL of the largest (float32: every token equal too); every
    rank's launches nonzero and derived; every rank's peak memory while
    serving below half the unsharded weights plus caches."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, rules_for, spawn_ranks
    from repro_torch.models.sharding import sharding_context
    ref = {}
    one_store = tempfile.TemporaryDirectory()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(one_store.name, "filestore"), 1), rank=0, world_size=1)
    one = make_mesh((1, 1), ("data", "model"), "cuda")
    for arch, layers, f32, tables, traffic in MESH_MODELS:
        cfg = mesh_config(get_config, arch, layers, f32)
        eng = make_engine(cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = eng.model.init(gen)
        lora = mesh_adapter(eng.model, gen)
        mkey = mesh_key(arch, layers, f32)
        for name, n, plen, gen_tokens in traffic:
            t0 = time.perf_counter()
            tokens, stats, logits, _ = mesh_serve(eng, params, lora, n,
                                                  plen, gen_tokens)
            caches = eng.model.init_caches(n, plen + gen_tokens)["kv"]
            ref[(mkey, name)] = {
                "tokens": tokens, "logits": logits,
                "wall_s": time.perf_counter() - t0,
                "tok_s": stats.throughput(),
                "bytes": _param_bytes(params) + _param_bytes(
                    dict(enumerate(caches)))}
            caches = None
            if cfg.family.value == "moe":
                with sharding_context(one, rules_for(cfg, one, "decode")):
                    tokens, _, logits, routes = mesh_serve(
                        eng, params, lora, n, plen, gen_tokens, record=True)
                # two correct single-process paths' tipped choices: the
                # unsharded run replaying the 1 x 1 run's
                _, _, _, base_routes = mesh_serve(
                    eng, params, lora, n, plen, gen_tokens,
                    replay=routes.experts)
                ref[(mkey, name)]["one"] = {
                    "tokens": tokens, "logits": logits,
                    "routes": routes.experts,
                    "tipped": prefill_tipped(base_routes, n * plen)}
            emit("mesh_unsharded", model=mkey, traffic=name,
                 **{k: v for k, v in ref[(mkey, name)].items()
                    if k not in ("tokens", "logits", "one")})
        params = lora = eng = None
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    one_store.cleanup()
    cards = torch.cuda.device_count()
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    backend = "nccl" if cards >= world else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        ranks = spawn_ranks(mesh_rank, MESH_SHAPE, backend=backend,
                            store_dir=store, device_type="cuda",
                            args=({k: r["one"]["routes"] for k, r in
                                   ref.items() if "one" in r},),
                            timeout_s=900)
    spawn_s = time.perf_counter() - t0
    rows = {}
    for key in ranks[0]:
        mkey, table, name = key
        base = ref[(mkey, name)]
        f32 = mkey.endswith("_f32")
        got = [r[key] for r in ranks]
        agree = all(g["tokens"] == got[0]["tokens"] for g in got)
        yard = base.get("one", base)
        rels = mesh_logit_err(yard, got[0])
        compared = len(rels)
        err = rels[-1] if rels else math.inf
        tol = MESH_TOL[f32]
        within = sum(r <= tol for r in rels)
        choices, tipped = max(g["tipped"] for g in got)
        base_tipped = base["one"]["tipped"][1] if "one" in base else 0
        tipped_max = MESH_TIPPED_SLACK * base_tipped \
            + MESH_TIPPED_FLOOR * choices
        held = bool(rels) and err <= tol and tipped <= tipped_max
        same_tokens = sum(a == b for a, b in zip(base["tokens"],
                                                 got[0]["tokens"]))
        # the 1 x 1 mesh's run against the unsharded one (MoE)
        one_rels = mesh_logit_err(base, yard) if "one" in base else []
        half = 0.5 * base["bytes"]
        row = {"model": mkey, "table": table, "traffic": name,
               "backend": backend, "ranks": world, "cards": cards,
               "shared_card": cards < world,
               "ranks_agree": agree, "seq_sharded": got[0]["seq_sharded"],
               "logits_rel_err": err, "tol": tol,
               "logits_rel_err_median": rels[compared // 2]
               if rels else None,
               "steps_within_tol": within, "steps_compared": compared,
               "routes": "replayed from the 1x1 mesh's run" if "one" in base
               else None,
               "prefill_choices": choices, "prefill_choices_tipped": tipped,
               "unsharded_vs_1x1_choices_tipped": base_tipped,
               "tipped_max": tipped_max,
               "yardstick": "1x1 mesh" if "one" in base else "unsharded",
               "requests_same_tokens_as_yardstick": sum(
                   a == b for a, b in zip(yard["tokens"], got[0]["tokens"])),
               "one_vs_unsharded_rel_err": one_rels[-1] if one_rels
               else None,
               "one_vs_unsharded_rel_err_median":
               one_rels[len(one_rels) // 2] if one_rels else None,
               "requests_same_tokens_as_unsharded": same_tokens,
               "requests": len(base["tokens"]),
               "launches_by_rank": [g["launches"] for g in got],
               "decode_steps": got[0]["decode_steps"],
               "peak_bytes_by_rank": [g["peak_bytes"] for g in got],
               "init_peak_bytes_by_rank": [g["init_peak_bytes"] for g in got],
               "param_bytes_by_rank": [g["param_bytes"] for g in got],
               "unsharded_weights_and_caches_bytes": base["bytes"],
               "wall_s_by_rank": [g["wall_s"] for g in got],
               "tok_s_rank0": got[0]["tok_s"],
               "init_s_rank0": got[0]["init_s"],
               "unsharded_wall_s": base["wall_s"],
               "unsharded_tok_s": base["tok_s"],
               "lora_shapes": got[0]["lora_shapes"],
               "attn_shapes": got[0]["attn_shapes"]}
        emit("mesh", **row)
        ok = agree and compared > 0 and held \
            and all(p < half for p in row["peak_bytes_by_rank"]) \
            and (not f32 or same_tokens == row["requests"])
        if not ok:
            raise AssertionError(f"mesh {key}: {row}")
        rows[key] = row
    emit("mesh_spawn", seconds=spawn_s, backend=backend, ranks=world,
         cards=cards)
    return rows


def mesh_logit_err(base, got):
    """|sharded - yardstick| logits over the steps each request reached
    with the same earlier tokens in both runs, relative to the largest
    yardstick logit there: each compared (request, step)'s largest,
    sorted."""
    errs, scale = [], 0.0
    n = len(base["tokens"])
    for t, (a, b) in enumerate(zip(base["logits"], got["logits"])):
        rows = [i for i in range(n)
                if t < len(base["tokens"][i])
                and base["tokens"][i][:t] == got["tokens"][i][:t]]
        if not rows:
            continue
        a, b = a[rows].float(), b[rows].float()
        errs += (a - b).abs().amax(-1).tolist()
        scale = max(scale, float(a.abs().max()))
    return sorted(e / max(scale, 1e-30) for e in errs)


BUDGET_RUNS = [("paged", "paged", dict(prompt_len=32, gen_tokens=16)),
               ("paged_992_chunk256", "paged_992",
                dict(prompt_len=992, gen_tokens=16, prefill_chunk=CHUNK))]
TPOT_TARGET = 0.1


def budget_seeded(make_engine, get_config, kw):
    """Bring-up (the ``budget_seeded`` phase, never in the full run): a
    policy the runtime does not have.  The budget run of ``kw`` with its
    train cost priced first: one
    idle tick before the trace trains alone (``step`` on an empty
    batcher), which ``_TickBudget`` measures (after one unpriced warm-up
    step outside the batcher); then the trace as ``run_serving`` serves
    it (same weights, prompts and train data).  Returns the
    ``run_serving``-like counters."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    plen, gen = kw["prompt_len"], kw["gen_tokens"]
    data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                            seq_len=plen, seed=0)
    b = ContinuousBatcher(eng, params, lora, n_slots=8, max_seq=plen + gen,
                          prompt_pad=plen, opt_state=eng.optimizer.init(lora),
                          paged=True, prefill_chunk=kw.get("prefill_chunk", 0),
                          tpot_target=TPOT_TARGET)
    prompts = data.sample_tokens(16)[:, :plen]
    # one unpriced step first (its result dropped), so that the priced
    # idle tick is warm: the budget never re-prices a skipped train step
    warm = {k: torch.as_tensor(v, device="cuda")
            for k, v in data.batch(4).items()}
    eng.train_step(params, lora, eng.optimizer.init(lora), warm)
    b.step(train_batch=data.batch(4))       # the idle tick: priced
    seeded_s = b.budget.train_tok_s
    rows = []

    def train_fn():
        if b.last_tick_trained:
            rows.append(b.last_tick_train_rows)
        return data.batch(4)

    stats = b.run([GenRequest(request_id=i, prompt=prompts[i],
                              max_new_tokens=gen) for i in range(16)],
                  train_data_fn=train_fn)
    if b.last_tick_trained:
        rows.append(b.last_tick_train_rows)
    # the counters without the idle tick (its rows, step and budget tick)
    return {"finished": stats.finished, "decode_steps": stats.decode_steps,
            "prefill_waves": b.prefill_waves,
            "train_steps": stats.train_steps - 1, "train_rows": rows[1:],
            "train_losses": b.train_losses[1:],
            "train_skipped_ticks": stats.train_skipped_ticks,
            "budget_ticks": stats.budget_ticks - 1,
            "budget_spent_s": stats.budget_spent_s,
            "budget_target_s": stats.budget_target_s - TPOT_TARGET,
            "throughput_tok_s": stats.throughput(),
            "ttft_s": stats.ttft, "tpot_s": stats.tpot,
            "train_tok_s_seeded": seeded_s,
            "train_tok_s_end": b.budget.train_tok_s,
            "decode_tick_s_end": b.budget.decode_tick_s,
            "blocks_used_at_end": b.allocator.n_used,
            "blocks_reserved_at_end": b.allocator.reserved}


def phase_budget(run_serving, make_engine, get_config, pda, lm, fa, seg,
                 combined=None, seeded=False):
    """Co-training under a decode TPOT target of 0.1 s (``run_serving(
    combined=True, tpot_target=0.1)``, paged, train batch 4 x prompt
    length): 32 + 16, and 992 + 32 with 256-token chunks.  ``seeded``
    (the ``budget_seeded`` bring-up phase): each run instead with the
    train cost priced first by an idle train tick (``budget_seeded``: the
    reference prices training only on a tick without serving work, which
    a saturated trace never has).  Reports what the budget trained
    (steps, rows per trained tick, skipped ticks), its spend against its
    target and TPOT, beside the combined phase's unbudgeted run of the
    same traffic, and the host ms of drawing one train batch as
    ``run_serving``'s train_fn draws it before every tick, trained or
    skipped (outside ``step``, so outside the budget's own clock).
    Checks: every request finishes, every loss finite, the allocator
    drains, launches as derived; no outcome of the plan is asserted."""
    from repro_torch.data.synthetic import SyntheticDataset
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    results = {}
    for name, ref, kw in BUDGET_RUNS:
        torch.cuda.synchronize()
        _reset(pda, lm, fwd, bwd, seg)                    # main path starts
        if seeded:
            out = budget_seeded(make_engine, get_config, kw)
        else:
            out = run_serving(ARCH, smoke=False, n_requests=16, batch_size=8,
                              combined=True, train_batch=4, seed=0,
                              device="cuda", verbose=False, paged=True,
                              tpot_target=TPOT_TARGET, **kw)
        got = {**serve_launches(pda, lm, seg, fwd),
               "flash_attention_backward": bwd.launches}  # path ends
        name = f"{name}_seeded" if seeded else name
        steps = out["train_steps"] + 2 * seeded   # warm-up and idle tick
        check_launches(f"budget {name}", got, {
            "paged_decode_attention": n_layers * out["decode_steps"],
            "lora_matmul": n_lora * (out["prefill_waves"]
                                     + out["decode_steps"])
            + (n_lora + n_lora_bwd) * steps,
            "segmented_lora_matmul": 0, "flash_attention": 0,
            "flash_attention_backward": 0})
        rows = out["train_rows"]
        steps = out["train_steps"]
        row = {"run": name, "tpot_target_s": TPOT_TARGET,
               "prompt_len": kw["prompt_len"], "gen_tokens": kw["gen_tokens"],
               "prefill_chunk": kw.get("prefill_chunk", 0),
               "train_batch": [4, kw["prompt_len"]],
               "finished": out["finished"],
               "decode_steps": out["decode_steps"],
               "budget_ticks": out["budget_ticks"], "train_steps": steps,
               "train_rows_per_trained_tick": rows,
               "train_skipped_ticks": out["train_skipped_ticks"],
               "budget_spent_s": out["budget_spent_s"],
               "budget_target_s": out["budget_target_s"],
               "budget_spent_over_target":
                   out["budget_spent_s"] / out["budget_target_s"],
               "throughput_tok_s": out["throughput_tok_s"],
               **latency_percentiles(out), "launches": got,
               "losses_finite": bool(np.isfinite(out["train_losses"]).all())}
        if seeded:
            row.update({k: out[k] for k in (
                "train_tok_s_seeded", "train_tok_s_end", "decode_tick_s_end")})
        data = SyntheticDataset("alpaca",
                                vocab_size=get_config(ARCH).vocab_size,
                                seq_len=kw["prompt_len"], seed=0)
        draws = []
        for _ in range(3):
            t0 = time.perf_counter()
            data.batch(4)
            draws.append((time.perf_counter() - t0) * 1e3)
        row["train_batch_draw_host_ms"] = statistics.median(draws)
        if combined is not None and ref in combined:
            c = combined[ref]
            row["unbudgeted"] = {k: c[k] for k in (
                "train_steps", "decode_steps", "throughput_tok_s",
                "tpot_p50_ms", "tpot_p99_ms", "ttft_p50_ms", "ttft_p99_ms")}
        emit("budget", **row)
        if out["finished"] != 16 or not row["losses_finite"] \
                or len(rows) != steps:
            raise AssertionError(f"budget {name}: a request unfinished, a "
                                 "loss not finite, or rows miscounted")
        if out["blocks_used_at_end"] or out["blocks_reserved_at_end"]:
            raise AssertionError(f"budget {name}: allocator did not drain")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------ multi-tenant ----
# (name, arch, run_serving kwargs, phase_serve run of the same traffic
# with one adapter): 4 tenants on 4 device slots unless named, tagged
# round-robin over 16 requests on 8 slots
ADAPTER_RUNS = [
    ("paged", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16), "paged"),
    ("contiguous", ARCH, dict(paged=False, prompt_len=32, gen_tokens=16),
     "contiguous"),
    ("paged_992", ARCH, dict(paged=True, prompt_len=992, gen_tokens=32),
     "paged_992"),
    ("paged_2048", ARCH, dict(paged=True, prompt_len=2048, gen_tokens=32),
     "paged_2048"),
    ("paged_6_on_4", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16,
                                n_adapters=6, adapter_slots=4), None),
    ("combined_paged", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16,
                                  combined=True, train_batch=4), "paged"),
    ("llama_paged", "llama3-8b", dict(paged=True, prompt_len=32,
                                      gen_tokens=16), None),
]


def phase_serve_adapters(run_serving, get_config, pda, lm, fa, seg,
                         serve=None):
    """Multi-tenant serving at full width (``run_serving(n_adapters=...)``,
    random tenants from ``make_tenant_adapters``): every request finishes,
    the allocator drains, every adapter ref returns, the tenants' streams
    differ, and the launches are exactly as derived: segmented_lora_matmul
    once per adapter projection per prefill wave and decode step,
    lora_matmul never when serving and forward plus dX per train step
    when co-training.  Against the serve phase's run of the same traffic
    (one adapter with b = 0, same weights and prompts, admitted in the
    same waves): tenant 0 (b = 0 too) emits its tokens exactly and every
    other tenant differs on some request; with co-training too, since
    decode reads the registry's copies, which training leaves alone."""
    results = {}
    fwd = fa.flash_attention_fwd
    for name, arch, kw, ref_name in ADAPTER_RUNS:
        kw = {"n_adapters": 4, **kw}
        n_layers, n_lora, n_lora_bwd = arch_counts(get_config, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg)                         # main path starts
        out = run_serving(arch, smoke=False, n_requests=16, batch_size=8,
                          seed=0, device="cuda", verbose=False, **kw)
        launches, lora_launches, flash, seg_launches = \
            pda.launches, lm.launches, fwd.launches, seg.launches  # ends
        gen, steps = kw["gen_tokens"], out["decode_steps"]
        seg_want = n_lora * (out["prefill_waves"] + steps)
        lora_want = (n_lora + n_lora_bwd) * out["train_steps"]
        flash_want = n_layers * out["prefill_waves"] \
            if long_prompt(kw["prompt_len"]) else 0
        aids = out["adapter_ids"]
        row = {
            "run": name, "arch": arch, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen, "tenants": kw["n_adapters"],
            "adapter_slots": kw.get("adapter_slots") or kw["n_adapters"],
            "combined": bool(kw.get("combined")),
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": steps, "prefill_waves": out["prefill_waves"],
            "train_steps": out["train_steps"],
            "segmented_lora_matmul_launches": seg_launches,
            "segmented_lora_matmul_launches_derived": seg_want,
            "lora_matmul_launches": lora_launches,
            "lora_matmul_launches_derived": lora_want,
            "kernel_launches": launches,
            "flash_attention_launches": flash,
            "adapter_requests": out["adapter_requests"],
            "adapter_hits": out["adapter_hits"],
            "adapter_loads": out["adapter_loads"],
            "adapter_evictions": out["adapter_evictions"],
            "adapter_refs_at_end": out["adapter_refs_at_end"],
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "train_losses_first_last": out["train_losses"][:1]
            + out["train_losses"][-1:],
        }
        if kw["paged"]:
            row.update(blocks_used_at_end=out["blocks_used_at_end"],
                       blocks_reserved_at_end=out["blocks_reserved_at_end"])
        failed = []
        if out["finished"] != 16 or any(len(t) != gen for t in out["tokens"]):
            failed.append("not every request finished")
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            failed.append("allocator did not drain")
        if set(out["adapter_refs_at_end"].values()) != {0}:
            failed.append("adapter refs left pinned")
        if (seg_launches, lora_launches, flash, launches) != (
                seg_want, lora_want, flash_want, n_layers * steps):
            failed.append("launch counts differ from the derived ones")
        if name == "paged_6_on_4" and out["adapter_evictions"] < 1:
            failed.append("6 tenants on 4 slots evicted none")
        if kw.get("combined") and (out["train_steps"] != steps or not
                                   np.isfinite(out["train_losses"]).all()):
            failed.append("not one finite train step per tick")
        if serve is not None and ref_name is not None:
            ref_tokens = serve[ref_name][1]
            same = {t: [out["tokens"][i] == ref_tokens[i]
                        for i in range(16) if aids[i] == t]
                    for t in sorted(set(aids))}
            row["tokens_equal_single_adapter_run"] = same
            if not all(same["tenant0"]) or any(
                    all(v) for t, v in same.items() if t != "tenant0"):
                failed.append("tenant 0 drifted from the single-adapter "
                              "run, or another tenant emitted its tokens")
        # each tenant's first request against every other tenant's
        firsts = {}
        for i, t in enumerate(aids):
            firsts.setdefault(t, out["tokens"][i])
        row["tenants_with_distinct_streams"] = len(
            {tuple(v) for v in firsts.values()})
        if row["tenants_with_distinct_streams"] != len(firsts):
            failed.append("two tenants emitted the same stream")
        emit("serve_adapters", **row)
        if failed:
            raise AssertionError(f"serve_adapters {name}: {failed}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


def phase_mixed_solo(get_config, make_engine, seg, lm):
    """One paged wave of base, tenant 0, tenant 1 and tenant 2 at full
    width (4 slots, 32-token prompts, 16 new tokens), then each of them
    served alone as the server's single adapter (base: an adapter with
    b = 0) on the same four prompts: each row's greedy tokens must be
    identical, since the kernel makes every row bitwise lora_matmul's with
    its own adapter.  Read out beside it, not checked: each request served
    in a wave of its own, against the mixed wave and, as the control,
    against the same single-adapter server in the wave of four.  cuBLAS
    picks its kernel for the frozen products (MLP, logits head) by M, so
    a wave of one rounds otherwise, and random full-width weights leave
    near-tied logits that such last bits flip."""
    from repro_torch.runtime.fabric import make_tenant_adapters
    from repro_torch.runtime.serving_loop import (
        AdapterRegistry, ContinuousBatcher, GenRequest)
    cfg = get_config(ARCH)
    engine = make_engine(cfg, device="cuda")
    model = engine.model
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    base = model.init_lora(gen)
    tenants = make_tenant_adapters(model, 3, seed=1)
    reg = AdapterRegistry(model, capacity=3)
    for t, tree in enumerate(tenants):
        reg.register(f"tenant{t}", tree)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    aids = [None, "tenant0", "tenant1", "tenant2"]
    trees = [base] + tenants

    def serve(lora, rows, registry=None):
        b = ContinuousBatcher(engine, params, lora, n_slots=4, max_seq=48,
                              prompt_pad=32, paged=True, adapters=registry)
        reqs = [GenRequest(request_id=i, prompt=prompts[i],
                           max_new_tokens=16,
                           adapter_id=aids[i] if registry else None)
                for i in rows]
        b.run(reqs)
        return [r.tokens for r in reqs]

    _reset(seg, lm)
    mixed = serve(tenants[0], range(4), reg)
    mixed_launches = (seg.launches, lm.launches)
    solo = [serve(tree, range(4))[i] for i, tree in enumerate(trees)]
    alone = [serve(tree, [i])[0] for i, tree in enumerate(trees)]
    same = [m == o for m, o in zip(mixed, solo)]
    emit("mixed_solo", config=cfg.name, dtype=cfg.dtype, slots=4,
         prompt_len=32, gen_tokens=16, rows=["base"] + aids[1:],
         tokens_equal=same,
         distinct_streams=len({tuple(t) for t in mixed}),
         mixed_segmented_launches=mixed_launches[0],
         mixed_lora_matmul_launches=mixed_launches[1],
         wave_of_one_equal_mixed=[m == a for m, a in zip(mixed, alone)],
         wave_of_one_equal_single_adapter_wave=[
             o == a for o, a in zip(solo, alone)])
    if not all(same) or len({tuple(t) for t in mixed}) != 4 \
            or mixed_launches[1] != 0 or mixed_launches[0] == 0:
        raise AssertionError(f"mixed wave vs solo: tokens equal {same}")
    del engine, params, base, tenants, reg, trees
    torch.cuda.empty_cache()


def fixed_batch_steps(make_engine, get_config, arch, seq, steps, lm):
    """``steps`` full-width train steps of ``arch``'s adapter on one
    fixed 4 x ``seq`` batch (lr 3e-3, weights from a seed): the losses,
    each step's host ms and lora_matmul launches, the peak memory."""
    from repro_torch.data.synthetic import SyntheticDataset
    cfg = get_config(arch)
    eng = make_engine(cfg, lr=3e-3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = eng.model.init(gen)
    lora = eng.model.init_lora(gen)
    opt = eng.optimizer.init(lora)
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=seq, seed=1)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch(4).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for _ in range(steps):
        lm.launches = 0
        t0 = time.perf_counter()
        lora, opt, met = eng.train_step(params, lora, opt, batch)
        losses.append(float(met["ce_loss"]))      # syncs
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(lm.launches)
    return losses, times, per_step, torch.cuda.max_memory_allocated()


def phase_train(make_engine, get_config, lm, steps=10):
    """Full-width train steps on one fixed batch: the loss must fall."""
    losses, times, per_step, peak = fixed_batch_steps(
        make_engine, get_config, ARCH, 256, steps, lm)
    emit("train", config=ARCH, batch=[4, 256], lr=3e-3, losses=losses,
         step_ms=times, lora_matmul_launches_per_step=per_step,
         max_memory_allocated_bytes=peak)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    if set(per_step) != {N_LORA + N_LORA_BWD}:
        raise AssertionError(f"train: lora_matmul launches {per_step}")


# ------------------------------------------------------- training CLI ----
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10      # (b); (c) resumes to 30
TRAIN_LONG_SEQ, TRAIN_LONG_STEPS = 2048, 3  # (d): past the dense limit
CLI_SEQ, CLI_STEPS = 128, 10                # (e), then --restore to 15
LLAMA_TRAIN_STEPS = 5                       # (f): the CLI's default arch
# (a) card vs CPU, float32 reduced, one step at a time: along the CPU's
# trajectory the card takes each step from the CPU's state on the same
# batch (``train_walk``).  The loss within 1e-5 relative (the reference
# phase's one-step tolerance); the AdamW moments, which hold the gradient
# (m' - 0.9 m = 0.1 g from the same m), within float32 noise; the
# adapters within TRAIN_LORA_ATOL of the AdamW update applied in float64
# to the CPU's previous adapters with the card's own new moments
# (``adamw_gap``: a gradient component at noise level, near eps, moves
# the normalised update m^ / (sqrt(v^) + eps) by a real fraction of lr,
# so the adapters are held to the update, not to the CPU's;
# tests/test_torch_train_cli.py holds the port against JAX the same way)
TRAIN_LOSS_RTOL, TRAIN_LORA_ATOL = 1e-5, 1e-6
TRAIN_M_TOL = (1e-5, 1e-8)        # (rtol, atol)
TRAIN_V_TOL = (1e-4, 1e-12)
TRAIN_ADAMW = (3e-3, 0.9, 0.999, 1e-8)   # lr, b1, b2, eps of make_engine


def adamw_gap(new, prev, m, v, step):
    """The largest gap of adapters ``new`` from one AdamW step (no weight
    decay) from ``prev`` with new moments ``m``, ``v`` at ``step``,
    computed in float64 on the CPU."""
    lr, b1, b2, eps = TRAIN_ADAMW
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    m, v = m.cpu().double(), v.cpu().double()
    want = prev.cpu().double() - lr * (m / bc1) / ((v / bc2).sqrt() + eps)
    return float((new.cpu().double() - want).abs().max())


def train_walk(make_engine, cfg, params, state, batches):
    """From ``state`` (CPU adapters, AdamW state) along the CPU's
    trajectory over ``batches`` (numpy): at each step the CPU and the
    card each take one ``Engine.train_step`` from the CPU's state, and
    the card's loss, moments and adapters are held against the CPU's
    (bounds above); the walk goes on from the CPU's state.  Returns the
    CPU states before each step and after the last, the CPU losses and
    the largest gaps (the adapters' from their update, and from the
    CPU's adapters)."""
    from repro_torch.checkpoint.checkpointer import _tree_paths
    cpu = make_engine(cfg, lr=TRAIN_ADAMW[0], device="cpu")
    gpu = make_engine(cfg, lr=TRAIN_ADAMW[0], device="cuda")
    gparams = _to(params, "cuda")
    states, losses = [state], []
    worst = {"loss_rel_err": 0.0, "m_max_abs_err": 0.0, "v_max_abs_err": 0.0,
             "lora_update_max_abs_err": 0.0, "lora_vs_cpu_max_abs_err": 0.0}
    for k, b in enumerate(batches):
        lora, opt = state
        cl, co, cm = cpu.train_step(params, lora, opt,
                                    {n: torch.as_tensor(x)
                                     for n, x in b.items()})
        gl, go, gm = gpu.train_step(gparams, _to(lora, "cuda"),
                                    _to(opt, "cuda"),
                                    {n: torch.as_tensor(x, device="cuda")
                                     for n, x in b.items()})
        c_loss, g_loss = float(cm["ce_loss"]), float(gm["ce_loss"])
        rel = abs(g_loss - c_loss) / abs(c_loss)
        worst["loss_rel_err"] = max(worst["loss_rel_err"], rel)
        bad = [] if rel <= TRAIN_LOSS_RTOL and int(go.step) == int(co.step) \
            else [f"loss {g_loss} vs {c_loss}, AdamW step {int(go.step)}"]
        for what, g_tree, c_tree, (rtol, atol) in (
                ("m", go.m, co.m, TRAIN_M_TOL),
                ("v", go.v, co.v, TRAIN_V_TOL)):
            for (path, g), (_, c) in zip(_tree_paths(g_tree),
                                         _tree_paths(c_tree)):
                err = (g.cpu() - c).abs()
                worst[f"{what}_max_abs_err"] = max(
                    worst[f"{what}_max_abs_err"], float(err.max()))
                if not bool((err <= atol + rtol * c.abs()).all()):
                    bad.append(f"{what} {path}")
        for (path, g), (_, c), (_, w), (_, m), (_, v) in zip(
                *(_tree_paths(t) for t in (gl, cl, lora, go.m, go.v))):
            gap = adamw_gap(g, w, m, v, int(go.step))
            worst["lora_update_max_abs_err"] = max(
                worst["lora_update_max_abs_err"], gap)
            worst["lora_vs_cpu_max_abs_err"] = max(
                worst["lora_vs_cpu_max_abs_err"],
                float((g.cpu() - c).abs().max()))
            if gap > TRAIN_LORA_ATOL:
                bad.append(f"adapter {path}")
        if bad:
            raise AssertionError(f"train_walk step {k} (from the CPU's "
                                 f"state): card beyond tolerance: {bad}")
        state = (cl, co)
        states.append(state)
        losses.append(c_loss)
    return states, losses, worst


def train_batches(cfg, n, seq=32, rows=4):
    """The first ``n`` batches a run of seed 0 draws, as numpy, drawn once
    in this process for both devices."""
    from repro_torch.data.synthetic import SyntheticDataset
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=seq, seed=0)
    return [data.batch(rows) for _ in range(n)]


def _runs_match_walk(name, run, walk_losses):
    """The card run's losses are those of the trajectory walked."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                  walk_losses))
    if len(run["losses"]) != len(walk_losses) or rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{name}: the card run's losses "
                             f"{run['losses']} are not the walk's "
                             f"{walk_losses}")
    return rel


class TrainTap:
    """Taps ``run_training`` / ``train_from_weights`` while entered: the
    host clock of each loop iteration (from one ``Engine.train_step``
    call to the next), of the step's dispatch and of the wait that the
    loop's ``float(ce_loss)`` pull then takes (the tap synchronises
    first, so the pull finds the loss ready), the last batch trained on,
    the seconds of every ``Checkpointer.save`` and ``wait``, and the
    trees ``restore`` returned."""

    def __enter__(self):
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.core.engine import Engine
        self._orig = (Engine.train_step, Checkpointer.save,
                      Checkpointer.wait, Checkpointer.restore)
        step, save, wait, restore = self._orig
        self.starts, self.dispatch_ms, self.pull_ms = [], [], []
        self.save_s, self.wait_s, self.restored = [], [], []

        def train_step(eng, *a, **kw):
            t0 = time.perf_counter()
            self.starts.append(t0)
            self.last_batch = a[3]
            out = step(eng, *a, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            self.dispatch_ms.append((t1 - t0) * 1e3)
            self.pull_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        def timed(fn, into):
            def call(ck, *a, **kw):
                t0 = time.perf_counter()
                out = fn(ck, *a, **kw)
                into.append(time.perf_counter() - t0)
                return out
            return call

        def restore_(ck, *a, **kw):
            out = restore(ck, *a, **kw)
            self.restored.append(out[0])
            return out

        Engine.train_step = train_step
        Checkpointer.save = timed(save, self.save_s)
        Checkpointer.wait = timed(wait, self.wait_s)
        Checkpointer.restore = restore_
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.core.engine import Engine
        self.wall_s = time.perf_counter() - self.t0
        (Engine.train_step, Checkpointer.save, Checkpointer.wait,
         Checkpointer.restore) = self._orig
        return False

    def row(self):
        """Per-iteration host ms (the last step's runs to the end of the
        call: its checkpoint and the final save), dispatch ms, pull ms,
        and the pulls' share of the loop's wall."""
        ends = self.starts[1:] + [self.t0 + self.wall_s]
        it = [(b - a) * 1e3 for a, b in zip(self.starts, ends)]
        return {"step_ms": it, "dispatch_ms": self.dispatch_ms,
                "loss_pull_wait_ms": self.pull_ms,
                "loss_pull_share": sum(self.pull_ms) / max(sum(it), 1e-9),
                "save_s": self.save_s, "wait_s": self.wait_s}


def _ce(model, params, lora_trees, batch):
    """The CE of each adapter on one batch."""
    with torch.no_grad():
        return [float(model.forward_loss(params, lo, batch)[0])
                for lo in lora_trees]


def _held_out(model, seq, rows, rng=None):
    """A batch of the training chain (domain ``alpaca``, seed 0) on the
    card: with ``rng``, rows no training step draws."""
    from repro_torch.data.synthetic import SyntheticDataset
    data = SyntheticDataset("alpaca", vocab_size=model.cfg.vocab_size,
                            seq_len=seq, seed=0)
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in data.batch(rows, rng=rng).items()}


def _to(tree, device):
    """A copy of a tree of tensors (dicts, tuples, NamedTuples) on
    ``device``."""
    from repro_torch.checkpoint.checkpointer import _tree_paths, _unflatten
    return _unflatten(tree, iter([t.to(device, copy=True)
                                  for _, t in _tree_paths(tree)]))


def _bitwise(a, b):
    from repro_torch.checkpoint.checkpointer import _tree_paths
    la, lb = _tree_paths(a), _tree_paths(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for (_, x), (_, y) in zip(la, lb))


def _train_reduced(make_engine, get_config, tmp):
    """(a) the reduced float32 qwen, one weight set: ``train_from_weights``
    on the card, 15 steps (a checkpoint every 5), then 25 with a NaN
    injected at step 12 (steps, kept losses and the rollback line); then
    the trajectory of each run one step at a time, card against CPU
    (``train_walk``): without a fault batch k at step k; with one, steps
    0-11, the faulted step's batch 12 spent, then steps 10-24 from the
    step-10 state on batches 13-27."""
    import contextlib
    import io
    from repro_torch.launch.train import init_weights, train_from_weights
    cfg = get_config(ARCH).scaled()
    params, lora = init_weights(make_engine(cfg, device="cpu"), 0)
    start = (lora, make_engine(cfg, device="cpu").optimizer.init(lora))
    batches = train_batches(cfg, 28)
    row = {}
    for name, kw in (("plain", dict(steps=15)),
                     ("nan", dict(steps=25, inject_nan_at=12))):
        eng = make_engine(cfg, lr=TRAIN_ADAMW[0], device="cuda")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            gpu = train_from_weights(
                eng, _to(params, "cuda"), _to(lora, "cuda"), arch=ARCH,
                batch=4, seq=32, ckpt_every=5, log_every=5,
                ckpt_dir=os.path.join(tmp, f"a_{name}"), **kw)
        rollbacks = [ln for ln in log.getvalue().splitlines()
                     if "non-finite" in ln]
        want_steps = 15 if name == "plain" else 25
        want_kept = want_steps + (2 if name == "nan" else 0)
        want_log = ["step 12: non-finite loss; restoring step 10"] \
            if name == "nan" else []
        if name == "plain":
            _, losses, worst = train_walk(make_engine, cfg, params, start,
                                          batches[:15])
        else:
            states, losses, worst = train_walk(make_engine, cfg, params,
                                               start, batches[:12])
            _, more, worst2 = train_walk(make_engine, cfg, params,
                                         states[10], batches[13:])
            losses += more
            worst = {k: max(v, worst2[k]) for k, v in worst.items()}
        row[name] = {"steps": gpu["steps"], "kept_losses": len(gpu["losses"]),
                     "rollbacks": rollbacks, "first_loss": gpu["losses"][0],
                     "last_loss": gpu["losses"][-1], "walk": worst}
        if not (gpu["steps"] == want_steps
                and len(gpu["losses"]) == want_kept
                and rollbacks == want_log
                and np.isfinite(gpu["losses"]).all()):
            raise AssertionError(f"train_cli (a) {name}: steps, kept losses "
                                 f"or rollbacks differ: {row[name]}")
        row[name]["run_vs_walk_loss_rel_err"] = _runs_match_walk(
            f"train_cli (a) {name}", gpu, losses)
    emit("train_cli_reduced", config=cfg.name, dtype="float32", batch=[4, 32],
         loss_rtol=TRAIN_LOSS_RTOL, lora_atol=TRAIN_LORA_ATOL,
         m_tol=TRAIN_M_TOL, v_tol=TRAIN_V_TOL, **row)
    return row


def phase_train_cli(make_engine, get_config, lm, fa):
    """The training CLI (``launch/train.py``) on the card: (a) card vs
    CPU at the reduced float32 config, through a NaN rollback; (a2)
    held-out CE falls at the reduced config; (b) full width qwen, 4 x
    256, 20 steps, checkpoints every 10: CE on the last batch falls,
    launches as derived, step ms, the pulls' share, checkpoint
    seconds, peak memory; (c) the restart to 30 from (b)'s directory,
    and checkpoints across devices; (d) 4 x 2,048 through
    ``flash_attention``; (e) the CLI, then its restore in a subprocess; (f)
    llama3-8b at the CLI's defaults; (g) ``DataPipeline`` on the card.
    Every lora_matmul launch shape of (b)-(f) was held against the plain
    version by ``kernel_lora``."""
    import contextlib
    import io
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.launch.train import init_weights, run_training
    from repro_torch.optim.adamw import AdamWState
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    per_step = n_lora + n_lora_bwd
    res, shapes = {}, {}
    tmp = tempfile.mkdtemp()
    try:
        res["a"] = _train_reduced(make_engine, get_config, tmp)

        # (a2) tests/test_drivers.py's check on the card: reduced qwen,
        # 30 steps of 8 x 32 at lr 5e-3, held-out CE falls
        out_a2 = run_training(ARCH, smoke=True, steps=30, batch=8, seq=32,
                              ckpt_dir=os.path.join(tmp, "a2"),
                              ckpt_every=10, lr=5e-3, verbose=False,
                              device="cuda")
        eng = make_engine(get_config(ARCH).scaled(), device="cuda")
        params, lora0 = init_weights(eng, 0)
        a2 = _ce(eng.model, params, [lora0, out_a2["lora"]],
                 _held_out(eng.model, 32, 16))
        emit("train_cli_reduced_held_out", config=eng.model.cfg.name,
             steps=out_a2["steps"], batch=[8, 32], lr=5e-3,
             held_out_ce_initial_trained=a2)
        res["a2"] = a2
        if out_a2["steps"] != 30 or not a2[1] < a2[0]:
            raise AssertionError(f"train_cli (a2): held-out CE {a2}")
        del eng, params, lora0, out_a2

        # (b) full width, dense path
        ckb = os.path.join(tmp, "b")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with LoraShapeTap() as st, TrainTap() as tt:
            _reset(lm, fwd, bwd)                          # main path starts
            out_b = run_training(ARCH, smoke=False, steps=TRAIN_STEPS,
                                 batch=4, seq=256, ckpt_dir=ckb,
                                 ckpt_every=TRAIN_CKPT_EVERY, verbose=False,
                                 device="cuda")
            launches = (lm.launches, fwd.launches, bwd.launches)  # ends
        shapes.update(st.shapes)
        eng = make_engine(get_config(ARCH), device="cuda")
        params, lora0 = init_weights(eng, 0)
        trees = [lora0, out_b["lora"]]
        held = _ce(eng.model, params, trees, _held_out(
            eng.model, 256, 8, np.random.default_rng(12345)))
        last = _ce(eng.model, params, trees, tt.last_batch)
        del params, lora0, eng, trees
        b = {"config": ARCH, "dtype": "bfloat16", "batch": [4, 256],
             "steps": out_b["steps"], "losses": out_b["losses"],
             "held_out_ce_initial_trained": held,
             "last_batch_ce_initial_trained": last,
             "lora_matmul_launches": launches[0],
             "lora_matmul_launches_derived": TRAIN_STEPS * per_step,
             "flash_attention_launches": list(launches[1:]),
             "checkpoints": sorted(os.listdir(ckb)), **tt.row(),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit("train_cli_full", **b)
        res["b"] = b
        # at full width the chain has 151,936 states with 7 successors
        # each, which 20 x 1,024 tokens do not teach: held-out CE is
        # reported, and learning is held on the last batch trained on
        # ((a2) holds held-out CE where the chain is learnable)
        if out_b["steps"] != TRAIN_STEPS or not last[1] < last[0]:
            raise AssertionError(f"train_cli (b): CE on the last batch "
                                 f"{last} in {out_b['steps']} steps")
        if launches != (TRAIN_STEPS * per_step, 0, 0):
            raise AssertionError(f"train_cli (b): launches {launches}, "
                                 f"derived {TRAIN_STEPS * per_step}, 0, 0")
        if b["checkpoints"] != ["step_0000000010", "step_0000000020"]:
            raise AssertionError(f"train_cli (b): {b['checkpoints']}")

        # (c) restart from (b)'s directory
        log = io.StringIO()
        with LoraShapeTap() as st, TrainTap() as tt, \
                contextlib.redirect_stdout(log):
            _reset(lm, fwd, bwd)
            out_c = run_training(ARCH, smoke=False, steps=30, batch=4,
                                 seq=256, ckpt_dir=ckb, restore=True,
                                 ckpt_every=TRAIN_CKPT_EVERY, verbose=True,
                                 log_every=100, device="cuda")
            c_launches = lm.launches
        shapes.update(st.shapes)
        got_lora, got_opt = tt.restored[0]
        # a card checkpoint onto the CPU, and a CPU one onto the card
        on_cpu, _ = Checkpointer(ckb).restore((out_b["lora"], got_opt),
                                              step=20, device="cpu")
        mixed = {"lora": _to(out_b["lora"], "cpu"),
                 "bf16": torch.randn(64, 96, generator=torch.Generator()
                                     .manual_seed(4)).to(torch.bfloat16),
                 "step": torch.tensor(20, dtype=torch.int32)}
        ckx = Checkpointer(os.path.join(tmp, "c_cpu"))
        ckx.save(1, mixed, blocking=True)
        on_gpu, _ = ckx.restore(_to(mixed, "cuda"))
        c = {"restored_line": [ln for ln in log.getvalue().splitlines()
                               if ln.startswith("restored")],
             "steps": out_c["steps"], "steps_run": len(out_c["losses"]),
             "restored_lora_bitwise": _bitwise(got_lora, out_b["lora"]),
             "restored_opt_step": int(got_opt.step),
             "restored_on": got_lora["q"]["a"].device.type,
             "card_ckpt_on_cpu_bitwise": _bitwise(on_cpu[0], out_b["lora"])
             and on_cpu[0]["q"]["a"].device.type == "cpu",
             "cpu_ckpt_on_card_bitwise": _bitwise(on_gpu, mixed)
             and on_gpu["bf16"].device.type == "cuda",
             "lora_matmul_launches": c_launches,
             "codec": "zstd" if ckpt_mod.zstandard else "zlib",
             "last_loss": out_c["losses"][-1], **tt.row()}
        emit("train_cli_restart", **c)
        res["c"] = c
        if not (c["restored_line"] == ["restored step 20"]
                and c["steps"] == 30 and c["steps_run"] == 10
                and c["restored_lora_bitwise"] and c["restored_opt_step"] == 20
                and c["restored_on"] == "cuda"
                and c["card_ckpt_on_cpu_bitwise"]
                and c["cpu_ckpt_on_card_bitwise"]
                and c_launches == 10 * per_step
                and isinstance(got_opt, AdamWState)):
            raise AssertionError(f"train_cli (c): restart failed: {c}")
        del out_b, out_c, got_lora, got_opt, on_cpu, on_gpu
        torch.cuda.empty_cache()

        # (d) past the dense limit: flash_attention forward and backward
        torch.cuda.reset_peak_memory_stats()
        with LoraShapeTap() as st, TrainTap() as tt:
            _reset(lm, fwd, bwd)
            out_d = run_training(ARCH, smoke=False, steps=TRAIN_LONG_STEPS,
                                 batch=4, seq=TRAIN_LONG_SEQ, verbose=False,
                                 device="cuda")
            launches = (lm.launches, fwd.launches, bwd.launches)
        shapes.update(st.shapes)
        want = (TRAIN_LONG_STEPS * per_step, TRAIN_LONG_STEPS * n_layers,
                TRAIN_LONG_STEPS * FLASH_BWD * n_layers)
        d = {"batch": [4, TRAIN_LONG_SEQ], "steps": out_d["steps"],
             "losses": out_d["losses"], "launches": list(launches),
             "launches_derived": list(want), **tt.row(),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit("train_cli_long", **d)
        res["d"] = d
        if launches != want or not np.isfinite(out_d["losses"]).all():
            raise AssertionError(f"train_cli (d): launches {launches}, "
                                 f"derived {want}, losses {out_d['losses']}")
        del out_d
        torch.cuda.empty_cache()

        # (e) the CLI's ``main``: in this process, then the restore in a
        # subprocess (one process start, ~20 s, is enough to show the
        # entry point) on the same depth-cut config
        from repro_torch.launch import train as train_mod
        cli_dir = os.path.join(tmp, "e")
        env = dict(os.environ, PYTHONPATH=SRC)
        code = ("import chip_smoke\n"
                "from repro_torch.configs import registry\n"
                "from repro_torch.launch.train import main\n"
                "chip_smoke.cut_depth(registry)\n"
                "main()\n")
        args = ["--arch", ARCH, "--full", "--batch", "4", "--seq",
                str(CLI_SEQ), "--ckpt", cli_dir]
        e = {"batch": [4, CLI_SEQ], "runs": []}
        for extra, want_lines, sub in (
                (["--steps", str(CLI_STEPS)], [f"done: {CLI_STEPS} steps"],
                 False),
                (["--steps", "15", "--restore"],
                 [f"restored step {CLI_STEPS}", "done: 15 steps"], True)):
            t0 = time.perf_counter()
            if sub:
                p = subprocess.run([sys.executable, "-c", code, *args,
                                    *extra], env=env, capture_output=True,
                                   text=True, timeout=600,
                                   cwd=os.path.dirname(
                                       os.path.abspath(__file__)))
                rc, stdout, stderr = p.returncode, p.stdout, p.stderr
            else:
                buf, argv = io.StringIO(), sys.argv
                sys.argv = ["train.py", *args, *extra]
                try:
                    with contextlib.redirect_stdout(buf):
                        train_mod.main()
                finally:
                    sys.argv = argv
                rc, stdout, stderr = 0, buf.getvalue(), ""
            lines = stdout.splitlines()
            ok = rc == 0 and all(
                any(ln.startswith(w) for ln in lines) for w in want_lines)
            e["runs"].append({"args": extra, "subprocess": sub, "rc": rc,
                              "wall_s": time.perf_counter() - t0,
                              "lines": [ln for ln in lines
                                        if ln.startswith(("done",
                                                          "restored"))]})
            if not ok:
                raise AssertionError(f"train_cli (e): {extra} rc "
                                     f"{rc}\n{stdout}\n{stderr[-4000:]}")
        with open(os.path.join(cli_dir, "step_0000000015",
                               "manifest.json")) as f:
            e["codec"] = json.load(f)["codec"]
        e["codec_expected"] = "zstd" if ckpt_mod.zstandard else "zlib"
        emit("train_cli_subprocess", **e)
        res["e"] = e
        if e["codec"] != e["codec_expected"]:
            raise AssertionError(f"train_cli (e): codec {e['codec']}")
        # the CLI runs' launches are not counted here: their shapes are
        # derived (M = 4 x 128, qwen's q/k/v/o, forward and dX)
        m = 4 * CLI_SEQ
        for kind in ("lora_matmul", "lora_matmul_dx"):
            shapes[(kind, m, 1024, 1024, 16, 1, "bfloat16")] = 0

        # (f) llama3-8b at the CLI's defaults: batch 8, seq 64
        l_layers, l_lora, l_bwd = arch_counts(get_config, "llama3-8b")
        torch.cuda.reset_peak_memory_stats()
        with LoraShapeTap() as st, TrainTap() as tt:
            _reset(lm, fwd, bwd)
            out_f = run_training("llama3-8b", smoke=False,
                                 steps=LLAMA_TRAIN_STEPS, batch=8, seq=64,
                                 verbose=False, device="cuda")
            f_launches = lm.launches
        shapes.update(st.shapes)
        f = {"config": "llama3-8b", "batch": [8, 64], "steps": out_f["steps"],
             "losses": out_f["losses"], "lora_matmul_launches": f_launches,
             "lora_matmul_launches_derived": LLAMA_TRAIN_STEPS * (
                 l_lora + l_bwd), **tt.row(),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit("train_cli_llama", **f)
        res["f"] = f
        if not (np.isfinite(out_f["losses"]).all()
                and out_f["steps"] == LLAMA_TRAIN_STEPS
                and f_launches == f["lora_matmul_launches_derived"]):
            raise AssertionError(f"train_cli (f): {f}")
        del out_f
        torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    # (g) the pipeline: sample_fn's batches in order, bitwise, on the card
    data = SyntheticDataset("alpaca", vocab_size=1000, seq_len=64, seed=3)
    twin = SyntheticDataset("alpaca", vocab_size=1000, seq_len=64, seed=3)
    pipe = DataPipeline(data.batch, 4)
    got = [next(pipe) for _ in range(4)]
    want_b = [twin.batch(4) for _ in range(4)]
    g_ok = all(v.device.type == "cuda" and torch.equal(
        v.cpu(), torch.as_tensor(w[k])) for gb, w in zip(got, want_b)
        for k, v in gb.items()) and all(gb.keys() == w.keys()
                                        for gb, w in zip(got, want_b))
    emit("train_cli_pipeline", batches=len(got), in_order_bitwise=g_ok)
    if not g_ok:
        raise AssertionError("train_cli (g): DataPipeline batches differ")

    unchecked = [k for k in shapes if not lora_shape_checked(*k)]
    emit("train_cli_shapes", lora_shapes=[list(k) + [v] for k, v in
                                           sorted(shapes.items())],
         unchecked=[list(k) for k in unchecked])
    if unchecked:
        raise AssertionError(f"train_cli: launched at shapes no kernel "
                             f"phase checked: {unchecked}")
    return res


def phase_experiment():
    """The paper's comparison harness (``runtime/experiment.py``): the
    five policies at ``tests/test_experiment.py``'s short configuration
    (6 replicas, 420 s simulated, seed 3), held to those tests' checks.
    Simulated: the outputs are the simulator's arithmetic on the
    replicas' interference surfaces, not card times (only
    ``control_wall_s`` is a host clock)."""
    from repro_torch.runtime.experiment import (
        POLICIES, ExperimentConfig, run_experiment)
    outs = {}
    for policy in POLICIES:
        t0 = time.perf_counter()
        out = run_experiment(ExperimentConfig(
            policy=policy, n_replicas=6, duration=420.0, scale=1.0, seed=3))
        outs[policy] = {k: v for k, v in out.items() if not k.startswith("_")}
        emit("experiment", simulated=True, wall_s=time.perf_counter() - t0,
             **outs[policy])
    bad = [p for p, o in outs.items()
           if not (o["requests"] > 0 and o["completed"] > 0
                   and o["slo_rate"] > 0.3)]
    c = outs["collm"]
    if bad or not (c["fl_rounds"] > 0 and c["mean_loss"] < 2.4
                   and all(c["mean_quality"] > outs[p]["mean_quality"]
                           for p in POLICIES if p != "collm")
                   and c["mean_util"] > outs["peft"]["mean_util"]
                   and c["overhead_frac"] < 0.05):
        raise AssertionError(f"experiment: checks failed ({bad}): {outs}")
    return outs

# ---------------------------------------------------------------- tick ----
def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0)


def _is_lora(key):
    return "lora_wg_kernel" in key or "lora_fma_kernel" in key \
        or "lora_dec_kernel" in key


def _is_seg(key):
    return "segmented_wg_kernel" in key or "segmented_fma_kernel" in key \
        or "segmented_dec_kernel" in key


def _is_flash(key):
    return "fa_fwd_" in key or "fa_bwd_" in key or "fa_dkdv_" in key \
        or "fa_dq_" in key or "fa_delta" in key


def _is_ssd(key):
    return "ssd_scan_kernel" in key


def _is_ssd_bwd(key):
    return "ssd_scan_bwd" in key


# (context, prompt length, co-training, tenants: 0 = one adapter, arch)
TICKS = [("serve", 32, False, 0, ARCH), ("long", 992, False, 0, ARCH),
         ("combined", 32, True, 0, ARCH), ("serve_2048", 2048, False, 0, ARCH),
         ("combined_2048", 2048, True, 0, ARCH),
         ("serve_4_tenants", 32, False, 4, ARCH),
         ("ssm_serve", 32, False, 0, SSM_ARCH),
         ("ssm_combined", 32, True, 0, SSM_ARCH),
         ("hybrid_serve", 32, False, 0, HYBRID_ARCH),
         ("hybrid_combined", 32, True, 0, HYBRID_ARCH)]
# the 48-layer moonshot tick (56 GB of weights), the bring-up phase
# tick_moe's alone since PR 29 (the full run's time went to the mesh
# phase; PERF.md keeps its row); mamba2's tick after 2,048-token prompts,
# whose device time equalled the 32-token one's (PERF.md §5), went then
TICKS_MOE = [("moe_serve", 32, False, 0, MOE_ARCH)]


# ticks a window: 3 timed on the host clock, then 3 under the profiler,
# which records the card's activity only: the host's operators would
# make most of the phase's time the profiler's own post-processing
TICK_WINDOW = 3


def phase_tick(make_engine, get_config, n=TICK_WINDOW, ticks=TICKS,
               waves=True):
    """Where a full-width tick's time goes (8 busy slots; paged, and
    contiguous for mamba2): serve ticks at 32-, 992- and 2,048-token
    prompts and combined ticks whose train batch is 4 x the prompt length
    (built before timing).  Host wall per tick, then under torch.profiler
    the device time its kernels take, each ported kernel's part, and
    kernels per tick.  One tick serves 4 tenants, round-robin over the 8
    slots; the last two are mamba2-780m decode ticks (no attention: the
    O(1) state recurrence and the adapter projections), then a mamba2
    combined tick (4 x 32 train rows through the ssd_scan backward),
    hymba-1.5b's serve and combined ticks, and moonshot-v1-16b-a3b's
    serve tick at its published 48 layers, with the expert products'
    part (``_tick_experts``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.fabric import make_tenant_adapters
    from repro_torch.runtime.serving_loop import (
        AdapterRegistry, ContinuousBatcher, GenRequest)
    rng = np.random.default_rng(0)
    arch_now = None
    for name, plen, train, n_tenants, arch in ticks:
        if arch != arch_now:                 # one model at a time
            arch_now, cfg = arch, get_config(arch)
            engine = params = lora = None
            torch.cuda.empty_cache()
            engine = make_engine(cfg, lr=3e-3, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = engine.model.init(gen)
            lora = engine.model.init_lora(gen)
        data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                                seq_len=plen, seed=0)
        reg = None
        if n_tenants:
            reg = AdapterRegistry(engine.model, capacity=n_tenants)
            for t, tree in enumerate(make_tenant_adapters(
                    engine.model, n_tenants, seed=1)):
                reg.register(f"tenant{t}", tree)
        b = ContinuousBatcher(engine, params, lora, n_slots=8,
                              max_seq=plen + 16, prompt_pad=plen,
                              paged=not cfg.has_ssm,
                              opt_state=engine.optimizer.init(lora),
                              adapters=reg)
        for i in range(8):
            b.submit(GenRequest(request_id=i, max_new_tokens=16,
                                prompt=rng.integers(0, cfg.vocab_size, plen),
                                adapter_id=f"tenant{i % n_tenants}"
                                if n_tenants else None))
        # train batches on the card before any timing
        batches = iter([{k: torch.as_tensor(v, device="cuda")
                         for k, v in data.batch(4).items()}
                        for _ in range(3 + 2 * n)] if train else [])

        def tick():
            b.step(train_batch=next(batches, None))

        for _ in range(3):                   # admission wave + warm ticks
            tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                tick()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) / n * 1e3
        assert len(b.active_slots()) == 8, "a slot finished inside the window"
        assert b.stats.train_steps == (3 + 2 * n if train else 0)
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

        def part(pred):
            return sum(_device_us(e) for e in kern if pred(e.key)) / 1e3 / n

        dev_ms = part(lambda key: True)
        moe_row = _tick_experts(cfg, params, dev_ms) if cfg.n_experts \
            else {}
        attn_ms = part(lambda key: "paged_decode_kernel" in key)
        lora_ms = part(_is_lora)
        flash_ms = part(_is_flash)
        seg_ms = part(_is_seg)
        top = sorted(kern, key=_device_us, reverse=True)[:6]
        emit("tick", context=name, arch=arch, paged=not cfg.has_ssm,
             prompt_len=plen, slots=8,
             tenants=n_tenants, train_batch=[4, plen] if train else None,
             host_ms_per_tick=host_ms, profiled_wall_ms_per_tick=prof_ms,
             device_busy_ms_per_tick=dev_ms,
             device_busy_share=dev_ms / prof_ms if prof_ms else None,
             attention_ms_per_tick=attn_ms,
             attention_share_of_device=attn_ms / dev_ms if dev_ms else None,
             lora_matmul_ms_per_tick=lora_ms,
             lora_matmul_share_of_device=lora_ms / dev_ms if dev_ms else None,
             flash_attention_ms_per_tick=flash_ms,
             flash_attention_share_of_device=flash_ms / dev_ms
             if dev_ms else None,
             segmented_lora_matmul_ms_per_tick=seg_ms,
             segmented_lora_matmul_share_of_device=seg_ms / dev_ms
             if dev_ms else None,
             segmented_lora_matmul_launches_per_tick=sum(
                 e.count for e in kern if _is_seg(e.key)) / n,
             lora_matmul_launches_per_tick=sum(
                 e.count for e in kern if _is_lora(e.key)) / n,
             flash_attention_launches_per_tick=sum(
                 e.count for e in kern if _is_flash(e.key)) / n,
             ssd_scan_launches_per_tick=sum(
                 e.count for e in kern if _is_ssd(e.key)) / n,
             ssd_scan_backward_ms_per_tick=part(_is_ssd_bwd),
             ssd_scan_backward_launches_per_tick=sum(
                 e.count for e in kern if _is_ssd_bwd(e.key)) / n,
             kernels_per_tick=sum(e.count for e in kern) / n,
             top_kernels_ms_per_tick=[[e.key[:60], _device_us(e) / 1e3 / n]
                                      for e in top], **moe_row)
        del b, batches, reg
        torch.cuda.empty_cache()
    del engine, params, lora
    torch.cuda.empty_cache()
    if waves:
        _tick_waves(make_engine, get_config, n)
        _tick_vlm(make_engine, get_config, n)


def _tick_experts(cfg, params, dev_ms):
    """An MoE tick's expert products: every layer's three expert
    ``torch.bmm`` calls at a decode tick's capacity (8 slots: moonshot's 6
    slots an expert, so any expert may be taken and every expert's
    weights are read), timed alone (CUDA events, median of 5), and their
    share of the tick's device busy ``dev_ms``; the least time of reading
    every layer's weights and the head once (HBM_BYTES_S)."""
    from repro_torch.models.moe import capacity
    from repro_torch.tree import tree_leaves
    blk = params["blocks"]["moe"]
    c = capacity(8, cfg)
    ein = torch.zeros((cfg.n_experts, c, cfg.d_model), dtype=blk["wg"].dtype,
                      device="cuda")
    h = torch.zeros((cfg.n_experts, c, cfg.d_ff), dtype=blk["wg"].dtype,
                    device="cuda")

    def products():
        for i in range(cfg.n_layers):
            torch.bmm(ein, blk["wg"][i])
            torch.bmm(ein, blk["wu"][i])
            torch.bmm(h, blk["wd"][i])

    ms = device_ms(products, reps=5)
    weights = sum(t.numel() * t.element_size() for t in
                  tree_leaves(params["blocks"])) \
        + params["lm_head"].numel() * params["lm_head"].element_size()
    expert_bytes = sum(blk[k].numel() * blk[k].element_size()
                       for k in ("wg", "wu", "wd"))
    return {"n_layers": cfg.n_layers, "experts": cfg.n_experts,
            "capacity": c,
            "expert_products_alone_ms": ms,
            "expert_products_share_of_device": ms / dev_ms if dev_ms else None,
            "expert_products_launches_derived": 3 * cfg.n_layers,
            "expert_weights_bound_ms": expert_bytes / HBM_BYTES_S * 1e3,
            "weights_read_bytes": weights,
            "weights_read_bound_ms": weights / HBM_BYTES_S * 1e3}


def _tick_waves(make_engine, get_config, n):
    """Where a prefill wave's time goes at full width (qwen1.5-0.5b,
    paged blocks of 16, 8 rows), the programs the batcher runs: a full
    wave of the prefix trace's first 8 prompts (``prefill_ragged``, 992
    padded), the suffix wave of the next 8 over their cached 768-token
    prefix (``prefill_ragged_suffix``, 48 blocks, suffix padded to 224),
    and a 256-token chunk wave at offset 512 over the first 8's blocks.
    Host wall per wave, then under torch.profiler device ms, lora_matmul's
    part and kernels per wave."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.paging import blocks_for
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    m = eng.model
    prompts = prefix_trace(m.cfg.vocab_size)
    bs, pad = 16, 992
    nb = blocks_for(pad, bs)
    pool = m.init_paged_caches(1 + 8 * nb, bs)
    tables = np.arange(1, 1 + 8 * nb, dtype=np.int32).reshape(8, nb)
    full = np.zeros((8, pad), np.int64)
    for j, p in enumerate(prompts[:8]):
        full[j, :len(p)] = p
    lens = torch.tensor([len(p) for p in prompts[:8]], device="cuda")
    toks = torch.tensor(full, device="cuda")
    with torch.no_grad():
        _, pre = m.prefill_ragged(params, lora, {"tokens": toks}, lens)
    m.write_prefill_blocks(pool, pre, tables)
    del pre
    # rows j of the next 8 prompts share family j % 2 with row j's prefix
    tails = [p[PREFIX_HEAD:] for p in prompts[8:]]
    suf = np.zeros((8, 224), np.int64)
    for j, t in enumerate(tails):
        suf[j, :len(t)] = t
    chunk = full[:, 512:768]
    waves = {
        "full_8x992": lambda: m.prefill_ragged(
            params, lora, {"tokens": toks}, lens),
        "suffix_8x224_over_768": lambda: m.prefill_ragged_suffix(
            params, lora, {"tokens": torch.tensor(suf, device="cuda")},
            np.array([len(t) for t in tails]), np.full(8, PREFIX_HEAD),
            pool, tables),
        "chunk_8x256_at_512": lambda: m.prefill_ragged_suffix(
            params, lora, {"tokens": torch.tensor(chunk, device="cuda")},
            np.full(8, 256), np.full(8, 512), pool, tables[:, :32]),
    }
    for name, fn in waves.items():
        with torch.no_grad():
            fn()                                   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) / n * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(_device_us(e) for e in kern) / 1e3 / n
        lora_ms = sum(_device_us(e) for e in kern if _is_lora(e.key)) \
            / 1e3 / n
        top = sorted(kern, key=_device_us, reverse=True)[:6]
        emit("tick", context=name, arch=ARCH, paged=True, block_size=bs,
             host_ms_per_wave=host_ms, profiled_wall_ms_per_wave=prof_ms,
             device_busy_ms_per_wave=dev_ms,
             device_busy_share=dev_ms / prof_ms if prof_ms else None,
             lora_matmul_ms_per_wave=lora_ms,
             lora_matmul_share_of_device=lora_ms / dev_ms if dev_ms else None,
             kernels_per_wave=sum(e.count for e in kern) / n,
             top_kernels_ms_per_wave=[[e.key[:60], _device_us(e) / 1e3 / n]
                                      for e in top])
    del eng, params, lora, pool
    torch.cuda.empty_cache()


def _is_decode(key):
    return "decode_attn_split_kernel" in key \
        or "decode_attn_combine_kernel" in key or "decode_attn_bf16" in key


def _tick_vlm(make_engine, get_config, n):
    """A VLM decode tick at 8 busy slots (``Engine.decode_step`` after a
    32-token prefill wave): host wall per tick, then under torch.profiler
    device time, decode_attention's and the other kernels' parts, and
    kernels per tick."""
    from torch.profiler import ProfilerActivity, profile
    slots, plen = 8, 32
    engine, params, lora, gen = _vlm_full(make_engine, get_config)
    model, cfg = engine.model, engine.model.cfg
    toks = torch.randint(0, cfg.vocab_size, (slots, plen), device="cuda",
                         generator=gen)
    vis = torch.randn((slots, cfg.vision_tokens, cfg.d_model), generator=gen,
                      device="cuda", dtype=torch.bfloat16)
    logits, pre = engine.prefill_step(params, lora, {"tokens": toks,
                                                     "vision": vis})
    caches = _vlm_decode_caches(model, pre, slots, plen + 3 + 2 * n)
    del pre
    state = {"tok": logits[:, -1].argmax(-1), "pos": plen}

    def tick():
        pos = torch.full((slots,), state["pos"], dtype=torch.int32,
                         device="cuda")
        lg, _ = engine.decode_step(params, lora, caches,
                                   state["tok"][:, None], pos)
        state["tok"] = lg[:, -1].argmax(-1)
        state["pos"] += 1

    for _ in range(3):                       # warm ticks
        tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        tick()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / n * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]

    def part(pred):
        return sum(_device_us(e) for e in kern if pred(e.key)) / 1e3 / n

    dev_ms = part(lambda key: True)
    dec_ms = part(_is_decode)
    top = sorted(kern, key=_device_us, reverse=True)[:6]
    emit("tick", context="vlm_decode", arch=VLM_ARCH, n_layers=cfg.n_layers,
         paged=False, prompt_len=plen, slots=slots, tenants=0,
         train_batch=None, host_ms_per_tick=host_ms,
         profiled_wall_ms_per_tick=prof_ms, device_busy_ms_per_tick=dev_ms,
         device_busy_share=dev_ms / prof_ms if prof_ms else None,
         decode_attention_ms_per_tick=dec_ms,
         decode_attention_share_of_device=dec_ms / dev_ms if dev_ms else None,
         decode_attention_launches_per_tick=sum(
             e.count for e in kern if _is_decode(e.key)) / n,
         attention_ms_per_tick=part(lambda key: "paged_decode_kernel" in key),
         lora_matmul_ms_per_tick=part(_is_lora),
         kernels_per_tick=sum(e.count for e in kern) / n,
         top_kernels_ms_per_tick=[[e.key[:60], _device_us(e) / 1e3 / n]
                                  for e in top])
    del engine, params, lora, caches, logits, vis, state
    torch.cuda.empty_cache()


# ------------------------------------------------- live fabric (ROADMAP 2) -
FABRIC_REQUESTS, FABRIC_PROMPT, FABRIC_GEN = 16, 32, 16
FABRIC_SLOTS = 4            # per replica: 2 replicas x 4 = one batcher's 8
FAIL_TICK = 6               # (l-b): r1 fails over at this fabric tick


class _EngineTap:
    """Stands in for one replica's batcher engine: forwards everything,
    and counts the train microbatches of every train step it is asked for
    (``grad_accum`` of each, since each microbatch runs the adapter
    projections forward and their dX), the fused steps, and whether every
    fused step inside a round had its decode read the replica's published
    tree (``serve_lora``; the optimizer steps the shadow)."""

    def __init__(self, eng, rep):
        self._eng, self._rep = eng, rep
        self.micro = 0
        self.fused = 0
        self.fused_in_round = 0
        self.decode_read_published = True

    def __getattr__(self, k):
        return getattr(self._eng, k)

    def _train(self, kw):
        self.micro += kw.get("grad_accum", 1)

    def train_step(self, *a, **kw):
        self._train(kw)
        return self._eng.train_step(*a, **kw)

    def _fused(self, lora, kw):
        self._train(kw)
        self.fused += 1
        b = self._rep.batcher
        if self._rep._session is not None:
            self.fused_in_round += 1
            want = b.adapters.device_lora() if b.adapters is not None \
                else b.lora
            if kw.get("serve_lora") is not want:
                self.decode_read_published = False

    def combined_step(self, params, lora, *a, **kw):
        self._fused(lora, kw)
        return self._eng.combined_step(params, lora, *a, **kw)

    def combined_step_paged(self, params, lora, *a, **kw):
        self._fused(lora, kw)
        return self._eng.combined_step_paged(params, lora, *a, **kw)


def _tree_equal(a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


def lora_shape_checked(kind, m, k, n, r, na, dtype):
    """Whether phase_kernel_lora or phase_kernel_seg held the kernel
    against its plain version at a launch's shape: a LORA_SHAPES row of
    that M, K, N, r and dtype (a dX launch, ``lora_matmul`` on the
    transposed operands, needs a row whose backward is checked, with K
    and N swapped), or a SEG_SHAPES row of that M, K, N, r and slot
    count (checked in both dtypes)."""
    if kind == "segmented_lora_matmul":
        return any(row[1:6] == (m, k, n, r, na) for row in SEG_SHAPES)
    for name, m2, k2, n2, r2 in LORA_SHAPES:
        if (m2, r2) != (m, r) or dtype not in [
                str(d).split(".")[-1] for d in lora_dtypes(name)]:
            continue
        if kind == "lora_matmul" and (k2, n2) == (k, n):
            return True
        if kind == "lora_matmul_dx" and (n2, k2) == (k, n) \
                and lora_has_backward(name):
            return True
    return False


class LoraShapeTap:
    """Records the shape of every ``lora_matmul`` / ``segmented_lora_
    matmul`` launch while it is entered (forward, and the dX of
    ``LoRAMatmulFn``'s backward) as (kind, M, K, N, r, slots, dtype):
    launch count, the keys ``lora_shape_checked`` reads."""

    def __enter__(self):
        import repro_torch.kernels.lora_matmul as lm_mod
        self._lm_mod = lm_mod
        self._lm_orig = (lm_mod._launch, lm_mod._check_seg,
                         lm_mod.LoRAMatmulFn.backward)
        launch, check_seg, backward = self._lm_orig
        self.shapes = {}
        in_bwd = [False]

        def note(key):
            self.shapes[key] = self.shapes.get(key, 0) + 1

        def rec_launch(x, w, a, b, scaling):
            note(("lora_matmul_dx" if in_bwd[0] else "lora_matmul",
                  x.shape[0], x.shape[1], w.shape[1], a.shape[1], 1,
                  _dtype_name(x)))
            return launch(x, w, a, b, scaling)

        def rec_check_seg(x, w, a, b, idx):
            note(("segmented_lora_matmul", x.shape[0], x.shape[1],
                  w.shape[1], a.shape[2], a.shape[0], _dtype_name(x)))
            return check_seg(x, w, a, b, idx)

        def rec_backward(ctx, dy):
            in_bwd[0] = True
            try:
                return backward(ctx, dy)
            finally:
                in_bwd[0] = False

        lm_mod._launch, lm_mod._check_seg = rec_launch, rec_check_seg
        lm_mod.LoRAMatmulFn.backward = staticmethod(rec_backward)
        return self

    def __exit__(self, *exc):
        lm = self._lm_mod
        lm._launch, lm._check_seg = self._lm_orig[:2]
        lm.LoRAMatmulFn.backward = staticmethod(self._lm_orig[2])
        return False

    def unchecked(self):
        """The recorded shapes no kernel phase held against the plain
        version."""
        return [k for k in self.shapes if not lora_shape_checked(*k)]


def attn_shape_checked(kind, *shape):
    """Whether phase_kernel_flash or phase_kernel held the kernel against
    its plain version at a launch's shape (both check every row in both
    dtypes): a FLASH_SHAPES row of that B, H, Hkv, D, S, window and
    mask (its backward is checked too), or a PAGED_SHAPES row of that B,
    H, Hkv, D, block size and table width."""
    if kind in ("flash_attention", "flash_attention_backward"):
        return any(row[1:] == shape[:7] for row in FLASH_SHAPES)
    rows = LSE_SHAPES if kind == "paged_decode_attention_lse" \
        else PAGED_SHAPES
    return any(tuple(row[1][k] for k in ("b", "h", "hkv", "d", "bs", "nb"))
               == shape[:6] for row in rows)


class AttnShapeTap:
    """Records the shape of every ``flash_attention`` forward and
    backward and ``paged_decode_attention`` launch while it is entered:
    (kind, B, H, Hkv, D, S, window, causal, dtype) and (kind, B, H, Hkv, D,
    block size, table width, dtype) -> launch count, the keys
    ``attn_shape_checked`` reads."""

    def __enter__(self):
        import repro_torch.kernels.decode_attention as da_mod
        from repro_torch.kernels.flash_attention import FlashAttentionFn
        self._da, self._fn = da_mod, FlashAttentionFn
        self._orig = (FlashAttentionFn.forward, FlashAttentionFn.backward,
                      da_mod._launch)
        fwd, bwd, launch = self._orig
        self.shapes = {}

        def note(key):
            self.shapes[key] = self.shapes.get(key, 0) + 1

        def flash_key(kind, q, k, window, causal):
            b, h, s, d = q.shape
            return (kind, b, h, k.shape[1], d, s, window, bool(causal),
                    _dtype_name(q))

        def rec_fwd(ctx, q, k, v, causal, window, scale):
            if q.device.type != "cpu":
                note(flash_key("flash_attention", q, k, window, causal))
            return fwd(ctx, q, k, v, causal, window, scale)

        def rec_bwd(ctx, do):
            saved = ctx.saved_tensors
            if len(saved) == 5:          # the kernel's forward saved o, lse
                note(flash_key("flash_attention_backward", saved[0],
                               saved[1], ctx.window, ctx.causal))
            return bwd(ctx, do)

        def rec_launch(q, k_pool, v_pool, block_tables, kv_len, scale,
                       return_lse=False):
            note(("paged_decode_attention_lse" if return_lse
                  else "paged_decode_attention", q.shape[0], q.shape[1],
                  k_pool.shape[2], q.shape[2], k_pool.shape[1],
                  block_tables.shape[1], _dtype_name(q)))
            return launch(q, k_pool, v_pool, block_tables, kv_len, scale,
                          return_lse)

        FlashAttentionFn.forward = staticmethod(rec_fwd)
        FlashAttentionFn.backward = staticmethod(rec_bwd)
        da_mod._launch = rec_launch
        return self

    def __exit__(self, *exc):
        fwd, bwd, self._da._launch = self._orig
        self._fn.forward, self._fn.backward = staticmethod(fwd), \
            staticmethod(bwd)
        return False

    def unchecked(self):
        """The recorded shapes no kernel phase held against the plain
        version."""
        return [k for k in self.shapes if not attn_shape_checked(*k)]

    def summary(self):
        """The recorded shapes as a JSON-able list."""
        return [[*k, n] for k, n in sorted(self.shapes.items())]


def ssd_bwd_shape_checked(kind, b, s, h, p, n, dtype):
    """Whether kernel_ssd_bwd held the backward against its plain version
    at a launch's shape: an SSD_BWD_SHAPES row of that B, S, H, P and N
    (each row runs in float32 and bfloat16)."""
    return dtype in ("float32", "bfloat16") and any(
        row[1:6] == (b, s, h, p, n) for row in SSD_BWD_SHAPES)


class SsdBwdShapeTap:
    """Records the shape of every ``ssd_scan`` backward launch (autograd
    through ``SSDScanFn`` on the card) while it is entered: (kind, B, S,
    H, P, N, dtype) -> launch count, the keys ``ssd_bwd_shape_checked``
    reads."""

    def __enter__(self):
        from repro_torch.kernels.ssd_scan import SSDScanFn
        self._fn = SSDScanFn
        self._orig = SSDScanFn.backward
        bwd = self._orig
        self.shapes = {}

        def rec_bwd(ctx, dy, dfinal):
            x, _, _, bmat = ctx.saved_tensors[:4]
            if x.device.type != "cpu":
                key = ("ssd_scan_backward", *x.shape, bmat.shape[-1],
                       _dtype_name(x))
                self.shapes[key] = self.shapes.get(key, 0) + 1
            return bwd(ctx, dy, dfinal)

        SSDScanFn.backward = staticmethod(rec_bwd)
        return self

    def __exit__(self, *exc):
        self._fn.backward = staticmethod(self._orig)
        return False

    def unchecked(self):
        """The recorded shapes no kernel phase held against the plain
        version."""
        return [k for k in self.shapes if not ssd_bwd_shape_checked(*k)]

    def summary(self):
        """The recorded shapes as a JSON-able list."""
        return [[*k, n] for k, n in sorted(self.shapes.items())]


def lora_summary(tap):
    """A LoraShapeTap's recorded shapes as a JSON-able list."""
    return [[*k, n] for k, n in sorted(tap.shapes.items())]


def require_checked(phase, *taps):
    """Fails ``phase`` if it launched a shape (attention, lora_matmul or
    the ssd_scan backward, as each tap records them) that no kernel phase
    held against the plain version."""
    bad = [k for tap in taps for k in tap.unchecked()]
    if bad:
        raise AssertionError(f"{phase}: launched shapes no kernel phase "
                             f"checked: {bad}")


class FabricTap:
    """Taps the fabric a ``launch/serve.py`` entry point builds (patches
    ``runtime.fabric.build_fabric`` for the call; the port's own
    ``warm_up`` has run inside it, and its seconds are kept): records the
    shape of every ``lora_matmul`` / ``segmented_lora_matmul`` launch
    (forward, and the dX of ``LoRAMatmulFn``'s backward), sets the
    kernels' counts to 0 and the peak memory mark as
    ``ServingFabric.run`` starts and reads them as it returns; times every
    ``ServingFabric.tick`` and its ``ClusterController.tick``; counts the
    replicas' eval probes, train microbatches and fused steps; keeps the
    requests; with ``fail_at`` fails r1 over at that tick; checks at
    every round boundary that the published tree the round's decodes
    read is bitwise the one the round began with, and at every refused
    (non-finite) publish that the served tree is bitwise unchanged."""

    def __init__(self, counters, *, fail_at=None):
        self.counters, self.fail_at = counters, fail_at
        self.tick_s, self.ctl_s = [], []
        self.round_checks, self.blocked_checks = [], []
        self.probes = {}

    def __enter__(self):
        import repro_torch.runtime.fabric as fabric_mod
        # the last phase's fabric sits in reference cycles (its taps)
        gc.collect()
        torch.cuda.empty_cache()
        self._mod, self._orig = fabric_mod, fabric_mod.build_fabric
        self._shape_tap = LoraShapeTap().__enter__()
        self.shapes = self._shape_tap.shapes

        def build(*a, **kw):
            fab, cfg = self._orig(*a, **kw)
            self.attach(fab)
            return fab, cfg

        fabric_mod.build_fabric = build
        return self

    def __exit__(self, *exc):
        self._mod.build_fabric = self._orig
        self._shape_tap.__exit__(*exc)
        return False

    def attach(self, fab):
        self.fab, self.reps = fab, dict(fab.replicas)
        self.params_shared = all(r.params is fab.replicas["r0"].params
                                 and r.batcher.params is r.params
                                 for r in self.reps.values())
        self.taps = {}
        for rid, rep in self.reps.items():
            self.taps[rid] = rep.batcher.engine = _EngineTap(
                rep.batcher.engine, rep)
            self._wrap_replica(rid, rep)
        orig_run, orig_tick = fab.run, fab.tick
        orig_ctl = fab.cluster.tick
        n = [0]

        def ctl(now):
            t = time.perf_counter()
            orig_ctl(now)
            self.ctl_s.append(time.perf_counter() - t)

        def tick(now):
            if self.fail_at is not None and n[0] == self.fail_at \
                    and "r1" in fab.replicas:
                fab.fail_replica("r1", now)
            n[0] += 1
            t = time.perf_counter()
            busy = orig_tick(now)
            self.tick_s.append(time.perf_counter() - t)
            return busy

        def run(requests, **kw):
            self.requests = list(requests)
            torch.cuda.synchronize()
            self.start_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset(*self.counters)                      # main path starts
            t = time.perf_counter()
            out = orig_run(requests, **kw)
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - t
            self.launches = {c.__name__: c.launches
                             for c in self.counters}    # path ends
            self.peak_bytes = torch.cuda.max_memory_allocated()
            return out

        fab.cluster.tick, fab.tick, fab.run = ctl, tick, run

    def _wrap_replica(self, rid, rep):
        from repro_torch.tree import tree_finite, tree_map
        self.probes[rid] = 0
        orig_probe, orig_begin = rep._probe_loss, rep.begin_round
        orig_finish, orig_publish = rep.finish_round, rep.publish_adapter
        snap = {}

        def probe():
            self.probes[rid] += 1
            return orig_probe()

        def begin(*a, **kw):
            snap["round"] = tree_map(torch.clone, rep.lora)
            return orig_begin(*a, **kw)

        def finish(now):
            if "round" in snap:
                self.round_checks.append(
                    _tree_equal(rep.lora, snap.pop("round")))
            shadow = rep.batcher.train_lora
            if shadow is not None and not tree_finite(shadow):
                snap["blocked"] = tree_map(torch.clone, rep.lora)
            return orig_finish(now)

        def publish():
            v = orig_publish()
            if "blocked" in snap:
                self.blocked_checks.append(
                    _tree_equal(rep.lora, snap.pop("blocked")))
            return v

        rep._probe_loss, rep.begin_round = probe, begin
        rep.finish_round, rep.publish_adapter = finish, publish

    def row(self, out):
        """The run's numbers: fabric and per-replica tok/s and busy share,
        TTFT / TPOT, the control tick's host ms, the fault counters and
        whatever the health monitor recorded."""
        c, ft = out["cluster"], out["fault_tolerance"]
        tick_ms = np.asarray(self.tick_s) * 1e3
        ctl_ms = np.asarray(self.ctl_s) * 1e3
        pct = {}
        for key in ("ttft", "tpot"):
            for p in ("p50", "p99"):
                v = c[key][p]
                pct[f"{key}_{p}_ms"] = None if v is None else v * 1e3
        return {
            "replicas": len(self.reps), "requests": len(self.requests),
            "completed": out["completed"],
            "finished": c["finished"],
            "generated_tokens": c["generated_tokens"],
            "run_wall_s": self.wall_s,
            "fabric_tok_s": c["generated_tokens"] / self.wall_s,
            "per_replica": {rid: {
                "finished": row["finished"],
                "generated_tokens": row["generated_tokens"],
                "tok_s": row["throughput_tok_s"],
                "busy_share": row["wall_time"] / self.wall_s,
                "adapter_version": row["adapter_version"],
                "train_loss": row["train_loss"]}
                for rid, row in out["replicas"].items()},
            **pct,
            "ticks": len(self.tick_s),
            "tick_host_ms_p50": float(np.percentile(tick_ms, 50)),
            "tick_host_ms_p99": float(np.percentile(tick_ms, 99)),
            "tick_host_ms_mean": float(tick_ms.mean()),
            "cluster_tick_ms_mean": float(ctl_ms.mean()),
            "cluster_tick_share": float(ctl_ms.sum() / tick_ms.sum()),
            "launches": self.launches,
            "probes": dict(self.probes),
            "train_microbatches": {r: t.micro
                                   for r, t in self.taps.items()},
            "fused_steps": {r: t.fused for r, t in self.taps.items()},
            "fl_rounds": out["fl_rounds"],
            "failovers": ft["failovers"], "quarantines": ft["quarantines"],
            "nan_publishes_blocked": ft["nan_publishes_blocked"],
            "retried_requests": ft["retried_requests"],
            "injected": ft["injected"],
            "health_failures": [list(f) for f in
                                self.fab.health.failures],
            "fault_log": [list(f) for f in ft["log"]],
            "params_shared": self.params_shared,
            "warm_up_s": self.fab.warm_s,
            "lora_shapes": [list(k) + [v] for k, v in
                            sorted(self.shapes.items())],
            "start_bytes": self.start_bytes,
            "peak_bytes": self.peak_bytes,
        }

    def check(self, name, out, row, n_layers, n_lora, n_lora_bwd, *,
              faults=0, seg_serves=False):
        """Every request completes with its whole budget, every pool ends
        all-free, the counters fold, failovers and quarantines equal the
        injected faults, the weights are one copy, and the launches are
        exactly as derived from the replicas' own counts."""
        pda, lm, seg = self.counters[:3]
        if row["failovers"] + row["quarantines"] != faults:
            raise AssertionError(
                f"{name}: {row['failovers']} failovers and "
                f"{row['quarantines']} quarantines for {faults} injected "
                f"faults; health: {row['health_failures']}")
        if out["incomplete_requests"] or out.get("failed_requests") \
                or any(r.completed_at is None
                       or len(r.output_tokens) != r.tokens
                       for r in self.requests):
            raise AssertionError(f"{name}: not every request completed")
        if row["finished"] != len(self.requests):
            raise AssertionError(f"{name}: {row['finished']} finished in "
                                 f"the rollup for {len(self.requests)}")
        for rid, rep in self.reps.items():
            a = rep.batcher.allocator
            if a.n_used or a.reserved:
                raise AssertionError(f"{name}: {rid}'s pool did not drain")
        if not row["params_shared"]:
            raise AssertionError(f"{name}: replicas hold their own params")
        waves = sum(r.batcher.prefill_waves for r in self.reps.values())
        steps = sum(r.batcher.stats.decode_steps
                    for r in self.reps.values())
        probes = sum(self.probes.values())
        micro = sum(t.micro for t in self.taps.values())
        serve = n_lora * (waves + steps)
        want = {pda.__name__: n_layers * steps,
                seg.__name__: serve if seg_serves else 0,
                lm.__name__: (0 if seg_serves else serve) + n_lora * probes
                + (n_lora + n_lora_bwd) * micro}
        for c in self.counters[3:]:
            want[c.__name__] = 0
        row["launches_derived"] = want
        if row["launches"] != want:
            raise AssertionError(f"{name}: launches {row['launches']}, "
                                 f"derived {want}")
        unchecked = self._shape_tap.unchecked()
        if unchecked:
            raise AssertionError(f"{name}: launched at shapes no kernel "
                                 f"phase checks: {unchecked}")


def _fabric_kernels():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention as pda
    from repro_torch.kernels.lora_matmul import (
        lora_matmul as lm, segmented_lora_matmul as seg)
    return (pda, lm, seg, fa.flash_attention_fwd,
            fa.flash_attention_backward)


def _param_bytes(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def phase_fabric(get_config, serve=None):
    """(l-a) ``run_multi_replica_serving`` at full width: 2 replicas of 4
    paged slots (blocks of 16) share one device copy of the weights, 16
    requests of 32 + 16, beside one batcher of 8 slots on the same
    traffic (the serve phase's ``paged`` run, or run here); (l-b) the
    same with r1 failed over at fabric tick ``FAIL_TICK``."""
    from repro_torch.launch.serve import (
        run_multi_replica_serving, run_serving)
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    if serve is None:
        out = run_serving(ARCH, smoke=False, n_requests=FABRIC_REQUESTS,
                          batch_size=2 * FABRIC_SLOTS, seed=0, paged=True,
                          prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
                          device="cuda", verbose=False)
        one = {"throughput_tok_s": out["throughput_tok_s"],
               **latency_percentiles(out)}
    else:
        one = {k: serve["paged"][0][k] for k in (
            "throughput_tok_s", "ttft_p50_ms", "ttft_p99_ms",
            "tpot_p50_ms", "tpot_p99_ms")}
    results = {"one_batcher": one}
    for name, fail_at in (("fabric", None), ("failover", FAIL_TICK)):
        with FabricTap(counters, fail_at=fail_at) as tap:
            out = run_multi_replica_serving(
                ARCH, n_replicas=2, smoke=False,
                n_requests=FABRIC_REQUESTS, prompt_len=FABRIC_PROMPT,
                gen_tokens=FABRIC_GEN, batch_size=FABRIC_SLOTS, seed=0,
                paged=True, device="cuda", verbose=False)
        row = tap.row(out)
        pool = tap.reps["r0"].batcher.cache_bytes()
        row.update(run=name, one_batcher=one,
                   param_bytes=_param_bytes(tap.reps["r0"].params),
                   pool_bytes_per_replica=pool)
        tap.check(name, out, row, n_layers, n_lora, n_lora_bwd,
                  faults=int(fail_at is not None))
        emit("fabric", **row)
        if fail_at is not None and not row["retried_requests"]:
            raise AssertionError("failover: r1 held no request at tick "
                                 f"{fail_at}")
        # one copy of the weights plus the pools: a second copy would add
        # param_bytes; the activations of a 4 x 32 wave are far below it
        if row["peak_bytes"] > row["param_bytes"] * 1.5 \
                + len(tap.reps) * pool:
            raise AssertionError(f"{name}: peak {row['peak_bytes']} bytes")
        results[name] = row
        del tap, out
        torch.cuda.empty_cache()
    return results


def phase_fabric_combined(get_config):
    """(l-c) ``run_combined_fabric_serving``: 2 replicas, 2 FL rounds of 4
    fused steps on a fixed pool of 4 train batches (4 x 32), FedAvg and
    publish at the round boundaries, over the same 16 x (32 + 16)
    traffic."""
    from repro_torch.launch.serve import run_combined_fabric_serving
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    with FabricTap(counters) as tap:
        out = run_combined_fabric_serving(
            ARCH, n_replicas=2, smoke=False, n_requests=FABRIC_REQUESTS,
            prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
            batch_size=FABRIC_SLOTS, seed=0, paged=True, train_batch=4,
            rounds=2, steps_per_round=4, train_pool=4, device="cuda",
            verbose=False)
    row = tap.row(out)
    losses = [r["avg_loss"] for r in out["rounds"]]
    row.update(run="combined", round_avg_loss=losses,
               rounds=[dict(r) for r in out["rounds"]],
               fused_steps_in_round={r: t.fused_in_round
                                     for r, t in tap.taps.items()},
               decode_read_published=all(
                   t.decode_read_published for t in tap.taps.values()),
               round_checks=tap.round_checks)
    tap.check("combined", out, row, n_layers, n_lora, n_lora_bwd)
    emit("fabric_combined", **row)
    versions = [r["adapter_version"] for r in row["per_replica"].values()]
    if out["fl_rounds"] < 2 or min(versions) < 2:
        raise AssertionError(f"combined: {out['fl_rounds']} rounds, "
                             f"versions {versions}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"combined: round losses {losses}")
    if sum(row["fused_steps_in_round"].values()) == 0 \
            or not row["decode_read_published"] \
            or not tap.round_checks or not all(tap.round_checks):
        raise AssertionError("combined: a decode inside a round did not "
                             "read the published tree")
    return row


def phase_fabric_chaos(get_config):
    """(l-d) ``run_combined_fabric_serving`` under ``--chaos``: one crash
    and one NaN round (no stall) from the seeded schedule over 3
    replicas (so that the round survives the crash: a session needs 2
    members), horizon 0.5 s."""
    from repro_torch.launch.serve import run_combined_fabric_serving
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    chaos = {"seed": 0, "horizon": 0.5, "crashes": 1, "stalls": 0,
             "ooms": 0, "nan_rounds": 1}
    with FabricTap(counters) as tap:
        out = run_combined_fabric_serving(
            ARCH, n_replicas=3, smoke=False, n_requests=FABRIC_REQUESTS,
            prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
            batch_size=FABRIC_SLOTS, seed=0, paged=True, train_batch=4,
            rounds=2, steps_per_round=4, train_pool=4, chaos=chaos,
            device="cuda", verbose=False)
    row = tap.row(out)
    crashes = len({rid for _, rid, k in row["injected"] if k == "crash"})
    row.update(run="chaos", chaos=chaos, crashed=crashes,
               blocked_checks=tap.blocked_checks)
    tap.check("chaos", out, row, n_layers, n_lora, n_lora_bwd,
              faults=crashes)
    emit("fabric_chaos", **row)
    if crashes != 1 or row["nan_publishes_blocked"] < 1 \
            or not tap.blocked_checks or not all(tap.blocked_checks):
        raise AssertionError(
            f"chaos: {crashes} crashes, {row['nan_publishes_blocked']} "
            f"publishes blocked, served tree unchanged "
            f"{tap.blocked_checks}")
    return row


def phase_fabric_adapters(get_config):
    """(l-e) ``run_multi_replica_serving(n_adapters=4)``: 4 tenants tagged
    round-robin over 2 replicas, each with every tenant registered."""
    from repro_torch.launch.serve import run_multi_replica_serving
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    with FabricTap(counters) as tap:
        out = run_multi_replica_serving(
            ARCH, n_replicas=2, smoke=False, n_requests=FABRIC_REQUESTS,
            prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
            batch_size=FABRIC_SLOTS, seed=0, paged=True, n_adapters=4,
            device="cuda", verbose=False)
    row = tap.row(out)
    rollup = {a: v["requests"] for a, v in out["cluster"]["adapters"].items()}
    row.update(run="adapters", tenants=4, adapter_requests=rollup,
               adapter_routed=sum(d["adapter_routed"]
                                  for d in out["dispatchers"].values()))
    tap.check("adapters", out, row, n_layers, n_lora, n_lora_bwd,
              seg_serves=True)
    emit("fabric_adapters", **row)
    if sum(rollup.values()) != row["finished"] \
            or row["launches"]["segmented_lora_matmul"] == 0:
        raise AssertionError(f"adapters: rollup {rollup}, launches "
                             f"{row['launches']}")
    for rid, rep in tap.reps.items():
        if any(rep.adapters.refcount(a) for a in rep.adapters.registered()):
            raise AssertionError(f"adapters: {rid} holds adapter refs")
    return row


def phase_fabric_reference(make_engine, get_config):
    """(l-a) and (l-b) with token identity, reduced float32 config: the
    port's fabric on the card (2 replicas of 2 paged slots, blocks of 4)
    emits the greedy tokens of one batcher on the card over the same
    weights, and of the same fabric on the CPU (the weights copied
    across); with r1 failed over at tick 3 too."""
    from repro_torch.core.interfaces import Request
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.fabric import build_fabric, fabric_from_weights
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    from repro_torch.tree import tree_map

    lens, gens = [6, 9, 4, 8, 7, 5, 10, 6], [5, 4, 6, 3, 5, 4, 6, 5]
    data = SyntheticDataset("alpaca", vocab_size=get_config(ARCH).scaled()
                            .vocab_size, seq_len=10, seed=3)
    toks = data.sample_tokens(len(lens))
    prompts = [toks[i, :n].astype(np.int32) for i, n in enumerate(lens)]
    kw = dict(n_slots=2, prompt_len=10, gen_tokens=6, paged=True,
              block_size=4)

    def drive(fab, fail_at=None):
        stream = next(iter(fab.replicas.values())).model_id
        reqs = [Request(request_id=i, stream_id=stream, arrival=0.0,
                        deadline=1e9, tokens=gens[i], prompt=prompts[i])
                for i in range(len(lens))]
        for r in reqs:
            fab.submit(r)
        t0 = time.perf_counter()
        for it in range(5000):
            now = time.perf_counter() - t0
            if it == fail_at:
                fab.fail_replica("r1", now)
            busy = fab.tick(now)
            if not busy and all(r.completed_at is not None for r in reqs):
                break
            if not busy:
                time.sleep(0.002)
        if any(r.completed_at is None or len(r.output_tokens) != r.tokens
               for r in reqs):
            raise AssertionError("fabric_reference: not every request "
                                 "completed")
        return [r.output_tokens for r in reqs]

    fab, _ = build_fabric(ARCH, 2, smoke=True, device="cuda", **kw)
    rep = fab.replicas["r0"]
    eng, params = rep.engine, rep.params
    lora = tree_map(torch.clone, rep.lora)
    card = drive(fab)
    fab_f, _ = build_fabric(ARCH, 2, smoke=True, device="cuda", **kw)
    failed = drive(fab_f, fail_at=3)
    single = [GenRequest(request_id=i, prompt=p.copy(),
                         max_new_tokens=gens[i])
              for i, p in enumerate(prompts)]
    ContinuousBatcher(eng, params, lora, n_slots=4, max_seq=16,
                      prompt_pad=10, paged=True, block_size=4).run(single)
    ceng = make_engine(get_config(ARCH).scaled(), lr=3e-3, device="cpu")
    cpu = tree_map(lambda t: t.cpu(), {"p": params, "l": lora})
    fab_c = fabric_from_weights(ceng, cpu["p"], cpu["l"], 2, **kw)
    on_cpu = drive(fab_c)
    row = {"requests": len(lens), "card_equals_one_batcher":
           card == [r.tokens for r in single],
           "card_equals_cpu": card == on_cpu,
           "failover_equals_never_failed": failed == card,
           "failovers": fab_f.failovers,
           "failover_finished_on_r1": fab_f.retired_stats["r1"].finished,
           "failover_requeued": fab_f.retry_policy.retried,
           "health_failures": [list(f) for f in fab.health.failures]}
    emit("fabric_reference", **row)
    if not (row["card_equals_one_batcher"] and row["card_equals_cpu"]
            and row["failover_equals_never_failed"]) \
            or row["failovers"] != 1 or not row["failover_requeued"] \
            or fab.failovers \
            or fab.quarantines or fab_f.quarantines:
        raise AssertionError(f"fabric_reference: {row}")
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--time-kernels"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        return time_kernels(sys.argv[3:])
    if sys.argv[1:2] == ["--ab"]:
        print(smi(), flush=True)
        return run_ab(sys.argv[2], sys.argv[3:])
    from repro_torch.configs import registry
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.decode_attention import (
        decode_attention as dattn, decode_attention_ref as dattn_ref,
        paged_decode_attention as pda, paged_decode_attention_ref as pda_ref,
        paged_decode_attention_lse_ref as pda_lse_ref)
    from repro_torch.kernels.lora_matmul import (
        LoRAMatmulFn, lora_matmul as lm, lora_matmul_ref as lm_ref,
        segmented_lora_matmul as seg, segmented_lora_matmul_ref as seg_ref)
    from repro_torch.launch.serve import run_serving
    from repro_torch.models.model import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global N_LORA, N_LORA_BWD
    whole = cut_depth(registry)
    _, N_LORA, N_LORA_BWD = arch_counts(get_config, ARCH)
    set_depth(registry, whole, False)
    card = smi()
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # one nvcc per source, all started together: library() builds on
    # first use and waits on nvcc outside the GIL
    t0 = time.perf_counter()
    built = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(built)) as pool:
        list(pool.map(_build.library, built))
    emit("build", seconds=time.perf_counter() - t0, built=built)

    phases = {
        "kernel": lambda: phase_kernel(pda, pda_ref),
        "kernel_lse": lambda: phase_kernel_lse(pda, pda_lse_ref),
        "kernel_lora": lambda: phase_kernel_lora(lm, lm_ref, LoRAMatmulFn),
        "kernel_flash": lambda: phase_kernel_flash(fa),
        "kernel_seg": lambda: phase_kernel_seg(seg, seg_ref, lm),
        "kernel_ssd": lambda: phase_kernel_ssd(ssd),
        "kernel_decode": lambda: phase_kernel_decode(dattn, dattn_ref),
        "reference": lambda: phase_reference(get_config, build, make_engine,
                                             lm, ssd.ssd_scan, dattn),
        "reference_blockwise": lambda: phase_reference_blockwise(
            get_config, build, make_engine, fa),
        "serve": lambda: phase_serve(run_serving, get_config, pda, lm, fa,
                                     seg),
        "serve_prefix": lambda: phase_serve_prefix(make_engine, get_config,
                                                   pda, lm, fa, seg),
        "serve_chunked": lambda: phase_serve_chunked(make_engine, get_config,
                                                     pda, lm, fa, seg),
        "serve_oversub": lambda: phase_serve_oversub(
            make_engine, get_config, pda, pda_ref, lm, fa, seg),
        "static": lambda: phase_static(make_engine, get_config, pda, lm, fa,
                                       seg),
        "mesh": lambda: phase_mesh(make_engine, get_config),
        "serve_ssm": lambda: phase_serve_ssm(run_serving, get_config, pda,
                                             lm, fa, seg, ssd.ssd_scan),
        "serve_hybrid": lambda: phase_serve_hybrid(
            run_serving, make_engine, get_config, pda, lm, fa, seg,
            ssd.ssd_scan),
        "serve_vlm": lambda: phase_serve_vlm(make_engine, get_config, pda, lm,
                                             fa, seg, ssd.ssd_scan, dattn),
        # on serve_vlm's weights, so right after it
        "combined_vlm": lambda: phase_combined_vlm(make_engine, get_config,
                                                   pda, lm, fa, seg, dattn),
        "combined": lambda: phase_combined(run_serving, get_config, pda, lm,
                                           fa, seg),
        "combined_ssm": lambda: phase_combined_ssm(
            run_serving, make_engine, get_config, pda, lm, fa, seg,
            ssd.ssd_scan, ssd.ssd_scan_bwd),
        "budget": lambda: phase_budget(run_serving, make_engine, get_config,
                                       pda, lm, fa, seg, out.get("combined")),
        "serve_adapters": lambda: phase_serve_adapters(
            run_serving, get_config, pda, lm, fa, seg, out.get("serve")),
        "mixed_solo": lambda: phase_mixed_solo(get_config, make_engine, seg,
                                               lm),
        "fabric_reference": lambda: phase_fabric_reference(make_engine,
                                                           get_config),
        # its one-batcher baseline run here, at the fabric's whole depth
        "fabric": lambda: phase_fabric(get_config),
        "fabric_combined": lambda: phase_fabric_combined(get_config),
        "fabric_chaos": lambda: phase_fabric_chaos(get_config),
        "fabric_adapters": lambda: phase_fabric_adapters(get_config),
        "train": lambda: phase_train(make_engine, get_config, lm),
        "train_cli": lambda: phase_train_cli(make_engine, get_config, lm, fa),
        "train_cli_ssm": lambda: phase_train_cli_ssm(
            make_engine, get_config, lm, ssd.ssd_scan, ssd.ssd_scan_bwd),
        "moe_route": phase_moe_route,
        "serve_moe": lambda: phase_serve_moe(run_serving, get_config, pda,
                                             lm, fa, seg),
        "combined_moe": lambda: phase_combined_moe(run_serving, get_config,
                                                   pda, lm, fa, seg),
        "train_cli_moe": lambda: phase_train_cli_moe(make_engine, get_config,
                                                     lm, fa),
        "serve_encoder": lambda: phase_serve_encoder(make_engine, get_config,
                                                     pda, lm, fa, seg),
        "train_encoder": lambda: phase_train_encoder(make_engine, get_config,
                                                     lm, fa),
        "experiment": phase_experiment,
        "tick": lambda: phase_tick(make_engine, get_config),
    }
    # bring-up only: named on the command line, never in the full run
    bring_up = {"splits": phase_splits,
                "kernel_ssd_bwd": lambda: kernel_ssd_bwd(ssd),
                "tick_moe": lambda: phase_tick(
                    make_engine, get_config,
                    ticks=TICKS_MOE,
                    waves=False),
                "budget_seeded": lambda: phase_budget(
                    run_serving, make_engine, get_config, pda, lm, fa, seg,
                    seeded=True)}
    only = sys.argv[1:]
    out = {}      # each phase's results, as later phases read them
    if only:
        # bring-up: the named phases alone, and no result lines
        for name in only:
            set_depth(registry, whole, name not in WHOLE_DEPTH)
            out[name] = {**phases, **bring_up}[name]()
        return
    seconds = {}
    for name, fn in phases.items():
        set_depth(registry, whole, name not in WHOLE_DEPTH)
        t1 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t1
        # as it goes, so a run cut short still shows where the time went
        emit("phase_seconds", name=name, seconds=seconds[name],
             total=time.perf_counter() - t0)
    emit("seconds", phases=seconds, total=time.perf_counter() - t0)
    rows, lrows, frows = out["kernel"], out["kernel_lora"], \
        out["kernel_flash"]
    serve, combined = out["serve"], out["combined"]
    srows, adapters = out["kernel_seg"], out["serve_adapters"]
    s_main = srows[("decode", torch.bfloat16)]
    drows, ssm = out["kernel_ssd"], out["serve_ssm"]
    d_main = drows[("mamba_2048", torch.bfloat16)]
    b_main = drows[("bwd_mamba_4x2048", torch.bfloat16)]
    cssm, hyb = out["combined_ssm"], out["serve_hybrid"]
    bwd_rows = {k: r for k, r in drows.items() if "bwd" in k[0]}
    crows, vlm = out["kernel_decode"], out["serve_vlm"]
    cvlm, senc = out["combined_vlm"], out["serve_encoder"]
    tenc = out["train_encoder"]["cli"]

    def encoder_launches(kernel):
        """A kernel's launches in each encoder run: the serve waves (per
        ENC_REPS timed waves), the CLI's (b) and the 2 x 2,048 step."""
        return {**{f"serve_{n}": r["launches"][kernel]
                   for n, r in senc["waves"].items()},
                "train_cli": tenc["launches"][kernel],
                "train_2x2048": tenc["flash_train"]["launches"][kernel]}
    c_main = crows[("cross", torch.bfloat16)]
    smoe, cmoe = out["serve_moe"], out["combined_moe"]

    def moe_launches_of(kernel):
        """A kernel's launches in each MoE serve and co-training run, and
        (lora_matmul) the MoE training CLI's."""
        got = {**{n: r["launches"][kernel] for n, r in smoe.items()},
               **{f"combined_{n}": r["launches"][kernel]
                  for n, r in cmoe.items()}}
        if kernel == "lora_matmul":
            got["train_cli"] = out["train_cli_moe"]["cli"]["launches"][kernel]
        return got

    mesh = out["mesh"]

    def mesh_launches(kernel):
        """A kernel's launches on each rank in each mesh run."""
        return {"/".join(k): [r[kernel] for r in row["launches_by_rank"]]
                for k, row in mesh.items()}
    lse_rows = out["kernel_lse"]
    lse_main = lse_rows[("mesh_seq_24", torch.bfloat16)]
    fab = {"l-a": out["fabric"]["fabric"], "l-b": out["fabric"]["failover"],
           "l-c": out["fabric_combined"], "l-d": out["fabric_chaos"],
           "l-e": out["fabric_adapters"]}

    tc = out["train_cli"]
    # the training CLI's in-process runs of the train_cli phase: (b) and
    # (c) qwen 4 x 256, (d) qwen 4 x 2,048, (f) llama3-8b 8 x 64
    train_launches = {
        "lora_matmul": {"b": tc["b"]["lora_matmul_launches"],
                        "c": tc["c"]["lora_matmul_launches"],
                        "d": tc["d"]["launches"][0],
                        "f": tc["f"]["lora_matmul_launches"]},
        "flash_attention": {"d": tc["d"]["launches"][1]},
        "flash_attention_backward": {"d": tc["d"]["launches"][2]}}

    def fabric_launches(kernel):
        """A kernel's launches in each fabric run (traffic (l))."""
        return {k: r["launches"][kernel] for k, r in fab.items()}

    main_row = rows[("serve", torch.bfloat16)]
    worst = max(r["max_abs_err"] for (n, dt), r in rows.items()
                if dt == torch.bfloat16)
    # flash_attention's main shapes: the qwen prefill wave (forward) and
    # the co-training train batch (backward); its launches: the
    # co-training server at 2,048-token prompts
    f_fwd = frows[("qwen_prefill", torch.bfloat16)]
    f_bwd = frows[("qwen_train", torch.bfloat16)]
    flash_shapes = {n: {k: r[k] for k in (
        "D", "causal", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "bwd_ms",
        "bwd_plain_ms", "bwd_library_ms", "bwd_bound_ms", "bwd_bound_by")}
        for (n, dt), r in frows.items() if dt == torch.bfloat16}
    seg_shapes = {n: {k: r[k] for k in (
        "M", "K", "N", "slots", "ms", "plain_ms", "lora_matmul_ms",
        "library_ms", "bound_ms", "bound_by", "rel_err", "host_us")}
        for (n, dt), r in srows.items() if dt == torch.bfloat16}
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:172",
        "launches": serve["paged"][0]["kernel_launches"],
        "fabric_launches": fabric_launches("paged_decode_attention"),
        # hymba-1.5b (G 5) through identity tables over its rings
        "hybrid_launches": {
            **{n: r["launches"]["paged_decode_attention"]
               for n, r in hyb.items() if n.startswith("hybrid_")},
            **{f"combined_{n}": cssm[n]["launches"]["paged_decode_attention"]
               for n in ("hymba_32", "hymba_1984")}},
        "moe_launches": moe_launches_of("paged_decode_attention"),
        "mesh_launches": mesh_launches("paged_decode_attention"),
        # the VLM co-training ticks' dense blocks
        "vlm_combined_launches": cvlm["launches"]["paged_decode_attention"],
        "max_abs_err": main_row["max_abs_err"],
        "worst_bf16_err_all_shapes": worst,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "host_us": main_row["host_us"],
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in rows.values()),
        "bf16_shapes": {n: {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                                "bound_ms", "host_us")}
                        for (n, dt), r in rows.items()
                        if dt == torch.bfloat16},
        # a 62-block chain swapped out and back onto fresh ids: the
        # kernel over the remapped table against the original's output
        "swap_round_trip": {k: out["serve_oversub"]["round_trip"][k] for k in (
            "blocks", "moved_bitwise", "remapped_output_bitwise",
            "max_abs_err", "repeat_bitwise", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "swap_out_gb_s", "swap_in_gb_s")},
    }, {
        "name": "lora_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:57",
        # the co-training server, paged 32+16: prefill, decode and train
        "launches": combined["paged"]["lora_matmul_launches"],
        "fabric_launches": fabric_launches("lora_matmul"),
        "train_cli_launches": train_launches["lora_matmul"],
        "moe_launches": moe_launches_of("lora_matmul"),
        "mesh_launches": mesh_launches("lora_matmul"),
        "encoder_launches": encoder_launches("lora_matmul"),
        "vlm_combined_launches": cvlm["launches"]["lora_matmul"],
        "shape": "decode M=8 K=N=1024 r=16 bf16",
        "max_abs_err": lrows[("decode", torch.bfloat16)]["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in lrows.items()
            if dt == torch.bfloat16),
        **{k: lrows[("decode", torch.bfloat16)][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "host_us")},
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in lrows.values()),
        "bf16_shapes": {n: {k: r[k] for k in ("M", "K", "N", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "base_only_ms", "host_us")}
                        for (n, dt), r in lrows.items()
                        if dt == torch.bfloat16},
        # the M > 16 path at its most launched shape: the combined 4 x
        # 2,048 run's train batch; its M > 16 launches (prefill waves and
        # train steps, forward and dX) as derived from the run's counts
        "m_gt_16": {
            "shape": "train_2048 M=8192 K=N=1024 r=16 bf16",
            "launches_derived": N_LORA * combined["paged_2048"][
                "prefill_waves"] + (N_LORA + N_LORA_BWD) * combined[
                    "paged_2048"]["train_steps"],
            **{k: lrows[("train_2048", torch.bfloat16)][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "base_only_ms", "host_us")}},
        # hymba-1.5b's ssm_in, N = 6,482 (padded storage): decode and the
        # 4 x 2,048 train batch; its launches in the hymba co-training run
        "hymba_ssm_in": {
            "hybrid_combined_32_launches": cssm["hymba_32"]["launches"][
                "lora_matmul"],
            **{n: {k: lrows[(n, torch.bfloat16)][k] for k in (
                "M", "K", "N", "max_abs_err", "rel_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "base_only_ms")}
               for n in ("hymba_ssm_in_decode", "train_hymba_ssm_in")}},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": combined["paged_2048"]["flash_attention_launches"],
        "train_cli_launches": train_launches["flash_attention"],
        # hymba-1.5b (G 5, window 2,048): the ring-wrap server's
        # 1,984-token prefills; its co-training server at 1,984 + 8
        "hybrid_launches": {
            "serve_wrap_1984": hyb["hybrid_wrap_1984"]["launches"][
                "flash_attention"],
            "combined_1984": cssm["hymba_1984"]["launches"][
                "flash_attention"]},
        "moe_launches": moe_launches_of("flash_attention"),
        "mesh_launches": mesh_launches("flash_attention"),
        # hubert-xlarge, non-causal at D 80 (the 128-wide body on
        # extent-80 tensor maps)
        "encoder_launches": encoder_launches("flash_attention"),
        "shape": "prefill wave B=8 H=Hkv=16 D=64 S=2048 causal bf16",
        "max_abs_err": f_fwd["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in frows.items()
            if dt == torch.bfloat16),
        **{k: f_fwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "bf16_shapes": flash_shapes,
    }, {
        "name": "flash_attention_backward",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        # no TPU kernel: JAX differentiates the blockwise scan
        "replaces": "src/repro/models/layers.py:105",
        "launches": combined["paged_2048"][
            "flash_attention_backward_launches"],
        "train_cli_launches": train_launches["flash_attention_backward"],
        "hybrid_launches": {"combined_1984": cssm["hymba_1984"]["launches"][
            "flash_attention_backward"]},
        "encoder_launches": {"train_2x2048": tenc["flash_train"][
            "launches"]["flash_attention_backward"]},
        "shape": "train batch B=4 H=Hkv=16 D=64 S=2048 causal bf16",
        "max_abs_err": f_bwd["bwd_max_abs_err"],
        "max_rel_err": max(f_bwd[f"{g}_rel_err"] for g in ("dq", "dk", "dv")),
        "ms": f_bwd["bwd_ms"],
        "plain_ms": f_bwd["bwd_plain_ms"],
        "bound_ms": f_bwd["bwd_bound_ms"],
        "bound_by": f_bwd["bwd_bound_by"],
        "library_ms": f_bwd["bwd_library_ms"],
    }, {
        "name": "segmented_lora_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/segmented_lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:132",
        # the 4-tenant server, paged 32+16: prefill and decode
        "launches": adapters["paged"]["segmented_lora_matmul_launches"],
        "fabric_launches": fabric_launches("segmented_lora_matmul"),
        "moe_launches": moe_launches_of("segmented_lora_matmul"),
        "shape": "decode M=8 K=N=1024 r=16, 4 slots, bf16",
        "max_abs_err": s_main["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in srows.items()
            if dt == torch.bfloat16),
        "rows_bitwise_lora_matmul_all_shapes": all(
            r["rows_bitwise_lora_matmul"] for (n, dt), r in srows.items()
            if dt == torch.bfloat16),
        **{k: s_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "lora_matmul_ms", "host_us")},
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in srows.values()),
        "library": "base-only torch.matmul (x @ W, no adapter term): a "
                   "floor, no PyTorch call computes the segmented product",
        "bf16_shapes": seg_shapes,
        # the M > 16 path at the 4-tenant prefill wave of 8 x 2,048 rows;
        # its launches: one per adapter projection per prefill wave of
        # the 4-tenant server at 2,048-token prompts
        "m_gt_16": {
            "shape": "prefill_2048 M=16384 K=N=1024 r=16, 4 slots, bf16",
            "launches_derived": N_LORA * adapters["paged_2048"][
                "prefill_waves"],
            **{k: srows[("prefill_2048", torch.bfloat16)][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "lora_matmul_ms", "host_us")}},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:78",
        # the mamba2 server at 2,048-token prompts: one per layer per
        # request's prefill
        "launches": ssm["ssm_2048"]["launches"]["ssd_scan"],
        "shape": "prefill B=1 S=2048 H=48 P=64 N=128, x bf16",
        "max_abs_err": d_main["max_abs_err"],
        "y_rel_err": d_main["y_rel_err"],
        "state_rel_err": d_main["state_rel_err"],
        "worst_y_rel_err_all_shapes": max(
            r["y_rel_err"] for (n, dt), r in drows.items()
            if dt == torch.bfloat16 and "bwd" not in n),
        **{k: d_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        "bf16_shapes": {n: {k: r[k] for k in ("S", "H", "N", "ms",
                                                "plain_ms", "bound_ms")}
                        for (n, dt), r in drows.items()
                        if dt == torch.bfloat16 and "bwd" not in n},
    }, {
        "name": "ssd_scan_backward",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        # no TPU kernel: JAX differentiates the jnp ssd_chunked
        "replaces": "src/repro/models/mamba2.py:81",
        # the mamba2 co-training server at 2,048-token prompts: the
        # backward of every layer of every train step (4 x 2,048 rows)
        "launches": cssm["mamba2_2048"]["launches"]["ssd_scan_backward"],
        "combined_ssm_launches": {
            k: cssm[k]["launches"]["ssd_scan_backward"]
            for k in ("mamba2_32", "hymba_32", "mamba2_2048", "hymba_1984")},
        "shape": "train batch B=4 S=2048 H=48 P=64 N=128, x bf16",
        "max_abs_err": b_main["max_abs_err"],
        "worst_rel_err_all_shapes": max(
            e for r in bwd_rows.values() for k, e in r.items()
            if k.endswith("_rel_err")),
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in bwd_rows.values()),
        **{k: b_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "bound_3xtf32_ms", "library_ms", "host_us",
                                  "gflop", "launches_a_call",
                                  "workspace_and_outputs_peak_bytes")},
        "bf16_shapes": {n: {k: r[k] for k in ("B", "S", "H", "N", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_3xtf32_ms")}
                        for (n, dt), r in bwd_rows.items()
                        if dt == torch.bfloat16},
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:80",
        # the VLM server: one per unit per decode step
        "launches": vlm["launches"]["decode_attention"],
        "vlm_combined_launches": cvlm["launches"]["decode_attention"],
        "shape": "cross-attention decode B=8 H=64 Hkv=8 D=128 T=1601, "
                 "K/V a transposed view, bf16",
        "max_abs_err": c_main["max_abs_err"],
        "worst_bf16_err_all_shapes": max(
            r["max_abs_err"] for (n, dt), r in crows.items()
            if dt == torch.bfloat16),
        "worst_f32_err_all_shapes": max(
            r["max_abs_err"] for (n, dt), r in crows.items()
            if dt == torch.float32),
        **{k: c_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "library", "host_us")},
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in crows.values()),
        "bf16_shapes": {n: {k: r[k] for k in ("S", "lengths", "ms",
                                                "plain_ms", "library_ms",
                                                "bound_ms", "host_us")}
                        for (n, dt), r in crows.items()
                        if dt == torch.bfloat16},
    }, {
        "name": "paged_decode_attention_lse",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        # the paged kernel's launch that writes the float32 output and the
        # log-sum-exp: the sequence-sharded decode's partials
        "replaces": "src/repro/kernels/decode_attention.py:172",
        # rank 0 of the mesh's forced kv_seq table, llama3-8b 8 x (32 + 16)
        "launches": mesh[("llama3-8b_8L", "forced", "s32")][
            "launches_by_rank"][0]["paged_decode_attention_lse"],
        "mesh_launches": mesh_launches("paged_decode_attention_lse"),
        "shape": "B=4 H=32 Hkv=8 D=128, 24 of 48 cache rows a rank, bf16",
        "max_abs_err": lse_main["max_abs_err"],
        "lse_max_abs_err": lse_main["lse_max_abs_err"],
        **{k: lse_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "host_us")},
        "library": "SDPA over the gathered cache: the output alone, no lse",
        "empty_rows_zero_and_minus_inf": all(
            r["ok"] for (n, dt), r in lse_rows.items() if "empty" in n),
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in lse_rows.values()),
        "shapes": {f"{n}_{str(dt).split('.')[-1]}": {k: r[k] for k in (
            "empty_rows", "max_abs_err", "lse_max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "host_us")}
            for (n, dt), r in lse_rows.items()},
    }]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
