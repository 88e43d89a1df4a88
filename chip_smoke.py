#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, checked
    python3 chip_smoke.py --phase engines    # one timing phase alone
    python3 chip_smoke.py --phase many
    python3 chip_smoke.py --phase agg --save OUT.pt     # or --compare OUT.pt
    python3 chip_smoke.py --phase flash
    python3 chip_smoke.py --phase rglru
    python3 chip_smoke.py --phase prng --save OUT.pt    # or --compare OUT.pt
    python3 chip_smoke.py --phase train
    python3 chip_smoke.py --phase moe        # or mamba, or cuts
    python3 chip_smoke.py --phase whisper    # or vlm, or frontend_cuts
    python3 chip_smoke.py --phase baselines  # or wire
    python3 chip_smoke.py --phase sharded
    python3 chip_smoke.py --phase fsdp
    python3 chip_smoke.py --phase split_depth
    python3 chip_smoke.py --phase nccl       # four cards, one a rank

Phases, each printing its own lines:

  build   nvcc-builds every CUDA kernel source of the port (sm_90a), all
          sources at once; prints the bfloat16 flash kernel's registers,
          shared memory and spills at each head dim, and fails unless its
          SASS (cuobjdump -sass) holds HGMMA (wgmma) and UTMALDG (TMA);
          prints the same for the RG-LRU TMA kernel (float32 and bfloat16
          a and b) and fails unless its SASS holds UTMALDG.
  kernel  holds blind_agg_fwd / blind_agg_bwd against their plain PyTorch
          version on the card, values and autograd gradients, over party
          counts K up to 127, odd and even (N, d), a 4-D input, float32 and
          bfloat16, and a mask dtype that differs from the embeddings';
          K in {2, 8, 9, 31, 32, 33, 64, 255} at (128, 64) float32 (every
          party-group count G the forward's rule gives), and the serving
          rounds' and the LM training step's shapes: K = 3, N in {4, 512,
          1024, 2048, 8192}, d 128, bfloat16 embeddings with float32
          masks (at N = 8192 the forward within one bfloat16 ulp plus the
          float32 rounding the order of the sum over parties moves).
  prng    holds blind_agg_prng_fwd (masks made in the kernel) against its
          plain version on the card (MaskEngine masks through
          reference_blind_agg) over K in {2, 3, 7, 15, 63, 127}, N in
          {100, 128}, d in {64, 100, 128}, a 4-D input, float32 and
          bfloat16, E_k narrower than E_a (bfloat16 or float16 beside a
          float32 E_a), mask_scale 1 and 4, rounds 0, 7 and SERVE_DOMAIN
          + 3; also against the unmasked mean (the masks cancel) and,
          through its autograd.Function, the backward. Its mask engines
          take their pair seeds from blinding's PRF over the pair's
          indices (_kernel_mask_engine), not from a DH ceremony.
  slice   the paper's Table II setting (C = 4 heterogeneous MLP parties,
          d_embed 128, batch 128, adam 1e-3, mnist_like data, fresh masks,
          the classifier's defaults: vectorized engine, MaskEngine masks,
          aggregation through blind_agg_fwd): 30 training rounds on the
          card, then per-party test accuracy. Step 0 is compared with the
          same step on the CPU.
  joint   one Table II round of grad_mode="joint", whose backward runs
          through blind_agg_bwd; gradients compared with the CPU.
  many    the many-party benchmark's configuration (mlp_zoo, C = 64,
          batch 128, d_embed 64, 1,024 features, adam 1e-3) on the
          vectorized engine with fused_masks=True: 20 rounds through
          blind_agg_prng_fwd (step 0 against the CPU port), one joint
          round (blind_agg_bwd), then 20 rounds with fused_masks=False
          (MaskEngine masks on the card, blind_agg_fwd) beside them, and a
          torch.profiler window over fused rounds.
  wires   the vectorized engine against the loop engine on the card at
          Table II (step-0 losses and gradients), and the int32 and int8
          ring wires at C = 64 against the CPU port (step-0 losses).
  baselines  the paper's Table II methods at its setting: Local, SplitVFL,
          C_VFL (top-k 0.25), AggVFL, and EASTER with a top-k 0.25 uplink
          (float masks through blind_agg_fwd, and fused masks through
          blind_agg_prng_fwd), 30 rounds each on the card, step 0 against
          the CPU port, ms per step, per-party test accuracy, bytes per
          round; then one compressed grad_mode="joint" round
          (blind_agg_bwd), gradients against the CPU port. Launches
          asserted round by round (none for the four baselines).
  wire    WireEaster at Table II (C = 4, the slice's weights): three
          passive processes on the card, 20 rounds on the float wire and
          20 on the int8 wire, then evaluate; round 0 against the same run
          on the CPU; the float transcript audited (blinded, not raw; the
          masks cancel; the uplink kinds) and its bytes against
          EasterClassifier.bytes_per_round; start() seconds, ms per round
          beside the in-process loop engine's.
  engines the Table II masks and train step on the vectorized and the
          loop engine, timed in turns (vectorized, loop, loop, vectorized).
  timing  each kernel, its plain version and its bound, timed with CUDA
          events at the slice's shape and at the many-party shapes; the
          prng kernel's bound counts the operations its inputs need.
          blind_agg_fwd and blind_agg_bwd also at the serving rounds'
          shapes (K = 3, N 2048 and 4, d 128, bfloat16 embeddings, float32
          masks; the backward at N = 2048 only) and the LM training step's
          (K = 3, N = 4 x 2048, forward and backward), each beside the launch
          floor (one torch.cuda._sleep(0) in a back-to-back stream, timed
          the same way) and the forward at every party-group count G;
          where a call moves 1 MiB or more, also cold: calls in turn over
          input sets and outputs of twice the 50 MB L2.
  profile host-clock split of a Table II round into masks and train step,
          and torch.profiler device time by kernel over 5 rounds.
  flash   holds flash_attention_fwd against its plain version on the card:
          the reference sweep (S 64-256 x six (Hq, Hkv, hd), 16/1/256
          among them, x causal, non-causal and causal window 32 x
          float32/bfloat16), ragged S of 1, 7, 63, 65, 100, 127, 129 and
          1023 (T = S), S = 50 against T = 130, S > T + window - 1
          (130 / 50 / 4-2-64 window 32, 400 / 129 / 16-1-256 window 100,
          causal and not, float32 and bfloat16: rows that see no key are
          the plain version's mean of v), the serving paths' prefill
          shapes (1 or 3, 511 | 1023 | 2047) at every serving model's
          heads, 16/2/128 causal (qwen2.5-3b), 16/1/256 causal window 2048
          (recurrentgemma-9b), 8/4/256 causal window 1024 (gemma3-4b) and
          16/16/128 causal (qwen2-moe-a2.7b), in float32 and bfloat16 (bfloat16
          also within the kernel's bound |out - exact| <= ulp_bf16(exact)
          + 2^-8 A(q, k, |v|) + 1e-5 of float32 attention on the same
          inputs, the share of it used printed), the frontend families'
          shapes under the same checks (whisper-small's 12/12/64
          non-causal at (1 | 4 | 12, 1500) and its cross-attention at (4 |
          12, 3 | 1) against T = 1500; qwen2-vl-7b's 28/4/128 causal, a
          GQA group of 7, at (1 | 4 | 12, 2047 | 1279)), and one vmap over
          3 parties (one launch).
  lm      EasterLM on qwen2.5-3b at full width and depth (36 layers, three
          9-layer passive proxies, 6.2e9 parameters, bfloat16, random from
          a torch.Generator seeded 0 on the card): a 4-lane ServingEngine
          serves 8 greedy requests (prompts of 512/1024/2048 tokens from
          numpy seed 0, 32 new tokens each) on the float wire; prefill ms
          per request, ms per decode round, tokens/s, the launch counts
          asserted (36 + 9 flash_attention_fwd a prefill, one
          blind_agg_fwd a round), finite logits of the expected shape, and
          torch.profiler windows over one 2048-token admission and one
          decode round. Then the same width with depth cut to 4 active
          layers (passive 2) in float32 with TF32 off, against the CPU
          port: prefill embeddings and the logits of 4 decode rounds
          within rtol 1e-4 / atol 1e-5, identical greedy tokens.
  sharded the sharded engine (engine="sharded", launch/mesh.py): 4 ranks
          spawned at once share the card over gloo (every rank's backend,
          card and parameters and caches checked against the rule).
          Many-party C = 64 (the
          many phase's zoo and batch, unfused MaskEngine masks): 10 float
          and 10 int8 adam rounds and one joint round; every rank's
          per-party losses bit for bit rank 0's and, every round, bit for
          bit the single-process vectorized engine's forward on the same
          weights (gathered to rank 0 before the round); the vectorized
          engine's own run from the same start equal in round 0 and
          within rtol 1e-5 later (the backward over 4 rows a group rounds
          ~1e-8 from 16 rows', carried through adam); round 0's
          gradients gathered to rank 0 within atol 5e-6 / rtol 1e-6; on
          rank 0 (the active party's) one blind_agg_fwd a float round and
          one blind_agg_bwd in the joint round, none on the other ranks.
          qwen2.5-3b at full width and depth in bfloat16 with its three
          9-layer passive proxies over 3 ranks (each rank draws every
          party from the card's generator seeded 0 and keeps its own): 4
          lanes of 2047-token prefill, then 16 greedy rounds; the
          prefill's E, every round's logits and the greedy tokens bit for
          bit the loop engine's (one passive party at a time: the GEMM
          batch of a rank holding one party), the prefill's E bit for bit
          the vectorized engine's, whose decode rounds (teacher-forced)
          are printed beside it as information (its decode attention runs
          the float32 probs x V GEMM over all parties at once, which
          cuBLAS rounds otherwise), the tokens the same on every rank,
          flash_attention_fwd launches a prefill 36 + 9 on rank 0 and 9 on
          ranks 1-2, blind_agg_fwd on rank 0 only; then the 4-layer
          float32 cut over 3 ranks against the lm cut's CPU port outputs
          (rtol 1e-4 / atol 1e-5, identical tokens). Before the ranks
          start, the dry run's weight bytes for qwen2.5-3b
          (launch/dryrun.py on the meta device) must equal the bytes of
          the tree the lm draw allocates. Prints each rank's start, ms
          per round beside the vectorized engine's, per-rank peak memory.
  rglru   holds rglru_scan_fwd against its plain version on the card
          (rtol = atol = 1e-6; bit-identical expected): the reference sweep
          (2,64,128), (1,128,256), (4,32,64), (3,96,128), ragged L and W
          (7 and 1000 x 100 and 4000), the serving shapes (1 or 3, 511 |
          1023 | 2047, 4096), widths of rows not a multiple of 16 bytes
          and L = 0, each with float32 and bfloat16 a and b from a
          non-zero h0, the 512-step decay case (a = 0.99, b = 0.01), and
          one vmap over 3 parties (one launch); each case must take the
          kernel path its shape selects (the TMA ring at every serving
          shape, one thread per column where TMA cannot read the rows).
  rg      EasterLM on recurrentgemma-9b at full width and depth (38 layers:
          12 x (lru, lru, attn) + (lru, lru); d_model and lru_width 4096;
          MQA 16/1 x 256 with a local window of 2048; three 9-layer
          passive proxies; 15.3e9 parameters, bfloat16, random from a
          torch.Generator seeded 0 on the card), served as in lm after the
          qwen2.5-3b model is freed; launch counts asserted (26 + 6
          rglru_scan_fwd and 12 + 3 flash_attention_fwd a prefill, one
          blind_agg_fwd a round), every rglru_scan_fwd on the TMA path;
          profiler windows as in lm. For lm and rg a window that records
          shapes over a 16-token prefill and one decode round fails the
          run if any copy op in it reads a tensor the size of the stacked
          passive embedding tables (the group's token embeddings are one
          offset gather).
  rg_cut  recurrentgemma-9b cut to one pattern repeat (3 active layers,
          3 per passive proxy; 6.35e9 parameters, 25.4 GB in float32),
          TF32 off, against the CPU port on the same weights as in lm's
          depth cut; the host copy is made leaf by leaf, and the passive
          parties are cut to 1 if the host's available memory is under
          twice the weights.
  timing  (flash) the kernel, its plain version and SDPA (the library
          yardstick, never on the path; the backend that ran is the one
          whose output alone is bit-identical to it) at (1 | 3, 1023 | 2047,
          16/2, 128) bfloat16 causal and at (1 | 3, 2047) at 16/1/256
          window 2048, 8/4/256 window 1024 (SDPA given the window's band
          as a boolean mask) and 16/16/128, whisper-small's (4 | 12, 1500
          | 3 | 1, 12/12, 64) non-causal over T = 1500 and qwen2-vl-7b's
          (4 | 12, 2047) and (1 | 3, 1279) at 28/4/128 causal, with the
          bound: the larger of the attended pairs' flops at the bf16
          tensor-core peak and the bytes of q, k, v and out at the HBM
          rate (the cross-attention shapes are bound by bytes), the
          achieved TFLOP/s and the bound's share of the kernel's time; (rglru) the kernel and its
          plain version at (1 | 3, 2047, 4096) float32 beside the bytes
          bound, its output checked bit for bit against the plain one.
  train   EasterLM training on qwen2-1.5b at full width and depth (28
          layers, d_model 1536, 12/2 heads of 128, d_ff 8960, vocab
          151,936, bfloat16, remat per layer; three 7-layer passive
          proxies; 3.31e9 parameters random from a torch.Generator seeded
          0 on the card) through build_trainer(TrainConfig(chunk=2)) (adam
          1e-3, clip 1.0): two chunks of 2 steps on 4 x 2048-token batches
          of lm_batch_iterator(seed=0); ms per step (host clock, each step
          started after a synchronize; median of the second chunk),
          tokens/s, peak device memory, per-party losses (finite, the mean
          total of the last two steps below step 0's), exactly one
          blind_agg_fwd a step and no flash_attention_fwd or
          rglru_scan_fwd launch; one more step under torch.profiler (idle
          share, top device ops); one grad_mode="joint" sgd step, which
          must launch blind_agg_bwd once. Then one sgd step card vs CPU
          port in float32 (TF32 off), losses, gradients and updated params
          within rtol 1e-4 / atol 1e-5, for qwen2-1.5b cut to 4 active
          layers (passive 2) at batch 2 x 128, for the
          recurrentgemma-9b smoke variant, and for the whisper-small and
          qwen2-vl-7b smoke variants with audio_embed / vision_embed in
          the batch, each launching one blind_agg_fwd and no prompt
          kernel. Last, reported and not
          asserted: whether a chunk of 2 adam steps equals the step loop
          bit for bit on the card, and one step's gradients computed
          twice, with the parameter leaves that differ.
  fsdp    the FSDP plan (repro_torch.sharding, launch/steps.shard_step):
          4 ranks spawned at once share the card over gloo as a 2 x 2
          (data x model) MeshGroup. (a) qwen2-1.5b as train runs it (full
          width, bfloat16, remat per layer, adam 1e-3 clip 1.0, 4 x 2048
          tokens a step from lm_batch_iterator(seed=0), one row a rank)
          but cut to 6 layers (three 2-layer proxies; gloo moves each
          rank's gathers at under a GB/s, and the phase must stay within
          180 s) under layout zero3 with ZeRO-1, 2 steps, beside the same
          2 steps in one process on the card first: losses (every rank's the same, finite; step 0
          within rtol 1e-2 of the one process's), ms a step by rank, the
          resident bytes of weights + gradients + adam state by rank and
          torch.cuda.max_memory_allocated by rank; one blind_agg_fwd a
          step on every rank. (b) qwen2-1.5b cut to 2 layers, float32,
          TF32 off, grad_mode joint, one adam 1e-3 step at 4 x 128 under
          layout tp (the reference's default), gathered to rank 0,
          against the CPU port's one-process step from the same weights:
          the loss at rtol 1e-4 / atol 1e-5, the parameters there where
          the clipped |g| >= 1e-4 and within 2 lr + 1e-5 elsewhere (adam's
          first step is about lr sign(g)); one blind_agg_fwd and one
          blind_agg_bwd on every rank. (c) qwen2.5-3b cut to 2 layers,
          float32, under prefill_shardings / serve_shardings: a 4-lane
          63-token prefill and 4 greedy rounds against the CPU port
          (embeddings and logits at rtol 1e-4 / atol 1e-5, tokens
          identical on every rank); per rank 2 + 2 flash_attention_fwd
          launches and 1 + 4 blind_agg_fwd. (b) and (c) run the
          tensor-parallel compute over "model" (heads, MLP columns and
          rows, the vocabulary). (d) qwen2.5-3b at full width and depth
          (36 layers, 16/2 heads of 128, three 9-layer proxies, 6.181e9
          parameters, bfloat16, the card's generator seeded 0, the ranks
          drawing every leaf in turns, each keeping its blocks) under
          prefill_shardings / serve_shardings:
          4 lanes (2 a data rank) of 512-token prompts, then 4 greedy
          rounds; per rank the resident parameter bytes, peak memory,
          prefill ms and ms a round, and the collectives' bytes of the
          prefill and of the last round by kind (a RecordingMesh over the
          live mesh); asserted: finite logits, the model ranks of a data
          rank holding the same logits bit for bit, the same tokens on
          every rank, per rank 36 + 9 flash_attention_fwd and one
          blind_agg_fwd a prefill, one blind_agg_fwd a round, and no
          all-gather of a leaf the model axis splits, nor of a K/V cache
          or cross K/V, in a round; the
          tokens beside the one process's on the same weights (run by
          the parent before the ranks work) printed, not asserted.
          (e)-(g) the split MoE, SSD and RG-LRU stacks, served as (d)
          (4 lanes of 512-token prompts, greedy rounds; each layer
          stack's rows cut as they are drawn): (e) qwen2-moe-a2.7b at
          full width and depth (24 layers, 16/16 heads of 128, 60
          experts top-4, 15 a rank, 4 shared; three 6-layer MoE
          proxies; 25.29e9 parameters) on a 1 x 4 (data x model) mesh
          of the same ranks, 4 rounds; (f) mamba2-2.7b at full width
          (80 heads of 64, 40 a rank) cut to 16 layers (three 4-layer
          proxies; FSDP_SSD_LAYERS; 64 under --phase split_depth) on
          the 2 x 2 mesh, 4 rounds; (g) recurrentgemma-9b at full width
          (the LRU's 4096 width, 1024 a rank; 4 q heads over the one kv
          head of 256, its cache split by T) on 1 x 4, cut to 6 layers,
          two whole (lru, lru, attn) repeats (FSDP_RG_LAYERS), 4
          rounds; then
          float32 cuts of (e) (6 layers) and (f) (16 layers) at full
          width on the same meshes, one teacher-forced round. Each
          prints and asserts as (d), with the prefill's
          flash_attention_fwd and (g)'s rglru_scan_fwd launches
          predicted from the stacks (every rglru_scan_fwd on the TMA
          path at the rank's width), the collectives' bytes and count
          by kind of the prefill and of the last round, and round 0's
          logits against the one process's (the parent runs each before
          the ranks work): the float32 cuts within FSDP_SPLIT_F32_REL,
          (f) and (g) within their limits in FSDP_SPLIT, (e) printed
          (bfloat16 rounding of the split sums grows with depth).
          (h) whisper-small at full width and depth (12 encoder and 12
          decoder layers, 12/12 heads of 64, 3 a rank; 51,865 rows, which
          do not divide 4, so the tables split by their width and each
          rank looks up its columns) on the 1 x 4 mesh: encoder_kv on
          4 lanes of 1500-frame audio under the plan (the encoder, its
          stream over the frames sequence-parallel, and the cross K/V on
          each rank's heads), a 64-token prefill, 4 greedy rounds; as (d),
          with its encoder_kv ms, launches (12 + 12 flash_attention_fwd),
          bytes and cross K/V bytes a rank apart, 12 + 12 + 3 + 3
          flash_attention_fwd a prefill and 12 + 3 a round (the
          cross-attention on each rank's heads), round 0 within 2^-4.
  gemma_cut  gemma3-4b at full width (d_model 2560, 8/4 heads of 256,
          gelu MLP of 10240, vocab 262,144) cut to one (5 local, 1 global)
          period: 6 active layers, 2 local per passive proxy, float32 with
          TF32 off, against the CPU port as rg_cut: a 1,100-token prompt,
          past the local layers' window of 1024, so their ring wraps
          inside the prefill.
  moe     EasterLM on qwen2-moe-a2.7b at full width and depth (24 layers
          of MHA 16/16 x 128 with a QKV bias, then 60 routed experts
          top-4 of 1408 and 4 shared; three 6-layer MoE proxies; 25.2e9
          parameters, bfloat16, random from a torch.Generator seeded 0 on
          the card), served as in lm: the same 8 requests on 4 lanes;
          asserted 24 + 6 flash_attention_fwd launches a prefill and one
          blind_agg_fwd a round; prefill ms by length, ms a round,
          tokens/s, profiler windows, and the peak device memory of the
          draw, of serving and of one 2048-token admission.
  moe_cut qwen2-moe-a2.7b at full width cut to 2 active layers (2 per
          passive proxy), float32, TF32 off, against the CPU port as
          rg_cut: identical greedy tokens, embeddings and logits within
          rtol 1e-4 / atol 1e-5 x max|value| (random experts at the
          reference's fan-in scale 1/sqrt(E) put outputs of ~100 into the
          residual stream; the float32 rounding grows with them).
  mamba   EasterLM on mamba2-2.7b at full width and depth (64 Mamba-2 SSD
          layers, d_model 2560, 80 heads of 64, d_state 128, chunk 256;
          three 16-layer proxies; 5.0e9 parameters, bfloat16), served as
          in lm; asserted no flash_attention_fwd or rglru_scan_fwd launch
          and one blind_agg_fwd a round; the same printed numbers, the
          2047-token admission's peak memory among them.
  mamba_cut  mamba2-2.7b cut to 4 active layers (2 per proxy), float32,
          against the CPU port, with a 300-token prompt (a 299-token
          prefill: one full chunk of 256 and one padded).
  whisper EasterLM on whisper-small at full width and depth (12 encoder
          and 12 decoder layers, d_model 768, MHA 12/12 x 64, gelu, layer
          norm, QKV bias; three proxies of 12 encoder and 3 decoder
          layers; 0.70e9 parameters, bfloat16): 4 transcriptions of 30 s
          of audio ((4, 1500, 768) frame embeddings from the card's
          generator, a 4-token start prompt): encoder_kv once, a prefill,
          serve_tokens for 64 greedy tokens; encoder_kv, prefill and
          per-round ms, tokens/s, peak memory, profiler windows; asserted
          24 flash_attention_fwd launches in encoder_kv, 30 a prefill (12
          + 3 self, 12 + 3 cross), 15 a decode round, one blind_agg_fwd a
          round; the copy window also fails on a copy the size of one
          layer's passive cross K (the group's K/V is read in place).
  whisper_cut, vlm_cut  whisper-small cut to 2 encoder and 2 decoder
          layers over the full 1500 frames, and qwen2-vl-7b cut to 2
          layers with a 1,100-token prompt carrying its 1024 patches,
          float32 against the CPU port as rg_cut.
  vlm     EasterLM on qwen2-vl-7b at full width and depth (28 layers,
          d_model 3584, GQA 28/4 x 128, d_ff 18944, QKV bias, vocab
          152,064; three 7-layer proxies; 13.6e9 parameters, bfloat16): 4
          lanes of 2048-token prompts whose first 1024 positions are an
          image's patch embeddings, then one 1280-token request, 32 greedy
          tokens each; asserted 28 + 7 flash_attention_fwd launches a
          prefill, none a round, one blind_agg_fwd a round, and that other
          patches move the prefill's first 1024 embeddings (the insert).

--phase runs one phase alone after the build, for comparing two
checkouts in turns (the other checkout's tree given this script), and
prints its numbers as a JSON line before the card's line and the
{"ok": true, ...} line:
engines, many, baselines, wire, rg (the recurrentgemma-9b serving run),
moe and mamba (the qwen2-moe-a2.7b and mamba2-2.7b serving runs),
whisper and vlm (the
whisper-small and qwen2-vl-7b serving runs), frontend_cuts (whisper_cut
and vlm_cut), cuts (gemma_cut, moe_cut, mamba_cut, whisper_cut and
vlm_cut), train (the train phase), sharded (the lm depth cut, for its
CPU outputs, then the sharded phase), fsdp (the fsdp phase),
split_depth (the fsdp phase's split MoE and SSD paths at depth cuts in
float32 and bfloat16, round 0's logits against one process's, beside
the one process in bfloat16 against itself in float32: bfloat16's own
error at that depth; FSDP_SPLIT), tsplit ((i): qwen2-1.5b at full width
and depth on a 1 x 3 mesh of three ranks sharing the card, whose 12/2
heads do not divide 3: each attention runs whole over its cache's T
block, 172 of 516 slots a rank, the ranks' partial softmax merged; 4
lanes of 512-token prompts, 4 greedy rounds, held and printed as (d)),
nccl (four
cards, one a rank: launch/mesh.py's rule then starts the ranks over NCCL,
"cpu:gloo,cuda:nccl", each bound to cuda:<rank>; raises with fewer cards;
prints nvidia-smi topo -m and every card's name and power limit; every
rank's backend, card and tensors checked: the sharded phase over NCCL,
its 4-layer cut held to one process on one card instead of the CPU port;
then, beside one process on one card run first, (a) qwen2-1.5b at all 28
layers on 2 x 2, (d), (e) and (e)'s float32 cut, held as the fsdp phase
holds them ((e)'s bfloat16 round-0 gap printed beside gloo's); (k)
qwen2-vl-7b cut to 2 layers in float32 at full width, one sgd step at 4 x
1280 tokens with the patches on 4 x 1, every rank's blocks and their
update against the one process's; (j) qwen2-vl-7b at full width and
depth trained under zero3 + ZeRO-1 on 4 x 1, adam, 4 x 2048 tokens with
1024 patch positions a row, 3 steps: losses finite, the same on every
rank and falling, one blind_agg_fwd a step a rank, at most 45 GB of
weights, gradients and adam state a rank; ms a step, tokens/s, peak
memory and each step's collective bytes and count (a RecordingMesh over
the live mesh); the all-gather rate of 16 MB a rank over NCCL and over
the group's gloo half), agg (the
blind_agg_fwd / blind_agg_bwd timing and the launch floor; --save and
--compare as for prng, the backward's outputs required to be bit for bit
the other checkout's), flash, rglru (the rglru timing) or prng (the prng
cases, their outputs saved with --save or compared bit for bit with
another checkout's file with --compare, then the prng timing).

The launch counters are set to 0 just before each counted path (slice,
joint, many-party fused, many-party joint, many-party unfused, Table II
top-k (float masks, fused masks, joint), qwen2.5-3b
serving, recurrentgemma-9b serving, qwen2-1.5b training, its joint step,
qwen2-moe-a2.7b serving, mamba2-2.7b serving, whisper-small serving,
qwen2-vl-7b serving; in the sharded phase's ranks every round; in the
fsdp phase's ranks (a) to (h)) and read
just after; every kernel
must have launched on some path, and blind_agg_fwd's launches are printed
by party-group count G, path by path. The second-to-last line is the JSON
kernel record; the last line is {"ok": true, "device": {...}}. Any failed
check raises: the script then exits non-zero and prints no result. It
needs a CUDA device and the repository's src/ beside it.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# when this module was loaded: a spawned rank, which loads it as
# __mp_main__, reports how long it took to start
LOADED_AT = time.time()
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet peak
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2 (Hopper white paper)
FP32_FLOPS = 67e12               # H100 SXM data sheet, float32 off the tensor cores
# the clock and lanes behind that figure (Hopper white paper): 132 SMs,
# each with 128 FP32 and 64 INT32 lanes, at 1.98 GHz: 67 TFLOP/s = 132 x
# 128 x 2 (an FMA) x 1.98e9; INT32 operations run at half that lane rate
SMS, CLOCK_HZ = 132, 1.98e9
FP32_PER_SM, INT32_PER_SM = 128, 64
# What blind_agg_prng_fwd must compute per output element and unordered
# pair of passive parties (the plain version, MaskEngine, draws each pair's
# normal once and adds it to one party's mask and subtracts it from the
# other's). INT32: one threefry2x32 under the pair's key = 2 key adds + 20
# rounds x (add, rotate, xor) + 5 key injections x 2 adds (the injected
# key word plus the round constant is one word per key) = 72, then x0 ^ x1
# and the mantissa trick's shift and or = 75. FP32: the uniform (subtract,
# multiply, add, max: 4), erfinv (x*x, log1p counted as one operation,
# w - 2.5, 8 multiplies and 8 adds of the degree-8 polynomial, x p: 20),
# times sqrt(2), and the pair's two signed adds into the two masks = 27.
# Per-key work (the key schedule, the key derivation) is per pair, not per
# element, and is left out.
PRNG_INT32_PER_PAIR, PRNG_FP32_PER_PAIR = 75, 27
SLICE_ROUNDS = 30
SLICE_BATCH = 128
D_EMBED = 128
# the many-party benchmark (benchmarks/many_party_scaling.py defaults)
MP_C, MP_BATCH, MP_D_EMBED, MP_FEATURES, MP_CLASSES = 64, 128, 64, 1024, 10
MP_ROUNDS = 20
# the LM serving slice: qwen2.5-3b at full width and depth in bfloat16,
# EasterConfig() defaults (C = 4, three 9-layer passive proxies, d_embed
# 128, float wire, fresh masks), a 4-lane ServingEngine serving 8 greedy
# requests of 32 new tokens; the depth-cut float32 run against the CPU
LM_ARCH = "qwen2.5-3b"
LM_LANES, LM_REQUESTS, LM_NEW, LM_CHUNK = 4, 8, 32, 8
LM_PROMPTS = (512, 1024, 2048)
LM_CUT_LAYERS, LM_CUT_BATCH, LM_CUT_PROMPT, LM_CUT_ROUNDS = 4, 2, 64, 4
# decode rounds (and training steps) under torch.profiler: the profiler's
# parse of its trace on the host took 2.5-4 s a decode round of a full
# model (36-42k kernels for 8 rounds) and 11 s a training step, 199 s of
# the script's 764 (H100 80GB HBM3 at 700 W), and swings with the host;
# a round (a step) launches the same kernels as the last, so the busy and
# idle shares of one round (one step) read as those of eight (two)
PROFILE_ROUNDS, PROFILE_STEPS = 1, 1
BF16_FLOPS = 989e12              # H100 SXM data sheet, dense bf16 tensor cores
# flash_attention_fwd against its plain version: the reference sweep
# (tests/test_kernels.py) plus ragged lengths and the qwen2.5-3b shape
FLASH_S = (64, 128, 256)
FLASH_RAGGED_S = (1, 7, 63, 65, 100, 127, 129, 1023)
FLASH_HEADS = ((4, 4, 64), (4, 2, 64), (8, 1, 64), (4, 2, 128), (2, 2, 32),
               (16, 1, 256))
FLASH_MASKS = ((True, 0), (False, 0), (True, 32))
# S > T + window - 1: the rows from T + window - 1 on see no key, and are
# the mean of v (B, S, T, Hq, Hkv, hd, window), causal and not
FLASH_EMPTY_ROWS = ((1, 130, 50, 4, 2, 64, 32), (1, 400, 129, 16, 1, 256, 100))
# the serving path's prefill shapes (prompt[:-1] of 512/1024/2048 tokens):
# (B, S) for the active party (B = 1) and the folded passive group (B = 3)
FLASH_PREFILL = ((1, 511), (1, 1023), (1, 2047), (3, 511), (3, 1023),
                 (3, 2047))
FLASH_PREFILL_HEADS = (16, 2, 128)
# one model rank's heads of qwen2.5-3b under the tensor-parallel compute
# at m = 2 (the fsdp phase's (d)): 8 q heads over 1 kv head of 128, at the
# 512-token prefill of the active party's 2 lanes and of the passive
# group's 6 (3 parties x 2 lanes, folded into the batch axis)
FLASH_TP_HEADS, FLASH_TP = (8, 1, 128), ((2, 512), (6, 512))
# a model rank's heads at m = 4 (the fsdp phase's (e) and (g)): qwen2-moe's
# 4/4 of 128 and recurrentgemma's 4 q heads over its one kv head of 256,
# windowed at 2048, at the 512-token prefill of the active party's 4 lanes
# and of the passive group's 12 (3 parties x 4 lanes, folded into the
# batch axis: on a 1 x 4 mesh a rank holds every lane)
FLASH_TP_SPLIT = (((4, 4, 128), 0), ((4, 1, 256), 2048))
FLASH_TP_SPLIT_BS = ((4, 512), (12, 512))
# a rank's causal prompt attention under the fsdp phase's (h) and (i):
# whisper-small's decoder at 3/3 of 64 over its 64-token prompt (1 x 4)
# and qwen2-1.5b's whole 12/2 of 128 over 512 tokens (1 x 3: its heads do
# not divide the three ranks), as (heads, S), at B = 4 and 12 (the active
# party's lanes and the passive group's)
FLASH_TP_CAUSAL = (((3, 3, 64), 64), ((12, 2, 128), 512))
FLASH_TP_CAUSAL_B = (4, 12)
# the recurrentgemma-9b serving slice: the same serving run on Griffin
# parties (38 layers: 12 x (lru, lru, attn) + (lru, lru); three 9-layer
# passive proxies), 16/1/256 heads with a local window of 2048; the depth
# cut keeps one pattern repeat (3 active layers, 3 per passive proxy)
RG_ARCH = "recurrentgemma-9b"
# the LM training slice: qwen2-1.5b at full width and depth in bfloat16,
# EasterConfig() defaults, build_trainer(TrainConfig(chunk=2)) (adam 1e-3,
# clip 1.0), two counted chunks of 2 steps on 4 x 2048-token batches from
# lm_batch_iterator(seed=0); the float32 depth cut against the CPU port
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK, TRAIN_CHUNKS = 4, 2048, 2, 2
TRAIN_CUT_LAYERS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 4, 2, 128
RG_CUT_LAYERS = 3
RG_FLASH_HEADS, RG_WINDOW = (16, 1, 256), 2048
# the MoE and Mamba-2 serving slices, served as lm: qwen2-moe-a2.7b (24
# layers of attention, MHA 16/16 x 128 with a QKV bias, then 60 routed
# experts top-4 and 4 shared; three 6-layer MoE proxies) and mamba2-2.7b
# (64 SSD layers, attention-free; three 16-layer proxies); their float32
# depth cuts against the CPU port (mamba2's prompt of 300 tokens runs the
# SSD's padded chunk: 299 = 256 + 43); gemma3-4b at full width cut to one
# (5 local, 1 global) period, with a prompt past its window of 1024
MOE_ARCH, MAMBA_ARCH, GEMMA_ARCH = ("qwen2-moe-a2.7b", "mamba2-2.7b",
                                    "gemma3-4b")
MOE_CUT_LAYERS, MAMBA_CUT_LAYERS, GEMMA_CUT_LAYERS = 2, 4, 6
MAMBA_CUT_PROMPT = 300
GEMMA_CUT_BATCH, GEMMA_CUT_PROMPT = 1, 1100
GEMMA_FLASH_HEADS, GEMMA_WINDOW = (8, 4, 256), 1024
MOE_FLASH_HEADS = (16, 16, 128)
# every serving model's prompt attention: (label, heads, window)
FLASH_MODELS = (("", FLASH_PREFILL_HEADS, 0), ("rg ", RG_FLASH_HEADS,
                                               RG_WINDOW),
                ("gemma ", GEMMA_FLASH_HEADS, GEMMA_WINDOW),
                ("moe ", MOE_FLASH_HEADS, 0))
# the frontend families, served at full width and depth in bfloat16:
# whisper-small (encoder-decoder: 12 encoder and 12 decoder layers, MHA
# 12/12 x 64; three proxies of 12 encoder and 3 decoder layers), 4
# transcriptions of 30 s of audio (1500 frame embeddings each) with a
# 4-token start prompt and 64 greedy tokens (its rounds wait on the
# host); qwen2-vl-7b (28 layers, GQA 28/4 x 128; three 7-layer
# proxies), 4 lanes of 2048-token prompts whose first 1024 positions are
# an image's patch embeddings, then one request of 1280 tokens, 32 greedy
# tokens each. Their float32 depth cuts against the CPU port: whisper at
# 2 encoder and 2 decoder layers over the full 1500 frames, qwen2-vl at 2
# layers with a 1,100-token prompt (its 1024 patches inserted)
WHISPER_ARCH, VLM_ARCH = "whisper-small", "qwen2-vl-7b"
WHISPER_LANES, WHISPER_PROMPT, WHISPER_NEW = 4, 4, 64
VLM_LANES, VLM_PROMPTS, VLM_NEW = 4, (2048, 1280), 32
WHISPER_CUT_LAYERS, VLM_CUT_LAYERS = 2, 2
VLM_CUT_BATCH, VLM_CUT_PROMPT = 1, 1100
WHISPER_FLASH_HEADS, VLM_FLASH_HEADS = (12, 12, 64), (28, 4, 128)
FRAMES = 1500
# their attention shapes, (B, S, T, heads, causal): the whisper encoders'
# non-causal self-attention over 1500 frames (the active party's 4 lanes,
# the passive group's 12 folded; B = 1 for one request), the decoder's
# cross-attention against 1500 keys at the 3-token prefill and the 1-token
# decode round, and qwen2-vl's causal 28/4 prefills of 2047 and 1279
# a model rank's heads of whisper-small under the fsdp phase's (h) (1 x 4:
# 3/3 of 64 a rank): the encoder's non-causal self-attention over 1500
# frames and the cross-attention at the 64-token prefill and the 1-token
# round against 1500 keys, for the active party's 4 lanes and the passive
# group's 12 (3 parties x 4 lanes, folded into the batch axis)
FLASH_TP_WHISPER_HEADS = (3, 3, 64)
FLASH_TP_WHISPER = tuple((B, S, FRAMES) for B in (4, 12)
                         for S in (FRAMES, 64, 1))
FLASH_FRONTEND = tuple(
    (B, FRAMES, FRAMES, WHISPER_FLASH_HEADS, False) for B in (1, 4, 12)) \
    + tuple((B, S, FRAMES, WHISPER_FLASH_HEADS, False) for B in (4, 12)
            for S in (WHISPER_PROMPT - 1, 1)) \
    + tuple((B, S, S, VLM_FLASH_HEADS, True) for B in (1, 4, 12)
            for S in (VLM_PROMPTS[0] - 1, VLM_PROMPTS[1] - 1)) \
    + tuple((B, S, T, FLASH_TP_WHISPER_HEADS, False)
            for B, S, T in FLASH_TP_WHISPER)
# flash_attention_fwd's timing shapes: (label, B, S, heads, window, T,
# causal), the active party's (B = 1) and the folded passive group's (B =
# 3) prefills, then the shapes the frontend families' counted paths launch
FLASH_TIMING = tuple(("", B, S, FLASH_PREFILL_HEADS, 0, S, True)
                     for B in (1, 3) for S in (1023, 2047)) + tuple(
    (label, B, 2047, heads, window, 2047, True) for label, heads, window
    in FLASH_MODELS[1:] for B in (1, 3)) + tuple(
    ("whisper ", B, S, WHISPER_FLASH_HEADS, 0, FRAMES, False)
    for B in (4, 12) for S in (FRAMES, WHISPER_PROMPT - 1, 1)) + tuple(
    ("vlm ", B, S, VLM_FLASH_HEADS, 0, S, True)
    for B, S in ((4, 2047), (12, 2047), (1, 1279), (3, 1279))) + tuple(
    ("whisper tp ", B, S, FLASH_TP_WHISPER_HEADS, 0, T, False)
    for B, S, T in FLASH_TP_WHISPER)
# rglru_scan_fwd against its plain version: the reference sweep
# (tests/test_kernels.py), ragged L and W, and the serving path's prefill
# shapes (B = 1, and 3 for the folded passive group) at width 4096
RGLRU_SWEEP = ((2, 64, 128), (1, 128, 256), (4, 32, 64), (3, 96, 128))
RGLRU_RAGGED = ((2, 7, 100), (1, 1000, 4000), (3, 7, 4000), (1, 1000, 100))
RGLRU_SERVE = tuple((B, L, 4096) for B in (1, 3) for L in (511, 1023, 2047))
# widths whose rows are not a multiple of 16 bytes, and L = 0: the kernel
# of one thread per column
RGLRU_PER_COLUMN = ((2, 7, 101), (1, 1000, 102), (2, 0, 64))
# the timing shapes (B, L, W), float32: the serving path's largest
# prefills, and a model rank's width block of recurrentgemma-9b's under
# the fsdp phase's (g) (512 tokens, 4096 / 4 wide: the active party's 4
# lanes and the passive group's 12, 3 parties x 4 lanes); each must take
# the TMA path
RGLRU_TIMING = ((1, 2047, 4096), (3, 2047, 4096), (4, 512, 1024),
                (12, 512, 1024))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bf16_ulp(x):
    """One bfloat16 ulp at each value of float32 tensor x."""
    import torch
    _, e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(x), e - 8)


def max_err(got, want, dtype):
    """(max abs error, passes): float32 within atol = rtol = 1e-5,
    bfloat16 within one bfloat16 ulp of the float32-accumulated value."""
    import torch
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    if dtype == torch.bfloat16:
        ok = bool((err <= bf16_ulp(w)).all())
    else:
        ok = bool((err <= 1e-5 + 1e-5 * w.abs()).all())
    return float(err.max()), ok


def flash_bound_used(out, q, k, v, causal=True, window=0):
    """The largest share that ``out`` uses of the bfloat16 flash kernel's
    error bound against float32 attention on the same inputs:
    |out - exact| <= ulp_bf16(exact) + 2^-8 A(q, k, |v|) + 1e-5, A being
    float32 attention with |v| in place of v. The kernel rounds P to
    bfloat16 for the PV product (each term p_j v_j moves by at most 2^-9
    relative, the output by at most 2^-9 A) and rounds the output once;
    2^-8 leaves a factor of two for the float32 score product and exp2.
    Rows with nothing unmasked are held to the plain version's mean of v
    there, as everywhere else."""
    from repro_torch.kernels import ref
    qf, kf, vf = q.float(), k.float(), v.float()
    exact = ref.reference_attention(qf, kf, vf, causal=causal, window=window)
    mag = ref.reference_attention(qf, kf, vf.abs(), causal=causal,
                                  window=window)
    return float(((out.float() - exact).abs()
                  / (bf16_ulp(exact) + 2.0 ** -8 * mag + 1e-5)).max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    """Every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(build.build, names))
    dt = time.perf_counter() - t0
    for name, path in zip(names, paths):
        logf = path.with_suffix(".log")
        text = logf.read_text() if logf.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = len(re.findall(r"[1-9]\d* bytes spill", text))
        log("build", f"{name}.cu -> {path.name} (nvcc sm_90a; {len(regs)} "
                     f"kernels, max {max(regs or [0])} registers, {spills} "
                     f"with spills)")
        build.load(name)
    log("build", f"{len(names)} sources in {dt:.1f} s, built in parallel")
    return dict(zip(names, paths))


def _ptxas_spills(path, kernel_re):
    """{instantiation tag: (spill stores, spill loads) in bytes} from the
    ptxas -v log of library ``path``, for the entry functions whose mangled
    name matches ``kernel_re`` (its group 1 is the tag)."""
    text = path.with_suffix(".log").read_text()
    out = {}
    for block in text.split("Compiling entry function")[1:]:
        m = re.search(kernel_re, block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if m and spill:
            out[m.group(1)] = (int(spill.group(1)), int(spill.group(2)))
    return out


def _sass_counts(path, kernel, ops):
    """(functions, {op: count}) of the SASS instructions ``ops`` in the
    functions of library ``path`` whose name holds ``kernel``."""
    from pathlib import Path
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
             if kernel in f.splitlines()[0]]
    return len(funcs), {op: sum(len(re.findall(rf"\b{op}\b", f))
                                for f in funcs) for op in ops}


def _check_flash_build(path):
    """The bfloat16 flash kernel as built: registers, shared memory and
    spills at each head dim (ptxas -v and cudaFuncGetAttributes), and its
    SASS must issue wgmma (HGMMA) and TMA loads (UTMALDG)."""
    from repro_torch.kernels import flash_attention as tfa
    ptxas = _ptxas_spills(path, r"flash_fwd_wgmmaILi(\d+)E")
    for hd in tfa.HEAD_DIMS:
        info = tfa.wgmma_info(hd)
        st, ld = ptxas.get(str(hd), ("?", "?"))
        log("build", f"flash_fwd_wgmma<{hd}> (bfloat16): {info['registers']}"
                     f" registers, {info['smem_bytes']} B shared memory a "
                     f"CTA, {info['local_bytes']} B local memory; ptxas "
                     f"spill stores {st} B, loads {ld} B")
    n, counts = _sass_counts(path, "flash_fwd_wgmma",
                             ("HGMMA", "UTMALDG", "UTMASTG"))
    log("build", f"flash_fwd_wgmma SASS ({n} instantiations): {counts}")
    if n != len(tfa.HEAD_DIMS) or not counts["HGMMA"] \
            or not counts["UTMALDG"]:
        raise AssertionError(f"the bfloat16 flash kernel's SASS lacks wgmma "
                             f"or TMA loads: {n} functions, {counts}")


def _check_rglru_build(path):
    """The RG-LRU TMA kernel as built: registers, shared memory and spills
    for float32 and bfloat16 a and b, and its SASS must issue TMA loads
    (UTMALDG) in both."""
    import torch
    from repro_torch.kernels import rg_lru as trg
    ptxas = _ptxas_spills(path, r"rglru_tma_kernelI(\w+?)EEv")
    for dt, tag in ((torch.float32, "f"), (torch.bfloat16, "13__nv_bfloat16")):
        info = trg.tma_info(dt)
        st, ld = ptxas.get(tag, ("?", "?"))
        log("build", f"rglru_tma_kernel ({str(dt)[6:]} a and b): "
                     f"{info['registers']} registers, {info['smem_bytes']} B "
                     f"shared memory a CTA, {info['local_bytes']} B local "
                     f"memory; ptxas spill stores {st} B, loads {ld} B")
    n, counts = _sass_counts(path, "rglru_tma_kernel", ("UTMALDG",))
    log("build", f"rglru_tma_kernel SASS ({n} instantiations): {counts}")
    if n != 2 or not counts["UTMALDG"]:
        raise AssertionError(f"the RG-LRU kernel's SASS lacks TMA loads: {n} "
                             f"functions, {counts}")


def _agg_launches():
    """blind_agg's launch counts, with blind_agg_fwd's launches by party
    groups G under "fwd_groups" (None on a tree whose forward has no
    groups)."""
    from repro_torch.kernels import blind_agg as tba
    groups = getattr(tba, "FWD_GROUPS", None)
    return {**tba.LAUNCHES,
            "fwd_groups": None if groups is None else dict(groups)}


def _case(K, lead, d, dtype, mdtype, gen, reorder=False):
    """One blind_agg case, forward and backward, against the plain
    version. ``reorder``: the forward may also differ from the plain
    version, and from the exact float32 sum, by the float32 rounding that
    the order of the sum over parties moves, (K + 2) 2^-24 S / C with S =
    |E_a| + sum_k (|E_k| + |r_k|) (as for blind_agg_prng_fwd): one
    bfloat16 ulp of a sum that cancels to near zero is smaller than that,
    and a million outputs hold such sums."""
    import torch
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.kernels import ref
    dev = "cuda"
    ea = torch.randn(lead + (d,), generator=gen, device=dev).to(dtype)
    ep = torch.randn((K,) + lead + (d,), generator=gen, device=dev).to(dtype)
    mk = torch.randn((K,) + lead + (d,), generator=gen, device=dev).to(mdtype)
    g = torch.randn(lead + (d,), generator=gen, device=dev).to(dtype)
    ts = [t.clone().requires_grad_(True) for t in (ea, ep, mk)]
    ps = [t.clone().requires_grad_(True) for t in (ea, ep, mk)]
    out = tba.blind_agg(*ts)
    want = ref.reference_blind_agg(*ps)
    out.backward(g)
    want.backward(g)
    torch.cuda.synchronize()
    exact = ref.reference_blind_agg(ea.float(), ep.float(), mk.float())
    errs, oks = [], []
    e, ok = max_err(out, want, dtype)
    slack = 0.0
    if reorder:
        S = ea.float().abs() + (ep.float().abs() + mk.float().abs()).sum(0)
        slack = (K + 2) * 2.0 ** -24 * S / (K + 1)
        ok = bool(((out.float() - want.float()).abs()
                   <= bf16_ulp(want.float()) + slack).all())
    # bf16 output: compare against the float32 accumulation it rounds
    if dtype == torch.bfloat16:
        ok = ok and bool(((out.float() - exact).abs()
                          <= bf16_ulp(exact) + slack).all())
    errs.append(e)
    oks.append(ok)
    for a, b in zip(ts, ps):
        if a.grad.dtype != b.grad.dtype:
            raise AssertionError(f"grad dtype {a.grad.dtype} != {b.grad.dtype}")
        e, ok = max_err(a.grad, b.grad, a.grad.dtype)
        errs.append(e)
        oks.append(ok)
    return errs, all(oks)


def phase_kernels():
    """Both kernels against their plain versions on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(K, (N,), d, dt, dt) for dt in (f32, bf16)
             for K in (1, 3, 15, 63, 127) for N in (128, 100)
             for d in (128, 64, 100)]
    cases += [(K, (2, 64), d, dt, dt) for K in (3, 63) for d in (128, 100)
              for dt in (f32, bf16)]                     # 4-D input
    cases += [(3, (128,), 128, bf16, f32), (63, (128,), 64, f32, bf16)]
    cases += [(3, (7,), 13, f32, f32), (5, (9,), 11, bf16, bf16)]  # N*d % 8
    # every party-group count the forward's rule gives, and the serving
    # rounds and the LM training step: bfloat16 embeddings, float32 masks,
    # N the prompt, 4 lanes, or the step's 4 x 2048 tokens
    cases += [(K, (128,), 64, f32, f32) for K in (2, 8, 9, 31, 32, 33, 64,
                                                  255)]
    cases += [(3, (N,), 128, bf16, f32) for N in (4, 512, 1024, 2048)]
    cases += [(3, (8192,), 128, bf16, f32, True)]
    worst = {f32: 0.0, bf16: 0.0}
    worst_f32 = {"blind_agg_fwd": 0.0, "blind_agg_bwd": 0.0}
    failed = []
    for K, lead, d, dt, mdt, *reorder in cases:
        errs, ok = _case(K, lead, d, dt, mdt, gen, *reorder)
        worst[dt] = max(worst[dt], max(errs))
        if dt == f32:
            worst_f32["blind_agg_fwd"] = max(worst_f32["blind_agg_fwd"],
                                             errs[0])
            worst_f32["blind_agg_bwd"] = max(worst_f32["blind_agg_bwd"],
                                             max(errs[1:]))
        tag = (f"K={K} shape={lead + (d,)} {str(dt)[6:]} "
               f"mask={str(mdt)[6:]}")
        log("kernel", f"{tag}: max_abs_err out {errs[0]:.3g} dEa {errs[1]:.3g} "
                      f"dEp {errs[2]:.3g} dr {errs[3]:.3g} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(tag)
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{failed}")
    log("kernel", f"{len(cases)} cases within tolerance (float32 atol=rtol="
                  f"1e-5, bfloat16 one ulp, at the training shape plus the "
                  f"float32 sum-order bound); worst float32 "
                  f"{worst[f32]:.3g}, bfloat16 {worst[bf16]:.3g}")
    return worst_f32


def _ulp(x, dtype):
    """One ulp of ``dtype`` at each value of float32 tensor x."""
    import torch
    _, e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.float32).tiny))
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(dtype, 24)
    return torch.ldexp(torch.ones_like(x), e - bits)


@functools.lru_cache(maxsize=None)
def _kernel_mask_engine(K):
    """The MaskEngine of the prng kernel's checks and timing: K passive
    parties' pair seeds from blinding's PRF (prf_seed) over the pair's
    indices, in place of the DH ceremony's shared keys (one 2048-bit
    modexp a pair in Python: 37 s of host time at K = 127, H100 80GB HBM3
    machine). The kernel and its plain version see only the 63-bit seed
    words; the protocol phases keep the ceremony's engines."""
    from repro_torch.core import blinding
    seeds = {}
    for k in range(K):
        for j in range(k + 1, K):
            seeds[(k, j)] = seeds[(j, k)] = blinding.prf_seed(
                f"{k},{j}".encode())
    return blinding.MaskEngine.from_seeds(K, seeds)


def _prng_case(K, lead, d, dtype, pdtype, scale, rnd, gen):
    """One prng case, E_a (and the output) in ``dtype``, E_k in
    ``pdtype``: (max err vs plain, tolerance at that element, max err vs
    unmasked mean, its tolerance, backward ok)."""
    import torch
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.kernels import ref
    eng = _kernel_mask_engine(K)
    ea = torch.randn(lead + (d,), generator=gen, device="cuda").to(dtype)
    ep = torch.randn((K,) + lead + (d,), generator=gen,
                     device="cuda").to(pdtype)
    ts = [t.clone().requires_grad_(True) for t in (ea, ep)]
    ps = [t.clone().requires_grad_(True) for t in (ea, ep)]
    out = tba.prng_blind_agg(*ts, eng, rnd, scale)
    want = ref.reference_blind_agg_prng(*ps, eng, rnd, mask_scale=scale)
    g = torch.randn(want.shape, generator=gen, device="cuda").to(dtype)
    out.backward(g)
    want.backward(g)
    torch.cuda.synchronize()
    mq = eng.masks(lead + (d,), rnd, "float", scale=scale,
                   device="cuda").to(pdtype).float()
    # summation order only: (K + 2) roundings of at most S = |E_a| +
    # sum_k (|E_k| + |r_k|), / C, plus one ulp of the output's dtype
    S = ea.float().abs() + (ep.float().abs() + mq.abs()).sum(0)
    o, w = out.detach().float(), want.detach().float()
    tol = (K + 2) * 2.0 ** -24 * S / (K + 1) + _ulp(w, dtype)
    err = (o - w).abs()
    # cancellation: the unmasked mean, off by the masks' own residual
    # |sum_k r_k| (their float32 fold and the cast to E's dtype), the same
    # rounding allowance and the output's own rounding (one ulp at the
    # larger of the two, as the residual may move it to another binade)
    mean = (ea.float() + ep.float().sum(0)) / (K + 1)
    resid = mq.double().sum(0).abs().float() / (K + 1)
    ctol = (resid + (2 * K + 2) * 2.0 ** -24 * S / (K + 1)
            + torch.maximum(_ulp(mean, dtype), _ulp(o, dtype)))
    cerr = (o - mean).abs()
    gok = all(a.grad.dtype == b.grad.dtype and bool(
        ((a.grad.float() - b.grad.float()).abs()
         <= _ulp(b.grad.float(), b.grad.dtype) + 1e-7).all())
        for a, b in zip(ts, ps))
    i = int(torch.argmax(err))
    return (float(err.max()), float(tol.flatten()[i]), bool((err <= tol).all()),
            float(cerr.max()), float(ctol.max()), bool((cerr <= ctol).all()),
            gok, out.detach())


def phase_prng(outputs=None):
    """blind_agg_prng_fwd against its plain version on the card; the
    kernel's outputs are appended to ``outputs`` when it is a list."""
    import torch
    from repro_torch.core import blinding
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    rounds = (0, 7, blinding.SERVE_DOMAIN + 3)
    cases = []
    for K in (2, 3, 7, 15, 63, 127):
        for N in (100, 128):
            for d in (64, 100, 128):
                for dt in (f32, bf16):
                    i = len(cases)
                    cases.append((K, (N,), d, dt, dt,
                                  (1.0, 4.0)[(i // 2) % 2], rounds[i % 3]))
    cases += [(7, (2, 64), 128, f32, f32, 4.0, rounds[2]),
              (63, (2, 64), 64, bf16, bf16, 1.0, rounds[1])]  # 4-D input
    # E_a float32, E_k narrower: r_k rounded to E_k's dtype no longer
    # cancels to float32 rounding, so a missing or wrong mask shows on the
    # float32 output
    cases += [(K, (128,), 64, f32, pdt, scale, rounds[i % 3])
              for i, (K, pdt, scale) in enumerate(
                  ((3, bf16, 1.0), (15, f16, 4.0), (63, bf16, 1.0),
                   (63, f16, 4.0), (127, bf16, 4.0)))]
    worst = {f32: [0.0, 0.0], bf16: [0.0, 0.0]}
    failed = []
    for K, lead, d, dt, pdt, scale, rnd in cases:
        err, tol, ok, cerr, ctol, cok, gok, out = _prng_case(
            K, lead, d, dt, pdt, scale, rnd, gen)
        if outputs is not None:
            outputs.append(out)
        if err > worst[dt][0]:
            worst[dt] = [err, tol]
        tag = (f"K={K} shape={lead + (d,)} {str(dt)[6:]} E_k "
               f"{str(pdt)[6:]} scale={scale:g} round={rnd}")
        log("prng", f"{tag}: max_abs_err {err:.3g} (tol there {tol:.3g}); "
                    f"vs unmasked mean {cerr:.3g} (tol {ctol:.3g}); backward "
                    f"{'ok' if gok else 'FAIL'}; "
                    f"{'ok' if ok and cok and gok else 'FAIL'}")
        if not (ok and cok and gok):
            failed.append(tag)
    if failed:
        raise AssertionError(f"prng kernel disagrees: {failed}")
    log("prng", f"{len(cases)} cases within tolerance ((K+2) float32 "
                f"roundings of |E_a| + sum_k(|E_k| + |r_k|), over C, plus "
                f"one ulp of the output's dtype); worst float32 "
                f"{worst[f32][0]:.3g} (tol there {worst[f32][1]:.3g}), "
                f"bfloat16 {worst[bf16][0]:.3g} (tol {worst[bf16][1]:.3g})")
    return worst[f32][0]


# (embedding-net widths, decision-net widths) of the paper's Table II
# heterogeneous MLP parties, as benchmarks/harness.py::hetero_arches builds
# them at its default depth (el_pl = (2, 1): three embedding layers, one
# prediction layer); party k takes entry k % 4.
TABLE2_WIDTHS = [((256, 128, 256), (128,)),
                 ((128, 64, 128), (64,)),
                 ((512, 256, 512), (256,)),
                 ((96, 48, 96), (48,))]


def table2_arches(C: int, n_cls: int, d_embed: int):
    from repro_torch.core.party_models import PartyArch
    return [PartyArch("mlp", *TABLE2_WIDTHS[k % 4], d_embed, n_cls)
            for k in range(C)]


def _build_slice(grad_mode, device, **kw):
    from repro_torch.configs.base import EasterConfig
    from repro_torch.core.protocol import EasterClassifier
    return EasterClassifier(EasterConfig(num_passive=3, d_embed=D_EMBED),
                            table2_arches(4, 10, D_EMBED), [196] * 4,
                            grad_mode=grad_mode, device=device, **kw)


def _to(xs, y, device):
    import torch
    return ([torch.from_numpy(x).to(device) for x in xs],
            torch.from_numpy(y).to(device))


def phase_slice(ds, batches, params0):
    """30 Table II rounds on the card; step 0 against the CPU port."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.kernels import blind_agg as tba
    gpu, cpu = _build_slice("easter", "cuda"), _build_slice("easter", "cpu")
    params = checkpoint.params_from_numpy(params0, "cuda")
    cparams = checkpoint.params_from_numpy(params0, "cpu")
    init_opt, step = gpu.make_train_step("adam", 1e-3)
    cinit, cstep = cpu.make_train_step("adam", 1e-3)
    opt, copt = init_opt(params), cinit(cparams)
    totals, round_ms = [], []
    tba.reset_launches()
    for i in range(SLICE_ROUNDS):
        xs, y = _to(*batches[i], "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = gpu.masks(SLICE_BATCH, i)
        params, opt, total, per = step(params, opt, xs, y, masks)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        if tba.LAUNCHES["blind_agg_fwd"] != i + 1:
            raise AssertionError(f"round {i}: forward kernel launches "
                                 f"{tba.LAUNCHES['blind_agg_fwd']} != {i + 1}")
        totals.append(float(total))
        if i == 0:
            cm = cpu.masks(SLICE_BATCH, 0)
            mask_err = float((masks.cpu() - cm).abs().max())
            cxs, cy = _to(*batches[0], "cpu")
            _, _, ctotal, cper = cstep(cparams, copt, cxs, cy, masks.cpu())
            rel = float(((per.cpu() - cper).abs() / cper.abs()).max())
            log("slice", f"step 0 per-party losses card "
                         f"{[round(float(v), 6) for v in per]} cpu "
                         f"{[round(float(v), 6) for v in cper]}: max rel "
                         f"diff {rel:.3g} (limit 1e-4); masks made on the "
                         f"card vs the CPU: max abs diff {mask_err:.3g} "
                         f"(limit 4e-6)")
            if not rel <= 1e-4:
                raise AssertionError("step 0 differs between card and CPU")
            # same PRF bits on both; log1p/sqrt differ by an ulp or two
            # between CUDA and the CPU, in each of a party's two pair masks
            if not mask_err <= 4e-6:
                raise AssertionError("PRF masks differ between card and CPU")
    launches = _agg_launches()
    if not all(math.isfinite(t) for t in totals):
        raise AssertionError(f"non-finite loss: {totals}")
    first, last = statistics.mean(totals[:3]), statistics.mean(totals[-3:])
    log("slice", f"{SLICE_ROUNDS} rounds: total loss {totals[0]:.4f} -> "
                 f"{totals[-1]:.4f} (mean of first 3 {first:.4f}, last 3 "
                 f"{last:.4f}); launches {launches}")
    if not last < first:
        raise AssertionError("total loss did not fall")
    xs_te, y_te = _to(ds.x_test_parts, ds.y_test, "cuda")
    acc = gpu.accuracy(params, xs_te, y_te)
    steady = statistics.median(round_ms[5:])
    log("slice", f"per-party test accuracy {[round(float(a), 4) for a in acc]}"
                 f"; ms per round (median of rounds 5-{SLICE_ROUNDS - 1}, "
                 f"masks + forward + backward + adam) {steady:.3f}")
    return launches, steady


def phase_joint(batches, params0):
    """One grad_mode="joint" round on the card; gradients vs the CPU."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.tree import tree_leaves
    gpu, cpu = _build_slice("joint", "cuda"), _build_slice("joint", "cpu")
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = gpu.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    xs, y = _to(*batches[0], "cuda")
    masks = gpu.masks(SLICE_BATCH, 0)
    tba.reset_launches()
    step(params, opt, xs, y, masks)
    torch.cuda.synchronize()
    launches = _agg_launches()
    if launches["blind_agg_bwd"] < 1 or launches["blind_agg_fwd"] < 1:
        raise AssertionError(f"joint round launches {launches}")
    # gradients of the same round from the same weights, card vs CPU
    gp = checkpoint.params_from_numpy(params0, "cuda")
    cp = checkpoint.params_from_numpy(params0, "cpu")
    gt, _ = gpu.loss_fn(gp, xs, y, masks)
    ct, _ = cpu.loss_fn(cp, *_to(*batches[0], "cpu"), masks.cpu())
    gg = torch.autograd.grad(gt, tree_leaves(gp))
    cg = torch.autograd.grad(ct, tree_leaves(cp))
    worst = 0.0
    for a, b in zip(gg, cg):
        err = float(((a.cpu() - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
        worst = max(worst, err)
    log("joint", f"1 round: launches {launches}; gradients card vs CPU "
                 f"within atol 1e-5 + rtol 1e-4 (worst ratio {worst:.3g})")
    if not worst <= 1.0:
        raise AssertionError("joint-mode gradients differ between card and CPU")
    return launches


# the many-party benchmark's zoo (benchmarks/many_party_scaling.py::mlp_zoo):
# four MLP shapes cycled, embedding widths w, one prediction layer w[-1]
MLP_ZOO_WIDTHS = [(64, 32), (32, 16), (96, 48), (48, 24)]


def mlp_zoo(C: int, n_cls: int, d_embed: int):
    from repro_torch.core.party_models import PartyArch
    return [PartyArch("mlp", MLP_ZOO_WIDTHS[k % 4],
                      (MLP_ZOO_WIDTHS[k % 4][-1],), d_embed, n_cls)
            for k in range(C)]


def _build_many(device, *, fused=True, grad_mode="easter", mode="float",
                engine="vectorized", group=None):
    import torch
    from repro_torch.configs.base import EasterConfig
    from repro_torch.core.protocol import EasterClassifier, split_features
    nf = [v.shape[-1] for v in split_features(torch.zeros(1, MP_FEATURES),
                                              MP_C)]
    return EasterClassifier(
        EasterConfig(num_passive=MP_C - 1, d_embed=MP_D_EMBED,
                     mask_mode=mode),
        mlp_zoo(MP_C, MP_CLASSES, MP_D_EMBED), nf, grad_mode=grad_mode,
        fused_masks=fused, device=device, engine=engine, group=group)


def _many_data(cls):
    """One batch of the benchmark's shape from numpy seed 0, split into
    the parties' slices (the benchmark trains on one fixed batch)."""
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.normal(size=(MP_BATCH, MP_FEATURES)).astype(np.float32)
    y = rng.integers(0, MP_CLASSES, MP_BATCH).astype(np.int64)
    offs = np.cumsum([0] + cls.n_features)
    return [x[:, offs[k]:offs[k + 1]].copy() for k in range(cls.C)], y


def _rounds(cls, params0, data, n, counter_key):
    """n training rounds on the card: (ms per round, totals, per-party
    losses of round 0, launches). Counters are set to 0 just before."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.kernels import blind_agg as tba
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = cls.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    xs, y = _to(*data, "cuda")
    ms, totals, per0 = [], [], None
    torch.cuda.synchronize()
    tba.reset_launches()
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = cls.masks(MP_BATCH, i)
        params, opt, total, per = step(params, opt, xs, y, masks)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if tba.LAUNCHES[counter_key] != i + 1:
            raise AssertionError(f"round {i}: {counter_key} launches "
                                 f"{tba.LAUNCHES[counter_key]} != {i + 1}")
        totals.append(float(total))
        if i == 0:
            per0 = per.cpu()
    return ms, totals, per0, _agg_launches(), (params, opt, step)


def phase_many():
    """The many-party slice: C = 64 mlp_zoo, fused masks, on the card."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cpu = _build_many("cpu")
    fused = _build_many("cuda")
    setup_s = time.perf_counter() - t0
    params0 = checkpoint.params_to_numpy(
        cpu.init_params(torch.Generator().manual_seed(0)))
    data = _many_data(cpu)
    n_params = sum(a.size for a in tree_leaves(params0))
    log("many", f"mlp_zoo C={MP_C} ({fused._eng.n_groups} execution groups), "
                f"d_embed {MP_D_EMBED}, batch {MP_BATCH}, {MP_FEATURES} "
                f"features split {sorted(set(cpu.n_features))}, adam 1e-3, "
                f"{n_params} parameters from seed 0; classifiers built in "
                f"{setup_s:.1f} s of host time (the DH ceremony of 63 "
                f"passive parties, memoized for the later phases)")
    ms, totals, per, launches, _ = _rounds(fused, params0, data, MP_ROUNDS,
                                           "blind_agg_prng_fwd")
    if launches["blind_agg_fwd"] != 0:
        raise AssertionError(f"fused rounds launched blind_agg_fwd: "
                             f"{launches}")
    # step 0 on the CPU port: the plain version (MaskEngine masks)
    cparams = checkpoint.params_from_numpy(params0, "cpu")
    cinit, cstep = cpu.make_train_step("adam", 1e-3)
    t1 = time.perf_counter()
    _, _, _, cper = cstep(cparams, cinit(cparams), *_to(*data, "cpu"),
                          cpu.masks(MP_BATCH, 0))
    cpu_s = time.perf_counter() - t1
    rel = float(((per - cper).abs() / cper.abs()).max())
    log("many", f"step 0 per-party losses, first 4 of {MP_C}: card "
                f"{[round(float(v), 6) for v in per[:4]]} cpu "
                f"{[round(float(v), 6) for v in cper[:4]]}; max rel diff over "
                f"all {MP_C} {rel:.3g} (limit 1e-4); the CPU round took "
                f"{cpu_s:.2f} s")
    if not rel <= 1e-4:
        raise AssertionError("many-party step 0 differs between card and CPU")
    if not all(math.isfinite(t) for t in totals):
        raise AssertionError(f"non-finite loss: {totals}")
    first, last = statistics.mean(totals[:3]), statistics.mean(totals[-3:])
    if not last < first:
        raise AssertionError("many-party total loss did not fall")
    fused_ms = statistics.median(ms[5:])
    log("many", f"fused masks: {MP_ROUNDS} rounds, total loss "
                f"{totals[0]:.4f} -> {totals[-1]:.4f} (mean of first 3 "
                f"{first:.4f}, last 3 {last:.4f}); ms per round (median of "
                f"rounds 5-{MP_ROUNDS - 1}, host clock ending in "
                f"synchronize) {fused_ms:.3f}; first round {ms[0]:.1f} ms; "
                f"launches {launches} "
                f"({launches['blind_agg_prng_fwd'] / MP_ROUNDS:g} "
                f"blind_agg_prng_fwd a round)")
    # one joint round: the backward kernel
    joint = _build_many("cuda", grad_mode="joint")
    _, _, _, jl, _ = _rounds(joint, params0, data, 1, "blind_agg_prng_fwd")
    if jl["blind_agg_bwd"] != 1:
        raise AssertionError(f"joint round launches {jl}")
    log("many", f"1 joint round: launches {jl}")
    # the same rounds with MaskEngine masks on the card + blind_agg_fwd
    plain = _build_many("cuda", fused=False)
    pms, ptot, _, pl, _ = _rounds(plain, params0, data, MP_ROUNDS,
                                  "blind_agg_fwd")
    unfused_ms = statistics.median(pms[5:])
    log("many", f"unfused masks (MaskEngine on the card, host pair keys, "
                f"then blind_agg_fwd): ms per round {unfused_ms:.3f} "
                f"(fused {fused_ms:.3f}); total loss {ptot[0]:.4f} -> "
                f"{ptot[-1]:.4f}; launches {pl}")
    _profile_many(fused, params0, data)
    return launches, jl, pl, fused_ms, unfused_ms


def _profile_many(cls, params0, data):
    """Device busy time and idle share over PROFILE_ROUNDS fused
    many-party rounds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import checkpoint
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = cls.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    xs, y = _to(*data, "cuda")
    for i in range(3):
        params, opt, _, _ = step(params, opt, xs, y, cls.masks(MP_BATCH, i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3, 3 + PROFILE_ROUNDS):
            params, opt, _, _ = step(params, opt, xs, y,
                                     cls.masks(MP_BATCH, i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    kern = [r for r in rows if r.device_type == DeviceType.CUDA]
    busy_ms = sum(r.self_device_time_total for r in kern) / 1e3
    n = sum(r.count for r in kern)
    log("many", f"{PROFILE_ROUNDS} fused rounds under torch.profiler: wall "
                f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle "
                f"share {1 - busy_ms / wall_ms:.3f}), {n} kernels "
                f"({n / PROFILE_ROUNDS:.0f} a round)")
    for r in sorted(kern, key=lambda r: -r.self_device_time_total)[:6]:
        log("many", f"  {r.key[:60]:60s} calls {r.count:5d} device "
                    f"{r.self_device_time_total / 1e3:.3f} ms")


def phase_wires(params0_t2, batches):
    """Engines at Table II and ring wires at C = 64, card against CPU."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.tree import tree_leaves
    # vectorized vs loop on the card: step-0 losses and gradients
    res = {}
    for engine in ("vectorized", "loop"):
        cls = _build_slice("easter", "cuda", engine=engine)
        p = checkpoint.params_from_numpy(params0_t2, "cuda")
        xs, y = _to(*batches[0], "cuda")
        tot, per = cls.loss_fn(p, xs, y, cls.masks(SLICE_BATCH, 0))
        res[engine] = (per.detach().cpu(), [g.cpu() for g in torch.autograd.grad(
            tot, tree_leaves(p))])
    (pv, gv), (pl, gl) = res["vectorized"], res["loop"]
    lrel = float(((pv - pl).abs() / pl.abs()).max())
    gworst = max(float(((a - b).abs() / (1e-6 + 1e-5 * b.abs())).max())
                 for a, b in zip(gv, gl))
    log("wires", f"Table II on the card, vectorized vs loop engine: step-0 "
                 f"losses max rel diff {lrel:.3g} (limit 1e-5), gradients "
                 f"within atol 1e-6 + rtol 1e-5 (worst ratio {gworst:.3g})")
    if not (lrel <= 1e-5 and gworst <= 1.0):
        raise AssertionError("vectorized and loop engines differ on the card")
    # ring wires at C = 64: card against the CPU port
    cpu0 = _build_many("cpu", fused=False)
    params0 = checkpoint.params_to_numpy(
        cpu0.init_params(torch.Generator().manual_seed(0)))
    data = _many_data(cpu0)
    for mode, limit in (("int32", 1e-4), ("int8", 1e-3)):
        out = []
        for dev in ("cuda", "cpu"):
            cls = _build_many(dev, fused=False, mode=mode)
            p = checkpoint.params_from_numpy(params0, dev)
            init_opt, step = cls.make_train_step("adam", 1e-3)
            m = cls.masks(MP_BATCH, 0)
            _, _, _, per = step(p, init_opt(p), *_to(*data, dev), m)
            out.append((per.cpu(), m.cpu()))
        rel = float(((out[0][0] - out[1][0]).abs() / out[1][0].abs()).max())
        same = bool(torch.equal(out[0][1], out[1][1]))
        log("wires", f"{mode} wire, C={MP_C}: {mode} masks card == CPU "
                     f"{same}; step-0 per-party losses max rel diff {rel:.3g} "
                     f"(limit {limit:g}; an embedding an ulp apart may land "
                     f"one quantization step away)")
        if not (same and rel <= limit):
            raise AssertionError(f"{mode} wire differs between card and CPU")


# the paper's baselines (Table II) and compressed EASTER at Table II: one
# builder per method, by device
BASELINES = ("local", "split", "cvfl", "agg", "easter_topk",
             "easter_topk_fused")
TOPK_FRAC = 0.25


def _build_method(name, device, grad_mode="easter"):
    from repro_torch.core import baselines
    arches, nf = table2_arches(4, 10, D_EMBED), [196] * 4
    if name == "local":
        return baselines.LocalOnly(arches, nf, device=device)
    if name in ("split", "cvfl"):
        return baselines.SplitVFL(
            arches, nf, 10, compress_frac=TOPK_FRAC if name == "cvfl" else 0,
            device=device)
    if name == "agg":
        return baselines.AggVFL(arches, nf, device=device)
    return _build_slice(grad_mode, device, compress_frac=TOPK_FRAC,
                        fused_masks=name == "easter_topk_fused")


def _method_step(m):
    from repro_torch.core import baselines
    if hasattr(m, "easter"):       # EasterClassifier: per-party optimizers
        return m.make_train_step("adam", 1e-3)
    return baselines.make_train_step(m, "adam", 1e-3)


def _method_masks(m, i):
    return m.masks(SLICE_BATCH, i) if hasattr(m, "easter") else None


def phase_baselines(ds, batches):
    """Table II's methods on the card: Local, SplitVFL, C_VFL, AggVFL and
    EASTER with a top-k uplink (float masks and fused), 30 rounds each,
    step 0 against the CPU port; then one compressed joint round."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    xs_te, y_te = _to(ds.x_test_parts, ds.y_test, "cuda")
    out, paths = {}, {}
    for name in BASELINES:
        gpu, cpu = _build_method(name, "cuda"), _build_method(name, "cpu")
        params0 = checkpoint.params_to_numpy(
            cpu.init_params(torch.Generator().manual_seed(0)))
        params = checkpoint.params_from_numpy(params0, "cuda")
        init_opt, step = _method_step(gpu)
        opt = init_opt(params)
        key = {"easter_topk": "blind_agg_fwd",
               "easter_topk_fused": "blind_agg_prng_fwd"}.get(name)
        ms, totals = [], []
        torch.cuda.synchronize()
        tba.reset_launches()
        for i in range(SLICE_ROUNDS):
            xs, y = _to(*batches[i], "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks = _method_masks(gpu, i)
            params, opt, total, per = step(params, opt, xs, y, masks)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            totals.append(float(total))
            want = {k: 0 for k in tba.LAUNCHES}
            if key:
                want[key] = i + 1
            if tba.LAUNCHES != want:
                raise AssertionError(f"{name} round {i}: launches "
                                     f"{tba.LAUNCHES} != {want}")
            if i == 0:
                per0, masks0 = per.cpu(), masks
        if key:
            paths[name] = _agg_launches()
        # step 0 on the CPU port, from the same weights (and float masks)
        cparams = checkpoint.params_from_numpy(params0, "cpu")
        cinit, cstep = _method_step(cpu)
        cm = (masks0.cpu() if isinstance(masks0, torch.Tensor)
              else _method_masks(cpu, 0))
        _, _, _, cper = cstep(cparams, cinit(cparams),
                              *_to(*batches[0], "cpu"), cm)
        rel = float(((per0 - cper).abs() / cper.abs()).max())
        log("baselines", f"{name} step 0 per-party losses card "
                         f"{[round(float(v), 6) for v in per0]}: max rel "
                         f"diff to the CPU port {rel:.3g} (limit 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"{name} step 0 differs between card and "
                                 f"CPU")
        if not all(math.isfinite(t) for t in totals):
            raise AssertionError(f"{name}: non-finite loss {totals}")
        first, last = statistics.mean(totals[:3]), statistics.mean(totals[-3:])
        if not last < first:
            raise AssertionError(f"{name}: total loss did not fall")
        acc = [round(float(a), 4) for a in gpu.accuracy(params, xs_te, y_te)]
        out[name] = {"ms": statistics.median(ms[5:]), "accuracy": acc,
                     "bytes_per_round": gpu.bytes_per_round(SLICE_BATCH),
                     "loss_first3": first, "loss_last3": last}
        if name == "agg":
            out[name]["aggregate_accuracy"] = round(float(
                gpu.aggregate_accuracy(params, xs_te, y_te)), 4)
        log("baselines", f"{name}: {SLICE_ROUNDS} rounds, total loss "
                         f"{first:.4f} -> {last:.4f} (means of the first "
                         f"and last 3); ms per step {out[name]['ms']:.3f} "
                         f"(median of rounds 5-{SLICE_ROUNDS - 1}); "
                         f"per-party test accuracy {acc}"
                         + (f" (averaged prediction "
                            f"{out[name]['aggregate_accuracy']})"
                            if name == "agg" else "")
                         + f"; bytes per round "
                         f"{out[name]['bytes_per_round']}")
    # one compressed joint round: the backward kernel on sparsified rows
    gpu = _build_method("easter_topk", "cuda", "joint")
    cpu = _build_method("easter_topk", "cpu", "joint")
    params0 = checkpoint.params_to_numpy(
        cpu.init_params(torch.Generator().manual_seed(0)))
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = gpu.make_train_step("adam", 1e-3)
    xs, y = _to(*batches[0], "cuda")
    masks = gpu.masks(SLICE_BATCH, 0)
    torch.cuda.synchronize()
    tba.reset_launches()
    step(params, init_opt(params), xs, y, masks)
    torch.cuda.synchronize()
    paths["easter_topk_joint"] = _agg_launches()
    if (tba.LAUNCHES["blind_agg_fwd"], tba.LAUNCHES["blind_agg_bwd"]) != \
            (1, 1):
        raise AssertionError(f"compressed joint round launches "
                             f"{tba.LAUNCHES}")
    gp = checkpoint.params_from_numpy(params0, "cuda")
    cp = checkpoint.params_from_numpy(params0, "cpu")
    gt, _ = gpu.loss_fn(gp, xs, y, masks)
    ct, _ = cpu.loss_fn(cp, *_to(*batches[0], "cpu"), masks.cpu())
    worst = max(float(((a.cpu() - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
                for a, b in zip(torch.autograd.grad(gt, tree_leaves(gp)),
                                torch.autograd.grad(ct, tree_leaves(cp))))
    log("baselines", f"compressed joint round: launches "
                     f"{paths['easter_topk_joint']}; gradients card vs CPU "
                     f"within atol 1e-5 + rtol 1e-4 (worst ratio "
                     f"{worst:.3g})")
    if not worst <= 1.0:
        raise AssertionError("compressed joint gradients differ between "
                             "card and CPU")
    out["seconds"] = time.perf_counter() - t_phase
    log("baselines", f"phase took {out['seconds']:.1f} s")
    return paths, out


def phase_wire(ds, batches, params0):
    """WireEaster at Table II (C = 4): three passive processes on the
    card, 20 rounds on the float wire and 20 on the int8 wire from the
    slice's weights; round 0 against the same run on the CPU; the
    transcript audited; beside it the in-process loop engine's round.
    The four systems (12 passive processes) start at once, each start()
    on a thread, and stay idle until their rounds."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from repro_torch import checkpoint
    from repro_torch.core.party_models import embed_fn
    from repro_torch.core.wire import WireEaster
    t_phase = time.perf_counter()
    systems = {(mode, card): WireEaster(
        table2_arches(4, 10, D_EMBED), [196] * 4, 10, lr=1e-3,
        record_transcript=card, mask_mode=mode,
        device="cuda" if card else "cpu", init_params=params0)
        for mode in ("float", "int8") for card in (True, False)}
    start_s = {}

    def timed_start(key):
        t0 = time.perf_counter()
        systems[key].start()
        start_s[key] = time.perf_counter() - t0

    res = {}
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(systems)) as ex:
            for f in [ex.submit(timed_start, k) for k in systems]:
                f.result()
        res["start_all_s"] = time.perf_counter() - t0
        log("wire", f"4 WireEaster systems (float and int8, card and CPU; "
                    f"12 passive processes) started at once in "
                    f"{res['start_all_s']:.2f} s; each start(): "
                    + ", ".join(f"{m} {'card' if card else 'CPU'} "
                                f"{s:.2f} s"
                                for (m, card), s in start_s.items()))
        for mode in ("float", "int8"):
            sys_ = systems[(mode, True)]
            losses, ms = [], []
            for i in range(MP_ROUNDS):
                t0 = time.perf_counter()
                losses.append(sys_.round(*batches[i], i))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            acc = sys_.evaluate(ds.x_test_parts, ds.y_test)
            # round 0 of the same system on the CPU
            closs = systems[(mode, False)].round(*batches[0], 0)
            totals = [sum(l) for l in losses]
            first = statistics.mean(totals[:3])
            last = statistics.mean(totals[-3:])
            if not (all(math.isfinite(t) for t in totals) and last < first):
                raise AssertionError(f"{mode} wire: total loss {totals}")
            if not np.isfinite(acc).all():
                raise AssertionError(f"{mode} wire: accuracies {acc}")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses[0], closs))
            kinds = {t[1] for t in sys_.transcript
                     if t[0] == "passive->active"}
            want = ({"blinded_embed", "prediction"} if mode == "float" else
                    {"embed_amax", "blinded_embed", "prediction"})
            if kinds != want:
                raise AssertionError(f"{mode} wire uplink kinds {kinds}")
            r0 = [t for t in sys_.transcript if t[2] == 0]
            res[mode] = {"ms": statistics.median(ms[3:]),
                         "start_s": start_s[(mode, True)],
                         "first_round_ms": ms[0],
                         "loss_first3": first, "loss_last3": last,
                         "accuracy": [round(float(a), 4) for a in acc],
                         "round0_rel_to_cpu": rel}
            log("wire", f"{mode} wire, C=4, 3 passive processes on the "
                        f"card: {MP_ROUNDS} rounds, total loss {first:.4f} "
                        f"-> {last:.4f} (means of the first and last 3); ms "
                        f"per round {res[mode]['ms']:.3f} (median of rounds "
                        f"3-{MP_ROUNDS - 1}, first {ms[0]:.1f}); test "
                        f"accuracy {res[mode]['accuracy']}; round 0 "
                        f"per-party losses card vs CPU max rel diff "
                        f"{rel:.3g} (limit 1e-4); uplink kinds "
                        f"{sorted(kinds)}")
            if not rel <= 1e-4:
                raise AssertionError(f"{mode} wire round 0 differs between "
                                     f"card and CPU")
            if mode != "float":
                continue
            # the transcript audit: blinded, not raw, and the masks cancel
            p = checkpoint.params_from_numpy(params0, "cuda")
            xs, _ = _to(*batches[0], "cuda")
            deltas = []
            for (_, _, _, k, blinded) in (t for t in r0
                                          if t[1] == "blinded_embed"):
                with torch.no_grad():
                    raw = embed_fn(p[k], sys_.arches[k], xs[k]).cpu().numpy()
                deltas.append(blinded - raw)
            gap = min(float(np.abs(d).max()) for d in deltas)
            residue = float(np.abs(sum(deltas)).max())
            n_bytes = sum(t[4].nbytes * (sys_.K if t[1] == "global_embed"
                                         else 1) for t in r0)
            want_bytes = _build_slice("easter", "cpu").bytes_per_round(
                SLICE_BATCH)
            res["float"].update(bytes_per_round=n_bytes,
                                classifier_bytes_per_round=want_bytes)
            log("wire", f"float transcript, round 0: no blinded embedding "
                        f"is its raw E_k (max |difference| of each >= "
                        f"{gap:.3f}, limit > 0.5); the {len(deltas)} deltas "
                        f"sum to within {residue:.3g} of 0 (limit 1e-4); "
                        f"{n_bytes} bytes on the wire (the global embedding "
                        f"counted once per passive party) beside "
                        f"EasterClassifier.bytes_per_round(128) = "
                        f"{want_bytes}")
            if len(deltas) != 3 or not gap > 0.5 or not residue <= 1e-4:
                raise AssertionError("float wire transcript audit failed")
            if n_bytes != want_bytes:
                raise AssertionError("float wire bytes differ from "
                                     "bytes_per_round")
    finally:
        for s in systems.values():
            s.stop()
    # beside it: the in-process classifier's round, loop engine, float
    cls = _build_slice("easter", "cuda", engine="loop")
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = cls.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    ms = []
    for i in range(10):
        xs, y = _to(*batches[i], "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, _ = step(params, opt, xs, y,
                                 cls.masks(SLICE_BATCH, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res["in_process_loop_ms"] = statistics.median(ms[3:])
    res["seconds"] = time.perf_counter() - t_phase
    log("wire", f"in-process EasterClassifier, loop engine, float wire: "
                f"{res['in_process_loop_ms']:.3f} ms per round (masks + "
                f"train step, median of rounds 3-9) beside the wire's "
                f"{res['float']['ms']:.3f} (float) and "
                f"{res['int8']['ms']:.3f} (int8); phase took "
                f"{res['seconds']:.1f} s")
    return res


def phase_engines(batches, params0):
    """Table II masks and train step on each engine by the host clock, in
    turns vectorized, loop, loop, vectorized: 10 rounds a turn, median of
    rounds 3-9. Launches here are not part of the counted paths."""
    import torch
    from repro_torch import checkpoint
    data = [_to(*b, "cuda") for b in batches[:10]]
    turns = {"vectorized": [], "loop": []}
    for engine in ("vectorized", "loop", "loop", "vectorized"):
        cls = _build_slice("easter", "cuda", engine=engine)
        params = checkpoint.params_from_numpy(params0, "cuda")
        init_opt, step = cls.make_train_step("adam", 1e-3)
        opt = init_opt(params)
        mask_ms, step_ms = [], []
        for i in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks = cls.masks(SLICE_BATCH, i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt, _, _ = step(params, opt, *data[i], masks)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 3:
                mask_ms.append((t1 - t0) * 1e3)
                step_ms.append((t2 - t1) * 1e3)
        turns[engine].append((statistics.median(mask_ms),
                              statistics.median(step_ms)))
        log("engines", f"Table II, {engine} engine: masks "
                       f"{turns[engine][-1][0]:.3f} ms, train step "
                       f"{turns[engine][-1][1]:.3f} ms (median of rounds 3-9)")
    out = {e: {"masks_ms": min(t[0] for t in v),
               "step_ms": min(t[1] for t in v)} for e, v in turns.items()}
    vec, loop = out["vectorized"], out["loop"]
    log("engines", f"train step, better of two turns: vectorized "
                   f"{vec['step_ms']:.3f} ms, loop {loop['step_ms']:.3f} ms "
                   f"(ratio {vec['step_ms'] / loop['step_ms']:.3f}); masks: "
                   f"MaskEngine {vec['masks_ms']:.3f} ms, loop oracle "
                   f"{loop['masks_ms']:.3f} ms")
    return out


def phase_profile(batches, params0):
    """Where a slice round's time goes: host clock for masks vs the train
    step, and torch.profiler device time by kernel over 5 steady rounds.
    Launches here are not part of the counted slice and joint rounds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import checkpoint
    gpu = _build_slice("easter", "cuda")
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = gpu.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    data = [_to(*b, "cuda") for b in batches]
    mask_ms, step_ms = [], []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = gpu.masks(SLICE_BATCH, i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, _, _ = step(params, opt, *data[i], masks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 3:
            mask_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
    log("profile", f"host clock, median of rounds 3-9: masks "
                   f"{statistics.median(mask_ms):.3f} ms, train step "
                   f"{statistics.median(step_ms):.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10, 15):
            masks = gpu.masks(SLICE_BATCH, i)
            params, opt, _, _ = step(params, opt, *data[i], masks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    # kernels are the CUDA-side rows; the aten op rows repeat their time
    kern = [r for r in rows if r.device_type == DeviceType.CUDA]
    busy_ms = sum(r.self_device_time_total for r in kern) / 1e3
    launches = sum(r.count for r in kern)
    log("profile", f"5 rounds under torch.profiler: wall {wall_ms:.3f} ms, "
                   f"device busy {busy_ms:.3f} ms (idle share "
                   f"{1 - busy_ms / wall_ms:.3f}), {launches} kernels "
                   f"({launches / 5:.0f} a round)")
    ops = [r for r in rows if r.device_type != DeviceType.CUDA
           and r.self_device_time_total > 0]
    for r in sorted(ops, key=lambda r: -r.self_device_time_total)[:10]:
        log("profile", f"  {r.key[:40]:40s} calls {r.count:6d} device "
                       f"{r.self_device_time_total / 1e3:.3f} ms")


def _time_ms(fn, reps=25, inner=20):
    """Device time of one call: median over ``reps`` of the mean of
    ``inner`` back-to-back calls between two CUDA events. Each rep first
    queues a spin kernel (torch.cuda._sleep) so that the host has queued
    all ``inner`` calls before the card reaches the first event; then the
    events time the card, not the host's launch rate. A rep in which the
    card reached the first event before the host was done queueing is
    repeated with a longer spin."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, spin = [], 4_000_000
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        host_behind = a.query()
        b.synchronize()
        if host_behind:
            spin *= 2
            if spin > 1_000_000_000:
                raise RuntimeError("host cannot queue ahead of the card")
            continue
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _host_ms(fn, calls=200):
    """Host time to issue one call (Python wrapper + launch), by the host
    clock over ``calls`` calls that are not waited for; the card works
    behind the host meanwhile."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


# blind_agg_fwd / blind_agg_bwd timing shapes: (label, K, N, d, dtype of
# E_a and E_k, dtype of the masks, whether the backward is timed there).
# Table II and the many-party benchmark's unfused rounds aggregate float32;
# the serving rounds aggregate bfloat16 embeddings with float32 MaskEngine
# masks (core/easter_lm.py _aggregate), N the prompt at admission (here its
# longest, 2048) or the 4 lanes of a decode round. No counted path runs the
# backward at the serving shapes: a joint step over one 2048-token prompt
# would. The LM training step aggregates the same dtypes at N = 4 x 2048
# tokens, forward every step and backward in its joint step.
AGG_TIMING = (("slice", 3, 128, 128, "float32", "float32", True),
              ("many_party", 63, 128, 64, "float32", "float32", True),
              ("serve_prefill", 3, 2048, 128, "bfloat16", "float32", True),
              ("serve_decode", 3, 4, 128, "bfloat16", "float32", False),
              ("train", 3, 8192, 128, "bfloat16", "float32", True))


def _rotating(fn, sets, n):
    """A call of ``fn`` on the next of ``sets`` in turn, holding the last
    ``n`` outputs alive: each call reads inputs and writes an output block
    that the calls between have not touched, so with ``n`` calls' bytes
    above the L2 it runs from HBM, not from the L2."""
    state = {"i": 0, "keep": [None] * n}

    def call():
        i = state["i"] = (state["i"] + 1) % n
        state["keep"][i] = fn(*sets[i % len(sets)])
    return call


def phase_timing(outputs=None):
    """blind_agg_fwd and blind_agg_bwd, their plain versions and bounds at
    the AGG_TIMING shapes, beside the launch floor: the device time of one
    torch.cuda._sleep(0) in a back-to-back stream, timed the same way.
    Back to back on one input set, a shape's bytes stay in the 50 MB L2;
    where a call moves 1 MiB or more, both are also timed cold: calls in
    turn over input sets and kept outputs of twice the L2's bytes, the
    timing the HBM byte bound holds for. On a tree whose wrapper chooses
    party groups, the forward is also timed at each G it takes there.
    ``outputs``, a dict, gets each kernel's outputs at each shape."""
    import torch
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    floor = _time_ms(lambda: torch.cuda._sleep(0))
    log("timing", f"launch floor (torch.cuda._sleep(0) back to back): "
                  f"{floor:.4f} ms a launch")
    out = {"floor_ms": floor}
    rule = getattr(tba, "fwd_party_groups", None)
    for label, K, N, d, edt, mdt, with_bwd in AGG_TIMING:
        et, mt = getattr(torch, edt), getattr(torch, mdt)
        se, sm = torch.empty((), dtype=et).element_size(), \
            torch.empty((), dtype=mt).element_size()

        def inputs():
            return (torch.randn((N, d), generator=gen, device="cuda").to(et),
                    torch.randn((K, N, d), generator=gen,
                                device="cuda").to(et),
                    torch.randn((K, N, d), generator=gen,
                                device="cuda").to(mt),
                    torch.randn((N, d), generator=gen, device="cuda").to(et))
        sets = [inputs()]
        ea, ep, mk, g = sets[0]
        nd = N * d
        tag = f"{label} K={K} N={N} d={d} E {edt} masks {mdt}"
        row = {}
        cases = [("blind_agg_fwd",
                  lambda ea, ep, mk, g: tba.blind_agg_fwd(ea, ep, mk),
                  lambda ea, ep, mk, g: ref.reference_blind_agg(ea, ep, mk),
                  nd * (se + K * (se + sm) + se), (2 * K + 1) * nd)]
        if with_bwd:                          # mask cotangent not asked for
            cases.append((
                "blind_agg_bwd",
                lambda ea, ep, mk, g: tba.blind_agg_bwd(g, K, et, mt,
                                                        need_mk=False),
                lambda ea, ep, mk, g: ref.reference_blind_agg_bwd(
                    g, K, et, mt, need_mk=False),
                nd * (se + se + K * se), nd))
        cold_n = max(-(-2 * L2_BYTES // c[3]) for c in cases)
        if min(c[3] for c in cases) >= 2 ** 20:
            sets += [inputs() for _ in range(cold_n - 1)]
        for name, kern_f, plain_f, nbytes, nops in cases:
            def kern(f=kern_f):
                return f(ea, ep, mk, g)

            def plain(f=plain_f):
                return f(ea, ep, mk, g)
            # turns: plain, kernel, kernel, plain
            p1 = _time_ms(plain)
            k1 = _time_ms(kern)
            k2 = _time_ms(kern)
            p2 = _time_ms(plain)
            hk, hp = _host_ms(kern), _host_ms(plain)
            bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOPS) * 1e3
            ms = min(k1, k2)
            if outputs is not None:
                got = kern()
                got = got if isinstance(got, tuple) else (got,)
                outputs[f"{name} {label}"] = [t for t in got
                                              if t is not None]
            row[name] = {"ms": ms, "plain_ms": min(p1, p2),
                         "bound_ms": bound, "bytes": nbytes, "ops": nops,
                         "above_floor_ms": ms - floor, "host_ms": hk,
                         "plain_host_ms": hp}
            log("timing", f"{name} {tag}: kernel {k1:.4f}/{k2:.4f} ms "
                          f"({ms - floor:.4f} ms above the launch floor), "
                          f"plain {p1:.4f}/{p2:.4f} ms, bound {bound:.6f} ms "
                          f"({nbytes} B at 3.35 TB/s, data-sheet peak; bound "
                          f"by bytes), kernel at {ms / bound:.1f}x it; no "
                          f"single PyTorch call computes it (library_ms "
                          f"null); host time per call: kernel wrapper "
                          f"{hk:.4f} ms, plain {hp:.4f} ms")
            if len(sets) > 1:
                n = -(-2 * L2_BYTES // nbytes)
                p1 = _time_ms(_rotating(plain_f, sets, n))
                k1 = _time_ms(_rotating(kern_f, sets, n))
                k2 = _time_ms(_rotating(kern_f, sets, n))
                p2 = _time_ms(_rotating(plain_f, sets, n))
                cold = min(k1, k2)
                row[name].update(cold_ms=cold, cold_plain_ms=min(p1, p2),
                                 cold_calls=n)
                log("timing", f"{name} {tag} cold ({n} calls in turn over "
                              f"{len(sets)} input sets, {n * nbytes} B, "
                              f"twice the L2 or more): kernel {k1:.5f}/"
                              f"{k2:.5f} ms, plain {p1:.5f}/{p2:.5f} ms; "
                              f"kernel at {cold / bound:.2f}x the bound, "
                              f"{(cold - floor) / bound:.2f}x it less the "
                              f"launch floor")
        if label == "serve_prefill":
            log("timing", "blind_agg_bwd at serve_prefill is on no counted "
                          "path: a joint step over one 2048-token prompt "
                          "would launch it")
        if rule is not None:
            G = rule(nd, K)
            sweep = {}
            for G_try in sorted({1, 2, 3, 4, 8, 16, G}):
                if G_try <= min(K, tba.FWD_MAX_GROUPS):
                    sweep[G_try] = _time_ms(
                        lambda: tba.blind_agg_fwd(ea, ep, mk, groups=G_try))
            row["groups"] = G
            row["fwd_ms_by_groups"] = sweep
            log("timing", f"blind_agg_fwd {tag} by party groups G (ms): "
                          f"{ {k: round(v, 4) for k, v in sweep.items()} }; "
                          f"fwd_party_groups gives G = {G}")
        del sets
        out[label] = row
    return out


def prng_bound_ms(K, N, d):
    """(INT32 bound, FP32 bound) in ms: the least time for the K(K-1)/2
    pair evaluations per element that the function needs at the card's
    INT32 and FP32 lane rates."""
    pairs = K * (K - 1) // 2 * N * d
    lane_s = SMS * CLOCK_HZ
    return (pairs * PRNG_INT32_PER_PAIR / (INT32_PER_SM * lane_s) * 1e3,
            pairs * PRNG_FP32_PER_PAIR / (FP32_PER_SM * lane_s) * 1e3)


def _wall_ms(fn, reps=5):
    """Host clock around one call ending in synchronize, median of reps
    (for plain versions bound by the host)."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_timing_prng():
    """blind_agg_prng_fwd at (3, 128, 128), (63, 128, 64), (127, 128, 64)."""
    import torch
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.kernels import ref
    log("timing", f"blind_agg_prng_fwd bound: K(K-1)/2 pair evaluations "
                  f"per element, each {PRNG_INT32_PER_PAIR} INT32 operations "
                  f"at {INT32_PER_SM} lanes per SM a clock and "
                  f"{PRNG_FP32_PER_PAIR} FP32 at {FP32_PER_SM}, {SMS} SMs "
                  f"at {CLOCK_HZ / 1e9:g} GHz (data-sheet peak)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for K, N, d in ((3, 128, 128), (63, 128, 64), (127, 128, 64)):
        eng = _kernel_mask_engine(K)
        tabs = tba.device_tables(eng, "cuda")
        ea = torch.randn((N, d), generator=gen, device="cuda")
        ep = torch.randn((K, N, d), generator=gen, device="cuda")
        kern = lambda: tba.blind_agg_prng_fwd(ea, ep, *tabs, 11)
        plain = lambda: ref.reference_blind_agg_prng(ea, ep, eng, 11)
        unfused = lambda: tba.blind_agg_fwd(
            ea, ep, eng.masks((N, d), 11, "float", device="cuda"))
        # turns: plain, kernel, kernel, plain
        p1 = _wall_ms(plain)
        k1 = _time_ms(kern, reps=10)
        k2 = _time_ms(kern, reps=10)
        p2 = _wall_ms(plain)
        u = _wall_ms(unfused)
        hk = _host_ms(kern, calls=50)
        nbytes = (1 + K) * N * d * 4 + N * d * 4 + 3 * K * max(K - 1, 1) * 4
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        int_ms, fp_ms = prng_bound_ms(K, N, d)
        op_ms = max(int_ms, fp_ms)
        bound = max(byte_ms, op_ms)
        pairs = K * (K - 1) // 2 * N * d
        out[K] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                  "unfused_ms": u, "bound_ms": bound,
                  "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                  "host_ms": hk, "pair_evals": pairs}
        log("timing", f"blind_agg_prng_fwd K={K} N={N} d={d} float32: kernel "
                      f"{k1:.4f}/{k2:.4f} ms; plain version (MaskEngine on "
                      f"the card, host pair keys, reference_blind_agg; host "
                      f"clock) {p1:.3f}/{p2:.3f} ms; MaskEngine + "
                      f"blind_agg_fwd {u:.3f} ms; bound {bound:.5f} ms "
                      f"({pairs} pair evaluations: INT32 {int_ms:.5f} ms, "
                      f"FP32 {fp_ms:.5f} ms; bytes {byte_ms:.5f} ms), kernel "
                      f"at {min(k1, k2) / bound:.2f}x it; no single PyTorch "
                      f"call computes it (library_ms null); host time per "
                      f"kernel call {hk:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# the LM serving slice
# ---------------------------------------------------------------------------


def _flash_case(B, S, T, Hq, Hkv, hd, causal, window, dtype, gen):
    """(max abs error, within tolerance) of flash_attention_fwd against
    reference_attention on one case; tolerance as the reference sweep's:
    atol 3e-5 (float32) or 3e-2 (bfloat16), rtol 1e-2."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
    out = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = ref.reference_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    atol = 3e-5 if dtype == torch.float32 else 3e-2
    return float(err.max()), bool((err <= atol + 1e-2 * want.float().abs())
                                  .all())


def _flash_prefill_case(B, S, dtype, gen, heads=FLASH_PREFILL_HEADS,
                        window=0, T=None, causal=True):
    """One of the serving paths' attention shapes, by default a causal
    prefill (T = S) at qwen2.5-3b's heads (16/2/128) or another model's
    (recurrentgemma-9b's 16/1/256 with its window of 2048, ...), or
    non-causal with T keys (whisper's encoder and cross-attention): (max
    abs error against the plain version in the same dtype, the share of
    the bfloat16 kernel's bound (``flash_bound_used``) used against
    float32 attention on the same inputs, within tolerance).

    bfloat16 is held to that bound as well as the sweep's tolerance: at
    S = 1023 a row's output is only ~0.05, so the sweep's atol 3e-2 would
    pass a dropped 64-key tile, which moves a late row's elements by
    ~0.006-0.013, while 2^-8 A(q, k, |v|) is ~0.003 there. float32 keeps
    atol 3e-5 + rtol 1e-2."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    Hq, Hkv, hd = heads
    T = S if T is None else T
    q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
    out = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                  window=window).float()
    want = ref.reference_attention(q, k, v, causal=causal,
                                   window=window).float()
    used = flash_bound_used(out, q, k, v, causal, window)
    torch.cuda.synchronize()
    err = (out - want).abs()
    if dtype == torch.float32:
        ok = bool((err <= 3e-5 + 1e-2 * want.abs()).all())
    else:
        ok = bool((err <= 3e-2 + 1e-2 * want.abs()).all()) and used <= 1
    return float(err.max()), used, ok


def phase_flash():
    """flash_attention_fwd against its plain version on the card."""
    import torch
    from torch.func import vmap
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, S, S, Hq, Hkv, hd, c, w, dt)
             for S in FLASH_S + FLASH_RAGGED_S
             for Hq, Hkv, hd in FLASH_HEADS for c, w in FLASH_MASKS
             for dt in (f32, bf16)]
    cases += [(1, 50, 130, 4, 2, 64, c, w, f32) for c, w in FLASH_MASKS]
    cases += [(B, S, T, Hq, Hkv, hd, c, w, dt)
              for B, S, T, Hq, Hkv, hd, w in FLASH_EMPTY_ROWS
              for c in (True, False) for dt in (f32, bf16)]
    worst = {f32: 0.0, bf16: 0.0}
    failed = []
    for case in cases:
        err, ok = _flash_case(*case, gen)
        worst[case[-1]] = max(worst[case[-1]], err)
        if not ok:
            failed.append((case, err))
    # the serving paths' prefill shapes: the active party's (B = 1) and
    # the passive group's, folded into the batch axis (B = 3), at
    # qwen2.5-3b's, recurrentgemma-9b's, gemma3-4b's and qwen2-moe-a2.7b's
    # heads and windows; and a model rank's heads under the fsdp phase's
    # tensor-parallel prefills (at m = 2 and m = 4, and (h)'s and (i)'s)
    prefill_shapes = [(heads, window, B, S) for _, heads, window
                      in FLASH_MODELS for B, S in FLASH_PREFILL] + [
        (FLASH_TP_HEADS, 0, B, S) for B, S in FLASH_TP] + [
        (heads, window, B, S) for heads, window in FLASH_TP_SPLIT
        for B, S in FLASH_TP_SPLIT_BS] + [
        (heads, 0, B, S) for heads, S in FLASH_TP_CAUSAL
        for B in FLASH_TP_CAUSAL_B]
    for heads, window, B, S in prefill_shapes:
        for dt in (f32, bf16):
            err, used, ok = _flash_prefill_case(B, S, dt, gen, heads,
                                                window)
            worst[dt] = max(worst[dt], err)
            tol = "atol 3e-5, rtol 1e-2" if dt == f32 else (
                "atol 3e-2, rtol 1e-2, and the bound ulp_bf16(exact) "
                "+ 2^-8 A(q, k, |v|) + 1e-5 of float32 attention on "
                "the same inputs")
            log("flash", f"prefill shape ({B}, {S}, "
                         f"{'/'.join(map(str, heads))}) causal"
                         f"{f' window {window}' if window else ''} "
                         f"{str(dt)[6:]}: max abs err {err:.3g} against "
                         f"the plain version; {used:.3g} of the "
                         f"bfloat16 bound from float32 attention at "
                         f"worst; tolerance {tol}: "
                         f"{'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(((B, S, S, *heads, True, window, dt),
                               (err, used)))
    # the frontend families' shapes: whisper's non-causal encoder over
    # 1500 frames and its cross-attention (S = 3 and 1 against T = 1500),
    # qwen2-vl's causal prefills at 28/4 heads (a GQA group of 7)
    for B, S, T, heads, causal in FLASH_FRONTEND:
        for dt in (f32, bf16):
            err, used, ok = _flash_prefill_case(B, S, dt, gen, heads, 0, T,
                                                causal)
            worst[dt] = max(worst[dt], err)
            log("flash", f"frontend shape ({B}, {S}, "
                         f"{'/'.join(map(str, heads))}) against T = {T}, "
                         f"{'causal' if causal else 'non-causal'} "
                         f"{str(dt)[6:]}: max abs err {err:.3g}; {used:.3g} "
                         f"of the bfloat16 bound at worst: "
                         f"{'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(((B, S, T, *heads, causal, 0, dt),
                               (err, used)))
    if failed:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain "
                             f"version in {len(failed)} cases: {failed[:5]}")
    # the grouped passive parties: torch.func.vmap folds the party axis
    # into the batch axis around one launch
    q = torch.randn((3, 2, 100, 4, 64), generator=gen, device="cuda")
    k = torch.randn((3, 2, 100, 2, 64), generator=gen, device="cuda")
    v = torch.randn((3, 2, 100, 2, 64), generator=gen, device="cuda")
    before = tfa.LAUNCHES["flash_attention_fwd"]
    with torch.no_grad():
        out = vmap(lambda a, b, c: tfa.flash_attention(a, b, c))(q, k, v)
    want = torch.stack([ref.reference_attention(q[i], k[i], v[i])
                        for i in range(3)])
    vm_err = float((out - want).abs().max())
    if tfa.LAUNCHES["flash_attention_fwd"] != before + 1 or vm_err > 3e-5:
        raise AssertionError(f"vmap over the kernel: err {vm_err}, "
                             f"{tfa.LAUNCHES['flash_attention_fwd'] - before}"
                             f" launches")
    n_cases = (len(cases) + 2 * len(prefill_shapes)
               + 2 * len(FLASH_FRONTEND))
    log("flash", f"{n_cases} cases within "
                 f"tolerance (atol 3e-5 float32 / 3e-2 bfloat16, rtol "
                 f"1e-2): S in {FLASH_S} and ragged {FLASH_RAGGED_S} (T = "
                 f"S) x (Hq, Hkv, hd) in {FLASH_HEADS} x (causal, window) "
                 f"in {FLASH_MASKS} x float32/bfloat16, S=50 T=130, "
                 f"(B, S, T, Hq, Hkv, hd, window) in {FLASH_EMPTY_ROWS} "
                 f"causal and not x float32/bfloat16 (rows from T + "
                 f"window - 1 on see no key: the mean of v), and "
                 f"the prefill shapes (B, S) in {FLASH_PREFILL} at "
                 f"16/2/128 causal, 16/1/256 causal window {RG_WINDOW}, "
                 f"8/4/256 causal window {GEMMA_WINDOW} and 16/16/128 "
                 f"causal, a model rank's 8/1/128 causal at (B, S) in "
                 f"{FLASH_TP} and its (heads, window) in {FLASH_TP_SPLIT} "
                 f"at (B, S) in {FLASH_TP_SPLIT_BS}, its (heads, S) in "
                 f"{FLASH_TP_CAUSAL} causal at B in {FLASH_TP_CAUSAL_B} x "
                 f"float32/bfloat16, the frontend families' "
                 f"(B, S, T, heads, causal) in {FLASH_FRONTEND} x "
                 f"float32/bfloat16; worst "
                 f"float32 {worst[f32]:.3g}, bfloat16 {worst[bf16]:.3g}; "
                 f"vmap over 3 parties: one launch, max abs err "
                 f"{vm_err:.3g}")
    return worst[f32]


def _rglru_inputs(B, L, W, dtype, gen, decay=False):
    """a in (0, 1), b ~ 0.1 N(0, 1), h0 ~ N(0, 1) on the card (a = 0.99,
    b = 0.01, h0 = 0 for the decay case); a and b in ``dtype``."""
    import torch
    if decay:
        a = torch.full((B, L, W), 0.99, device="cuda")
        b = torch.full((B, L, W), 0.01, device="cuda")
        h0 = torch.zeros((B, W), device="cuda")
    else:
        a = torch.sigmoid(torch.randn((B, L, W), generator=gen,
                                      device="cuda"))
        b = torch.randn((B, L, W), generator=gen, device="cuda") * 0.1
        h0 = torch.randn((B, W), generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype), h0


def _rglru_case(B, L, W, dtype, gen, decay=False):
    """(max abs error, elements not bit-identical, within tolerance, the
    kernel path it took) of rglru_scan_fwd against reference_rglru on the
    same inputs. Tolerance rtol 1e-6 / atol 1e-6: both compute a float32
    multiply, then an add, each rounded, so bit-identical results are
    expected."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru as trg
    a, b, h0 = _rglru_inputs(B, L, W, dtype, gen, decay)
    before = dict(trg.PATH_LAUNCHES)
    h, last = trg.rglru_scan_fwd(a, b, h0)
    wh, wl = ref.reference_rglru(a, b, h0)
    torch.cuda.synchronize()
    path = [p for p, n in trg.PATH_LAUNCHES.items() if n != before[p]]
    err = float(torch.cat([(h - wh).flatten(), (last - wl).flatten()])
                .abs().max())
    diff = int((h != wh).sum()) + int((last != wl).sum())
    ok = all(bool(((x - y).abs() <= 1e-6 + 1e-6 * y.abs()).all())
             for x, y in ((h, wh), (last, wl)))
    return err, diff, ok, "/".join(path)


def phase_rglru():
    """rglru_scan_fwd against its plain version on the card."""
    import torch
    from torch.func import vmap
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rg_lru as trg
    gen = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = RGLRU_SWEEP + RGLRU_RAGGED + RGLRU_SERVE + RGLRU_PER_COLUMN
    cases = [(B, L, W, dt, False) for B, L, W in shapes
             for dt in (f32, bf16)]
    cases += [(1, 512, 64, dt, True) for dt in (f32, bf16)]
    worst, diffs, failed, paths = 0.0, 0, [], {}
    for B, L, W, dt, decay in cases:
        err, diff, ok, path = _rglru_case(B, L, W, dt, gen, decay)
        worst, diffs = max(worst, err), diffs + diff
        paths[path] = paths.get(path, 0) + 1
        # the path is chosen by shape: TMA wherever it takes the rows
        want = "per_column" if (B, L, W) in RGLRU_PER_COLUMN or (
            dt == bf16 and W % 8) else "tma"
        if (B, L, W) in RGLRU_SERVE or decay:
            log("rglru", f"({B}, {L}, {W}) {str(dt)[6:]}"
                         f"{' decay a=0.99 b=0.01' if decay else ''}: max "
                         f"abs err {err:.3g}, {diff} elements not "
                         f"bit-identical, {path} path: "
                         f"{'ok' if ok and path == want else 'FAILED'}")
        if not ok or path != want:
            failed.append(((B, L, W, str(dt), decay), err, path))
    if failed:
        raise AssertionError(f"rglru_scan_fwd disagrees with its plain "
                             f"version or took the wrong path in "
                             f"{len(failed)} cases: {failed[:5]}")
    # the grouped passive parties: torch.func.vmap folds the party axis
    # into the batch axis around one launch
    a, b, h0 = _rglru_inputs(3, 511, 4096, f32, gen)
    before = trg.LAUNCHES["rglru_scan_fwd"]
    with torch.no_grad():
        h, last = vmap(lambda x, y, z: ops.rglru_scan(x, y, z))(
            a[:, None], b[:, None], h0[:, None])
    wh, wl = ref.reference_rglru(a, b, h0)
    vm_err = max(float((h[:, 0] - wh).abs().max()),
                 float((last[:, 0] - wl).abs().max()))
    if trg.LAUNCHES["rglru_scan_fwd"] != before + 1 or vm_err > 1e-6:
        raise AssertionError(f"vmap over the kernel: err {vm_err}, "
                             f"{trg.LAUNCHES['rglru_scan_fwd'] - before} "
                             f"launches")
    log("rglru", f"{len(cases)} cases within tolerance (rtol 1e-6, atol "
                 f"1e-6; both round a float32 multiply, then an add): the "
                 f"reference sweep {RGLRU_SWEEP}, ragged {RGLRU_RAGGED}, the "
                 f"serving shapes {RGLRU_SERVE}, the per-column shapes "
                 f"{RGLRU_PER_COLUMN} x float32/bfloat16 a and b from a "
                 f"non-zero h0, and the 512-step decay case; worst "
                 f"{worst:.3g}, {diffs} elements not bit-identical in all; "
                 f"cases by kernel path {paths}; vmap over 3 parties at "
                 f"(1, 511, 4096): one launch, max abs err {vm_err:.3g}")
    return worst


def phase_timing_rglru():
    """rglru_scan_fwd and its plain version at the serving path's largest
    prefill shapes, float32, beside the bytes bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru as trg
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for B, L, W in RGLRU_TIMING:
        a, b, h0 = _rglru_inputs(B, L, W, torch.float32, gen)
        kern = lambda: trg.rglru_scan_fwd(a, b, h0)
        plain = lambda: ref.reference_rglru(a, b, h0)
        # turns: plain, kernel, kernel, plain; the plain version is a
        # Python loop of 2 L launches, bound by the host: host clock
        p1 = _wall_ms(plain)
        k1 = _time_ms(kern, reps=10, inner=5)
        k2 = _time_ms(kern, reps=10, inner=5)
        p2 = _wall_ms(plain)
        (h, last), (wh, wl) = kern(), plain()
        diff = int((h != wh).sum()) + int((last != wl).sum())
        nbytes = 3 * B * L * W * 4 + 2 * B * W * 4
        ops_ = 2 * B * L * W
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops_ / FP32_FLOPS * 1e3
        bound = max(byte_ms, op_ms)
        key = B if W == 4096 else f"{B}x{L}x{W}"
        out[key] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                  "bound_ms": bound,
                  "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                  "bytes": nbytes, "ops": ops_,
                  "gb_per_s": nbytes / (min(k1, k2) * 1e-3) / 1e9,
                  "path": trg.kernel_path(a, b),
                  "not_bit_identical": diff}
        log("timing", f"rglru_scan_fwd ({B}, {L}, {W}) float32: kernel "
                      f"{k1:.4f}/{k2:.4f} ms, plain (host clock) "
                      f"{p1:.3f}/{p2:.3f} ms; bound {bound:.5f} ms ({nbytes} "
                      f"B at 3.35 TB/s, data-sheet peak; bound by bytes; "
                      f"{ops_} FP32 operations {op_ms:.5f} ms), kernel at "
                      f"{min(k1, k2) / bound:.2f}x it "
                      f"({out[key]['gb_per_s']:.0f} GB/s, the "
                      f"{out[key]['path']} path); {diff} elements "
                      f"not bit for bit the plain version's; no single "
                      f"PyTorch call computes it (library_ms null)")
        if diff:
            raise AssertionError(f"rglru_scan_fwd at ({B}, {L}, {W}): {diff} "
                                 f"elements differ from the plain version")
        if out[key]["path"] != "tma":
            raise AssertionError(f"rglru_scan_fwd at ({B}, {L}, {W}): the "
                                 f"{out[key]['path']} path, not the TMA one")
    return out


def _lm_system(cfg, device, num_passive=None):
    from repro_torch.configs.base import EasterConfig
    from repro_torch.core.easter_lm import EasterLM
    easter = (EasterConfig() if num_passive is None
              else EasterConfig(num_passive=num_passive))
    return EasterLM(cfg, easter, device=device)


def _lm_requests(vocab):
    """8 greedy requests, prompts of 512/1024/2048 tokens from numpy seed
    0, 32 new tokens each, no EOS."""
    import numpy as np
    from repro_torch.core import api
    rng = np.random.default_rng(0)
    return [api.ServeRequest(
        tokens=tuple(rng.integers(0, vocab, size=LM_PROMPTS[i % 3])
                     .tolist()), max_new_tokens=LM_NEW)
        for i in range(LM_REQUESTS)]


def _layer_kinds(cfg):
    """(attention layers, RG-LRU layers) of one party's stack: every kind
    but the RG-LRU and SSD blocks attends (an MoE block is attention,
    then the experts)."""
    from repro_torch.models import transformer
    kinds = [k for ks, reps in transformer.stack_plan(cfg) for k in ks * reps]
    return (sum(k not in ("lru", "ssm") for k in kinds),
            sum(k == "lru" for k in kinds))


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _profile_window(tag, label, fn, n_rounds, by_op=False):
    """Device busy time and idle share of ``fn`` under torch.profiler, and
    its top kernels by device time. ``by_op`` also prints the top PyTorch
    ops by the device time of the kernels each launched itself."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    kern = [r for r in rows if r.device_type == DeviceType.CUDA]
    busy_ms = sum(r.self_device_time_total for r in kern) / 1e3
    n = sum(r.count for r in kern)
    idle = 1 - busy_ms / wall_ms
    log(tag, f"{label} under torch.profiler: wall {wall_ms:.3f} ms, device "
             f"busy {busy_ms:.3f} ms (idle share {idle:.3f}), {n} kernels "
             f"({n / n_rounds:.0f} a round)")
    top = []
    for r in sorted(kern, key=lambda r: -r.self_device_time_total)[:8]:
        ms = r.self_device_time_total / 1e3
        top.append((r.key[:60], r.count, ms))
        log(tag, f"  {r.key[:60]:60s} calls {r.count:5d} device "
                 f"{ms:.3f} ms ({ms / busy_ms:.1%})")
    res = {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle,
           "kernels": n, "top": top}
    if by_op:
        ops_ = [r for r in rows if r.device_type == DeviceType.CPU
                and r.self_device_time_total > 0]
        res["top_ops"] = []
        for r in sorted(ops_, key=lambda r: -r.self_device_time_total)[:10]:
            ms = r.self_device_time_total / 1e3
            res["top_ops"].append((r.key, r.count, ms))
            log(tag, f"  op {r.key[:40]:40s} calls {r.count:6d} device "
                     f"{ms:.3f} ms ({ms / busy_ms:.1%})")
    return res


def _reset_lm_launches():
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import rg_lru as trg
    tba.reset_launches()
    tfa.reset_launches()
    trg.reset_launches()


def _lm_launches():
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import rg_lru as trg
    return {**_agg_launches(), **tfa.LAUNCHES, **trg.LAUNCHES}


COPY_OPS = ("aten::clone", "aten::copy_", "aten::contiguous",
            "aten::_reshape_copy")


def _table_copies(tag, sys_, params, fe_list=None):
    """The copy ops (``COPY_OPS``) that read a tensor the size of the
    stacked passive embedding tables, in a 16-token prefill and one decode
    round, from a torch.profiler window that records shapes (kept apart
    from the timed windows, whose host time shapes would inflate). With an
    encoder-decoder's ``fe_list`` (``encoder_kv``, B lanes) the prefill
    and the round are B lanes wide and also count copies reading as many
    elements as one layer's cross K of the passive group (K x B x 1500 x
    Hkv x hd): the group's cross K/V is read in place, never restacked."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    limits = {"tables": params["passive_stacked"]["backbone"]["embed"][
        "table"].numel()}
    B = 1
    if fe_list is not None:
        k0 = fe_list[1]["enc_kv"][0]                  # (L, B, F, Hkv, hd)
        B = k0.shape[1]
        limits["cross K/V"] = (len(fe_list) - 1) * k0[0].numel()
    seeds = sys_.mask_seeds()
    tok = torch.arange(17, dtype=torch.int32, device="cuda")[None].expand(
        B, 17).contiguous()
    out = {}
    for what in ("prefill", "decode"):
        caches = sys_.init_caches(B, 32)
        if what == "decode":
            _, caches = sys_.prefill(params, tok[:, :16], caches,
                                     seeds=seeds, round_idx=7,
                                     fe_list=fe_list)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            if what == "prefill":
                sys_.prefill(params, tok[:, :16], caches, seeds=seeds,
                             round_idx=7, fe_list=fe_list)
            else:
                sys_.serve_step(params, tok[:, 16:], caches, 16, seeds,
                                fe_list=fe_list)
            torch.cuda.synchronize()
        for name, numel in limits.items():
            copies = [(e.name, e.input_shapes) for e in prof.events()
                      if e.name in COPY_OPS and any(
                          math.prod(sh) >= numel
                          for sh in e.input_shapes if sh)]
            out[what if name == "tables" else f"{what} {name}"] = \
                len(copies)
            log(tag, f"copy ops reading >= {numel} elements (the stacked "
                     f"passive {'embedding tables' if name == 'tables' else 'cross K of one layer'}) "
                     f"in a 16-token {what}"
                     f"{'' if what == 'prefill' else ' round'}: "
                     f"{len(copies)} {copies[:2]}")
    return out


def _serve_phase(tag, arch):
    """EasterLM on ``arch`` at full width and depth, bfloat16, served by a
    4-lane ServingEngine on the card; a counted main path."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import api, serving
    from repro_torch.kernels import rg_lru as trg
    cfg = get_config(arch)
    sys_, params, _, drawn = _draw_on_card(tag, cfg)
    cfgs = sys_.party_cfgs
    (attn_a, lru_a), (attn_p, lru_p) = _layer_kinds(cfgs[0]), \
        _layer_kinds(cfgs[1])
    eng = serving.ServingEngine(sys_, params, lanes=LM_LANES,
                                max_len=max(LM_PROMPTS) + LM_NEW,
                                chunk=LM_CHUNK)
    prefill_ms, decode = [], []
    prefill, decode_fn = eng._prefill, eng._decode

    def timed_prefill(params_, state, req, lane, *, nonce=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = prefill(params_, state, req, lane, nonce=nonce)
        torch.cuda.synchronize()
        prefill_ms.append((len(req.tokens), (time.perf_counter() - t) * 1e3))
        return state

    def timed_decode(params_, state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_fn(params_, state)
        torch.cuda.synchronize()
        decode.append(((time.perf_counter() - t) * 1e3, out[2]))
        return out

    eng._prefill, eng._decode = timed_prefill, timed_decode
    reqs = _lm_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_launches()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _lm_launches()
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # every prefill: one flash launch per attention layer and one
    # rglru_scan_fwd per RG-LRU layer of the active party and of one
    # passive proxy (the passive party axis folded into the batch around
    # one launch); one blind_agg_fwd per protocol round (a prefill or a
    # decode round); decode runs neither prompt kernel
    want = {"flash_attention_fwd": LM_REQUESTS * (attn_a + attn_p),
            "rglru_scan_fwd": LM_REQUESTS * (lru_a + lru_p),
            "blind_agg_fwd": LM_REQUESTS + eng.rounds_run}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"serving path, expected {n}")
    # by kernel path (None where the kernel has one path: another
    # checkout's tree, timed in turns with --phase rg)
    paths = getattr(trg, "PATH_LAUNCHES", None)
    paths = dict(paths) if paths is not None else None
    toks = sum(len(c.tokens) for c in comps)
    bad = [c for c in comps if len(c.tokens) != LM_NEW
           or not all(0 <= t < cfg.vocab_size for t in c.tokens)]
    if len(comps) != LM_REQUESTS or bad:
        raise AssertionError(f"{len(comps)} completions, bad: {bad[:2]}")
    per_len = {P: statistics.median(ms for n, ms in prefill_ms if n == P)
               for P in LM_PROMPTS}
    rounds = sum(s for _, s in decode)
    ms_round = sum(ms for ms, _ in decode) / rounds
    log(tag, f"served {len(comps)} requests ({LM_PROMPTS} prompt tokens, "
             f"{LM_NEW} new each, greedy) on {LM_LANES} lanes in {wall:.2f} "
             f"s: {toks} tokens, {toks / wall:.1f} tokens/s end to end; "
             f"{eng.rounds_run} decode rounds in {eng.chunks_run} chunks, "
             f"{ms_round:.2f} ms a round ({LM_LANES * 1e3 / ms_round:.1f} "
             f"tokens/s at {LM_LANES} full lanes); prefill ms per request "
             f"(median by prompt length, first calls included) "
             f"{ {P: round(v, 2) for P, v in per_len.items()} }; peak "
             f"device memory while serving {serve_peak_gb:.2f} GB")
    log(tag, f"launches on the serving path {launches} (expected "
             f"flash_attention_fwd {LM_REQUESTS} x ({attn_a} + {attn_p}), "
             f"rglru_scan_fwd {LM_REQUESTS} x ({lru_a} + {lru_p}), "
             f"blind_agg_fwd {LM_REQUESTS} prefills + {eng.rounds_run} "
             f"rounds); rglru_scan_fwd by path {paths}")
    # the output is finite and of the expected shape at full size
    seeds = sys_.mask_seeds()
    c1 = sys_.init_caches(1, 64)
    tok = torch.tensor([reqs[0].tokens[:9]], dtype=torch.int32,
                       device="cuda")
    _, c1 = sys_.prefill(params, tok[:, :8], c1, seeds=seeds, round_idx=999)
    logits, _ = sys_.serve_step(params, tok[:, 8:], c1, 8, seeds)
    if tuple(logits.shape) != (1, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    # where the time goes: one 2048-token prefill and PROFILE_ROUNDS decode
    # rounds at 4 full lanes, under the profiler (not part of the counted
    # path)
    dcfg = api.DecodeConfig(lanes=LM_LANES, max_len=max(LM_PROMPTS) + LM_NEW,
                            chunk=PROFILE_ROUNDS)
    pf, df = api.build_decoder(sys_, dcfg)
    state = api.init_decode_state(sys_, dcfg)
    for lane in range(LM_LANES - 1):
        state = pf(params, state, reqs[lane], lane, nonce=100 + lane)
    box = {}
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    prof_prefill = _profile_window(
        tag, f"one admission of a {LM_PROMPTS[-1]}-token prompt",
        lambda: box.update(state=pf(params, state, reqs[2], LM_LANES - 1,
                                    nonce=200)), 1, by_op=True)
    admit_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(tag, f"peak device memory during one admission of a "
             f"{LM_PROMPTS[-1]}-token prompt (a {LM_PROMPTS[-1] - 1}-token "
             f"prefill) at {LM_LANES - 1} busy lanes: {admit_peak_gb:.2f} GB "
             f"({before_gb:.2f} GB before it, "
             f"+{admit_peak_gb - before_gb:.2f} GB)")
    prof_decode = _profile_window(
        tag, f"{PROFILE_ROUNDS} decode rounds at {LM_LANES} lanes",
        lambda: box.update(out=df(params, box["state"])), PROFILE_ROUNDS,
        by_op=True)
    return launches, {
        **drawn, "wall_s": wall,
        "serve_peak_gb": serve_peak_gb, "admit_peak_gb": admit_peak_gb,
        "admit_before_gb": before_gb,
        "tokens_per_s": toks / wall, "ms_per_round": ms_round,
        "rounds": eng.rounds_run, "prefill_ms": per_len,
        "profile_prefill": prof_prefill, "profile_decode": prof_decode,
        "rglru_paths": paths,
        "table_copies": _table_copies(tag, sys_, params)}


def phase_moe_or_mamba(tag):
    """The MoE (``moe``: qwen2-moe-a2.7b) or Mamba-2 (``mamba``:
    mamba2-2.7b) family at full width and depth in bfloat16, served as in
    lm; a counted main path. Asserted beside _serve_phase's counts: 24 + 6
    flash_attention_fwd launches a prefill for qwen2-moe (its 24 active
    and 6 passive attention layers, the passive group folded into one
    launch a layer), none for the attention-free mamba2, and no
    rglru_scan_fwd."""
    arch = {"moe": MOE_ARCH, "mamba": MAMBA_ARCH}[tag]
    launches, res = _serve_phase(tag, arch)
    per_prefill = {"moe": 24 + 6, "mamba": 0}[tag]
    if launches["flash_attention_fwd"] != LM_REQUESTS * per_prefill or \
            launches["rglru_scan_fwd"]:
        raise AssertionError(f"{arch}: launches {launches}, expected "
                             f"{per_prefill} flash_attention_fwd a "
                             f"prefill and no rglru_scan_fwd")
    _free_card()
    res["layer_ms"] = (_moe_layer_split if tag == "moe"
                       else _ssd_layer_split)(arch)
    return launches, res


def _draw_on_card(tag, cfg):
    """EasterLM on ``cfg`` in bfloat16, drawn on the card from a
    torch.Generator seeded 0; logs the shape and the memory of the draw.
    Returns (system, params, generator, facts)."""
    import torch
    from repro_torch.models.transformer import stack_plan
    from repro_torch.tree import tree_leaves
    sys_ = _lm_system(cfg, "cuda")
    _free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = sys_.init_params(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    draw_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sys_._passive_stack(params)       # raises if a step would restack
    n_act = sum(t.numel() for t in tree_leaves(params["parties"][0]))
    n_all = sum(t.numel() for p in params["parties"]
                for t in tree_leaves(p))
    c0, c1 = sys_.party_cfgs[:2]
    attn, lru = _layer_kinds(c0)
    extra = {"moe": f", moe {cfg.moe}", "ssm": f", ssm {cfg.ssm}",
             "encdec": f" + {c0.n_encoder_layers} encoder layers over "
                       f"{c0.n_audio_frames} frames"}.get(cfg.family, "")
    log(tag, f"{cfg.name} ({cfg.family}): {c0.n_layers} layers ({attn} "
             f"attention, {lru} RG-LRU; stack plan "
             f"{[(ks[0], len(ks), r) for ks, r in stack_plan(c0)]}){extra}"
             f", d_model {cfg.d_model}, heads {cfg.n_heads}/"
             f"{cfg.n_kv_heads}x{cfg.resolved_head_dim}, d_ff {cfg.d_ff} "
             f"({cfg.act}, {cfg.norm} norm, QKV bias {cfg.qkv_bias}), vocab "
             f"{cfg.vocab_size}, {cfg.dtype}; C = {sys_.C} ({sys_.C - 1} "
             f"passive proxies of {c1.n_layers} layers"
             f"{f' and {c1.n_encoder_layers} encoder layers' if cfg.family == 'encdec' else ''}"
             f"), d_embed {sys_.easter.d_embed}, {sys_.easter.mask_mode} "
             f"wire, {sys_.engine} engine; {n_act / 1e9:.3f}e9 active and "
             f"{n_all / 1e9:.3f}e9 parameters in all, drawn on the card in "
             f"{init_s:.1f} s; device memory {weights_gb:.2f} GB after the "
             f"draw, peak {draw_peak_gb:.2f} GB during it")
    return sys_, params, gen, {"init_s": init_s, "params": n_all,
                               "active_params": n_act,
                               "weights_gb": weights_gb,
                               "draw_peak_gb": draw_peak_gb}


def _check_tokens(out, logits, B, n, vocab):
    import torch
    if tuple(out.shape) != (B, n) or not bool(
            ((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"tokens {tuple(out.shape)}, expected "
                             f"{(B, n)} in [0, {vocab})")
    if tuple(logits.shape) != (B, n, vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")


def _check_launches(what, launches, want):
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


def phase_whisper():
    """whisper-small at full width and depth in bfloat16, a counted main
    path: 4 transcriptions of 30 s of audio (frame embeddings (4, 1500,
    768) from the card's generator, a 4-token start prompt from numpy
    seed 0): ``encoder_kv`` once, a prefill of the first 3 tokens, then
    ``serve_tokens`` for 64 greedy tokens, every round given the cross
    K/V. Asserted: one flash_attention_fwd per encoder layer of the
    active party and of the passive group (folded into one launch) in
    encoder_kv, one per self- and one per cross-attention layer of both
    in the prefill and in every decode round (the decode rounds'
    cross-attention included), one blind_agg_fwd per protocol round, no
    rglru_scan_fwd. Then profiler windows and the copy check (no restack
    of the passive cross K/V)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import decode
    from repro_torch.models.build import frontend_inputs
    cfg = get_config(WHISPER_ARCH)
    sys_, params, gen, res = _draw_on_card("whisper", cfg)
    c0, c1 = sys_.party_cfgs[:2]
    B, P, N = WHISPER_LANES, WHISPER_PROMPT, WHISPER_NEW
    audio = frontend_inputs(cfg, B, gen)["audio_embed"]
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)).to("cuda")
    seeds = sys_.mask_seeds()
    caches = sys_.init_caches(B, P + N)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_launches()
    t0 = time.perf_counter()
    fe_list = sys_.encoder_kv(params, audio)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    enc_launches = _lm_launches()
    _, caches = sys_.prefill(params, prompt[:, :-1], caches,
                             fe_list=fe_list, seeds=seeds, round_idx=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out, caches, _, _, logits = decode.serve_tokens(
        sys_, params, prompt[:, -1:], caches, P - 1, N, seeds,
        fe_list=fe_list, return_logits=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _lm_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    enc = c0.n_encoder_layers + c1.n_encoder_layers
    per_round = c0.n_layers + c1.n_layers
    _check_launches("whisper-small encoder_kv", enc_launches,
                    {"flash_attention_fwd": enc, "blind_agg_fwd": 0})
    _check_launches("whisper-small serving", launches, {
        "flash_attention_fwd": enc + 2 * per_round + N * per_round,
        "blind_agg_fwd": 1 + N, "rglru_scan_fwd": 0})
    _check_tokens(out, logits, B, N, cfg.vocab_size)
    enc_ms, prefill_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    ms_round = (t3 - t2) * 1e3 / N
    # the same encoder_kv and prefill again, warm (the first calls above
    # include the libraries' first-use setup)
    t = time.perf_counter()
    fe_warm = sys_.encoder_kv(params, audio)
    torch.cuda.synchronize()
    warm_enc_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    sys_.prefill(params, prompt[:, :-1], sys_.init_caches(B, P + N),
                 fe_list=fe_warm, seeds=seeds, round_idx=1)
    torch.cuda.synchronize()
    warm_prefill_ms = (time.perf_counter() - t) * 1e3
    del fe_warm
    log("whisper", f"{B} transcriptions of {FRAMES} frames, a {P}-token "
                   f"start prompt, {N} greedy tokens each: encoder_kv "
                   f"{enc_ms:.2f} ms, prefill {prefill_ms:.2f} ms (first "
                   f"calls; warm {warm_enc_ms:.2f} and {warm_prefill_ms:.2f}"
                   f" ms), {ms_round:.2f} ms a decode round "
                   f"({B * 1e3 / ms_round:.1f} tokens/s at {B} lanes), "
                   f"{B * N / (t3 - t0):.1f} tokens/s end to end; peak "
                   f"device memory {peak_gb:.2f} GB; launches {launches} "
                   f"(expected flash_attention_fwd {enc} + 2 x {per_round} "
                   f"+ {N} x {per_round}, blind_agg_fwd 1 + {N})")
    box = {}
    prof_enc = _profile_window(
        "whisper", f"encoder_kv + a {P - 1}-token prefill at {B} lanes",
        lambda: box.update(r=sys_.prefill(
            params, prompt[:, :-1], sys_.init_caches(B, P + N),
            fe_list=sys_.encoder_kv(params, audio), seeds=seeds,
            round_idx=1)), 1, by_op=True)
    prof_decode = _profile_window(
        "whisper", f"{PROFILE_ROUNDS} decode rounds at {B} lanes",
        lambda: box.update(d=decode.serve_tokens(
            sys_, params, prompt[:, -1:], box["r"][1], P - 1,
            PROFILE_ROUNDS, seeds, fe_list=fe_list)), PROFILE_ROUNDS,
        by_op=True)
    res.update({"encoder_kv_ms": enc_ms, "prefill_ms": prefill_ms,
                "warm_encoder_kv_ms": warm_enc_ms,
                "warm_prefill_ms": warm_prefill_ms,
                "ms_per_round": ms_round, "rounds": N,
                "tokens_per_s": B * N / (t3 - t0),
                "decode_tokens_per_s": B * 1e3 / ms_round,
                "serve_peak_gb": peak_gb, "profile_prefill": prof_enc,
                "profile_decode": prof_decode,
                "table_copies": _table_copies("whisper", sys_, params,
                                              fe_list)})
    return launches, res


def phase_vlm():
    """qwen2-vl-7b at full width and depth in bfloat16, a counted main
    path: 4 lanes of 2048-token prompts (numpy seed 0) whose first 1024
    positions carry an image's patch embeddings (from the card's
    generator), then one request of 1280 tokens, 32 greedy tokens each,
    through prefill(fe_list) and serve_tokens. Asserted: 28 + 7
    flash_attention_fwd launches a prefill (the passive group folded),
    none in a decode round, one blind_agg_fwd per protocol round, no
    rglru_scan_fwd; and that the patches went in: the 1280-token
    prefill's embeddings over the first 1024 positions move when other
    patches are given."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import decode
    from repro_torch.models.build import frontend_inputs
    cfg = get_config(VLM_ARCH)
    sys_, params, gen, res = _draw_on_card("vlm", cfg)
    c0, c1 = sys_.party_cfgs[:2]
    rng = np.random.default_rng(0)
    reqs = [(VLM_LANES, VLM_PROMPTS[0]), (1, VLM_PROMPTS[1])]
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                                .astype(np.int32)).to("cuda") for B, P in reqs]
    images = [frontend_inputs(cfg, B, gen)["vision_embed"] for B, _ in reqs]
    seeds = sys_.mask_seeds()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_launches()
    prefill_ms, ms_round, Es, toks = {}, {}, [], 0
    t0 = time.perf_counter()
    for i, ((B, P), tok, img) in enumerate(zip(reqs, prompts, images)):
        fe = [{"vision_embed": img}] * sys_.C
        caches = sys_.init_caches(B, P + VLM_NEW)
        torch.cuda.synchronize()
        t = time.perf_counter()
        E, caches = sys_.prefill(params, tok[:, :-1], caches, fe_list=fe,
                                 seeds=seeds, round_idx=i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, caches, _, _, logits = decode.serve_tokens(
            sys_, params, tok[:, -1:], caches, P - 1, VLM_NEW, seeds,
            fe_list=fe, return_logits=True)
        torch.cuda.synchronize()
        prefill_ms[f"{B}x{P}"] = (t1 - t) * 1e3
        ms_round[f"{B}x{P}"] = (time.perf_counter() - t1) * 1e3 / VLM_NEW
        _check_tokens(out, logits, B, VLM_NEW, cfg.vocab_size)
        toks += B * VLM_NEW
        Es.append(E)
        del caches, logits
    wall = time.perf_counter() - t0
    launches = _lm_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_prefill = c0.n_layers + c1.n_layers
    _check_launches("qwen2-vl-7b serving", launches, {
        "flash_attention_fwd": len(reqs) * per_prefill,
        "blind_agg_fwd": len(reqs) * (1 + VLM_NEW), "rglru_scan_fwd": 0})
    # the patches went in: other patches move the first 1024 positions
    # (the prefill timed warm, as is one more of the 4-lane prompts)
    (B, P), tok = reqs[1], prompts[1]
    other = frontend_inputs(cfg, B, gen)["vision_embed"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    E2, _ = sys_.prefill(params, tok[:, :-1], sys_.init_caches(B, P),
                         fe_list=[{"vision_embed": other}] * sys_.C,
                         seeds=seeds, round_idx=1)
    torch.cuda.synchronize()
    warm_ms = {f"{B}x{P}": (time.perf_counter() - t) * 1e3}
    (B4, P4), tok4 = reqs[0], prompts[0]
    t = time.perf_counter()
    sys_.prefill(params, tok4[:, :-1], sys_.init_caches(B4, P4),
                 fe_list=[{"vision_embed": images[0]}] * sys_.C, seeds=seeds,
                 round_idx=3)
    torch.cuda.synchronize()
    warm_ms[f"{B4}x{P4}"] = (time.perf_counter() - t) * 1e3
    n = cfg.n_vision_tokens
    moved = float((E2[:, :n].float() - Es[1][:, :n].float()).abs().max())
    if not moved > 0:
        raise AssertionError("qwen2-vl-7b: the prefill embeddings did not "
                             "move with the patches: no insert")
    log("vlm", f"{reqs[0][0]} lanes of {reqs[0][1]}-token prompts and one "
               f"of {reqs[1][1]} tokens, the first {n} positions an image's "
               f"patch embeddings, {VLM_NEW} greedy tokens each: prefill "
               f"ms (first calls) {prefill_ms}, warm {warm_ms}, ms a "
               f"decode round "
               f"{ms_round}, {toks / wall:.1f} tokens/s end to end, peak "
               f"device memory {peak_gb:.2f} GB; launches {launches} "
               f"(expected flash_attention_fwd {len(reqs)} x "
               f"{per_prefill}, blind_agg_fwd {len(reqs)} x (1 + "
               f"{VLM_NEW})); other patches move the 1279-token prefill's "
               f"embeddings over the first {n} positions by up to "
               f"{moved:.3g}: inserted")
    (B, P), tok, img = reqs[0], prompts[0], images[0]
    fe = [{"vision_embed": img}] * sys_.C
    box = {}
    prof_prefill = _profile_window(
        "vlm", f"one {P - 1}-token prefill at {B} lanes",
        lambda: box.update(r=sys_.prefill(
            params, tok[:, :-1], sys_.init_caches(B, P + VLM_NEW),
            fe_list=fe, seeds=seeds, round_idx=2)), 1, by_op=True)
    prof_decode = _profile_window(
        "vlm", f"{PROFILE_ROUNDS} decode rounds at {B} lanes",
        lambda: box.update(d=decode.serve_tokens(
            sys_, params, tok[:, -1:], box["r"][1], P - 1, PROFILE_ROUNDS,
            seeds, fe_list=fe)), PROFILE_ROUNDS, by_op=True)
    del box
    res.update({"prefill_ms": prefill_ms, "warm_prefill_ms": warm_ms,
                "ms_per_round": ms_round,
                "tokens_per_s": toks / wall, "serve_peak_gb": peak_gb,
                "patch_move": moved, "profile_prefill": prof_prefill,
                "profile_decode": prof_decode,
                "table_copies": _table_copies("vlm", sys_, params)})
    return launches, res


def _moe_layer_split(arch):
    """Where one MoE layer's device time goes (CUDA events, bf16, a layer
    of the model's shapes from a seeded generator): the whole
    ``moe_ffn``, its three expert products over the (E, cap + 1, d)
    buffer alone, its shared experts alone, and the rest (router, top-k,
    positions, dispatch, combine) as the difference; at a 4-lane decode
    round (T = 4, cap 4) and a 2047-token prefill (cap 171)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers, moe
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = moe.init_moe(gen, cfg.d_model, cfg.moe, cfg.act, torch.bfloat16)
    out = {}
    for label, shape in (("decode", (LM_LANES, 1)),
                         ("prefill", (1, max(LM_PROMPTS) - 1))):
        x = torch.randn(shape + (cfg.d_model,), generator=gen,
                        device="cuda").to(torch.bfloat16)
        T = shape[0] * shape[1]
        cap = moe.capacity(T, cfg.moe)
        buf = torch.randn((cfg.moe.n_experts, cap + 1, cfg.d_model),
                          generator=gen, device="cuda").to(torch.bfloat16)
        xt = x.reshape(T, -1)
        experts = lambda: torch.bmm(F.silu(torch.bmm(buf, p["w_gate"]))
                                    * torch.bmm(buf, p["w_up"]), p["w_down"])
        with torch.no_grad():
            full = _time_ms(lambda: moe.moe_ffn(p, x, cfg.moe, cfg.act),
                            reps=10, inner=5)
            ex = _time_ms(experts, reps=10, inner=5)
            sh = _time_ms(lambda: layers.mlp(p["shared"], xt, cfg.act),
                          reps=10, inner=5)
        out[label] = {"ms": full, "experts_ms": ex, "shared_ms": sh,
                      "rest_ms": full - ex - sh, "cap": cap}
        log("moe", f"one MoE layer at the {label} shape (T = {T}, cap "
                   f"{cap}), bf16: {full:.4f} ms, of which the 3 expert "
                   f"products over ({cfg.moe.n_experts}, {cap + 1}, "
                   f"{cfg.d_model}) {ex:.4f} ms, the shared experts "
                   f"{sh:.4f} ms, router + positions + dispatch + combine "
                   f"{full - ex - sh:.4f} ms (the difference)")
    return out


def _ssd_layer_split(arch):
    """Where one Mamba-2 layer's prefill time goes (CUDA events, bf16
    weights, a 2047-token prompt): the whole ``ssm_block``, its chunked
    SSD (``ssd_padded``, float32, 8 chunks of 256) alone, its two
    projections alone, and the rest (conv, gates, norm) as the
    difference."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = ssm.init_ssm(gen, cfg.d_model, cfg.ssm, torch.bfloat16)
    L = max(LM_PROMPTS) - 1
    d_inner, H, _ = ssm.ssm_dims(cfg.d_model, cfg.ssm)
    x = torch.randn((1, L, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    y = torch.randn((1, L, d_inner), generator=gen,
                    device="cuda").to(torch.bfloat16)
    f32 = lambda *s: torch.randn(s, generator=gen, device="cuda")
    xs, Bm, Cm = (f32(1, L, H, cfg.ssm.head_dim), f32(1, L, 1,
                  cfg.ssm.d_state), f32(1, L, 1, cfg.ssm.d_state))
    dt = torch.rand((1, L, H), generator=gen, device="cuda") * 0.2
    A = -torch.rand((H,), generator=gen, device="cuda")
    with torch.no_grad():
        full = _time_ms(lambda: ssm.ssm_block(p, x, cfg.ssm), reps=10,
                        inner=3)
        sd = _time_ms(lambda: ssm.ssd_padded(xs, dt, A, Bm, Cm,
                                             cfg.ssm.chunk), reps=10,
                      inner=3)
        proj = _time_ms(lambda: (x @ p["in_proj"], y @ p["out_proj"]),
                        reps=10, inner=3)
    log("mamba", f"one Mamba-2 layer over a {L}-token prefill, bf16 "
                 f"weights: {full:.4f} ms, of which the chunked SSD "
                 f"(float32, {-(-L // cfg.ssm.chunk)} chunks of "
                 f"{cfg.ssm.chunk}) {sd:.4f} ms, in_proj + out_proj "
                 f"{proj:.4f} ms, conv + gates + norm {full - sd - proj:.4f}"
                 f" ms (the difference)")
    return {"ms": full, "ssd_ms": sd, "proj_ms": proj,
            "rest_ms": full - sd - proj}


def _host_gib():
    """MemAvailable of the host, in GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _cut_phase(tag, arch, n_layers, *, check_host=False,
               batch=LM_CUT_BATCH, prompt_len=LM_CUT_PROMPT,
               scaled_atol=False, keep=None, against_cpu=True, **cfg_kw):
    """The same width with depth cut to ``n_layers`` active layers (the
    passive proxies follow passive_cfg), float32 with TF32 off: card
    against the CPU port on the same weights and prompt (``against_cpu``
    False: the card alone, for ``keep``). The host copy is
    made leaf by leaf from the card's tensors (the stacked passive group
    once, then viewed per party), with no second copy beside it. With
    ``check_host`` the passive parties are cut to 1 when the host cannot
    hold the weights twice over. Embeddings and logits are held to rtol
    1e-4 / atol 1e-5, or with ``scaled_atol`` to atol 1e-5 x the largest
    |value| of the CPU's tensor (the CPU parity tests' tolerance for
    logits): qwen2-moe's random experts, drawn at the reference's fan-in
    scale 1/sqrt(E), add outputs of ~100 to a residual stream of ~1, and
    the float32 rounding of the two devices' sums grows with them. A
    frontend family gets its stubbed input, the same float32 values on
    both devices (a CPU generator seeded 2): an encoder-decoder's frame
    embeddings through ``encoder_kv``, a vision model's patch embeddings
    for every party; ``cfg_kw`` overrides further config fields (the
    encoder's depth). ``keep``, a dict, receives the prompt and the
    reference's (E, logits, tokens) (``"ref"``, named by ``"label"``): the
    CPU port's, or without ``against_cpu`` the card's own."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import decode
    from repro_torch.core.party_engine import unstack_tree
    from repro_torch.models.build import frontend_inputs
    from repro_torch.tree import tree_leaves, tree_map
    _free_card()
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32", **cfg_kw)
    card = _lm_system(cfg, "cuda")
    num_passive = None
    params = card.init_params(torch.Generator(device="cuda").manual_seed(0))
    nbytes = sum(t.numel() * t.element_size() for p in params["parties"]
                 for t in tree_leaves(p))
    avail = _host_gib()
    if check_host and avail < 2 * nbytes / 2 ** 30:
        num_passive = 1
        log(tag, f"host has {avail:.1f} GiB available, under twice the "
                 f"{nbytes / 2 ** 30:.1f} GiB of weights: passive parties "
                 f"cut to 1 for this check")
        del params
        _free_card()
        card = _lm_system(cfg, "cuda", num_passive)
        params = card.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        nbytes = sum(t.numel() * t.element_size() for p in params["parties"]
                     for t in tree_leaves(p))
    runs = [("card", card, params)]
    if against_cpu:
        cpu = _lm_system(cfg, "cpu", num_passive)
        stacked = tree_map(lambda t: t.cpu(), params["passive_stacked"])
        runs.append(("cpu", cpu, {
            "parties": [tree_map(lambda t: t.cpu(), params["parties"][0])]
            + unstack_tree(stacked, cpu.easter.num_passive),
            "passive_stacked": stacked}))
    log(tag, f"{cfg.name} cut to {n_layers} active layers (passive "
             f"{card.party_cfgs[1].n_layers}, {card.easter.num_passive} "
             f"passive parties), float32: {nbytes / 1e9:.1f} GB of weights "
             f"on the card"
             + (f" and copied to the host ({avail:.1f} GiB were available)"
                if against_cpu else ""))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size,
                          size=(batch, prompt_len)).astype(np.int32)
    fe = frontend_inputs(cfg, batch, torch.Generator().manual_seed(2))
    res = {}
    if keep is not None:
        keep["prompt"] = prompt
    for name, sys_, p in runs:
        toks = torch.from_numpy(prompt).to(sys_.device)
        seeds = sys_.mask_seeds()
        fe_list = None
        if "audio_embed" in fe:
            fe_list = sys_.encoder_kv(p, fe["audio_embed"].to(sys_.device))
        elif "vision_embed" in fe:
            fe_list = [{"vision_embed": fe["vision_embed"].to(
                sys_.device)}] * sys_.C
        caches = sys_.init_caches(batch, prompt_len + LM_CUT_ROUNDS)
        E, caches = sys_.prefill(p, toks[:, :-1], caches, seeds=seeds,
                                 round_idx=5, fe_list=fe_list)
        out, _, _, _, logits = decode.serve_tokens(
            sys_, p, toks[:, -1:], caches, prompt_len - 1, LM_CUT_ROUNDS,
            seeds, return_logits=True, fe_list=fe_list)
        res[name] = (E.cpu(), logits.cpu(), out.cpu())
        del fe_list, caches
    if not against_cpu:
        keep.update(ref=res["card"], label="one process on one card")
        return {"weights_gb": nbytes / 1e9}
    errs = {}
    for i, what in ((0, "prefill embeddings"), (1, "logits")):
        a, b = res["card"][i], res["cpu"][i]
        scale = float(b.abs().max())
        atol = 1e-5 * scale if scaled_atol else 1e-5
        errs[what] = (float((a - b).abs().max()),
                      float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()),
                      bool(torch.allclose(a, b, rtol=1e-4, atol=atol)),
                      scale, atol)
    same = bool(torch.equal(res["card"][2], res["cpu"][2]))
    if keep is not None:                 # the CPU port's outputs, reused
        keep.update(ref=res["cpu"], label="the CPU port")
    log(tag, f"depth cut to {n_layers} active layers"
             f"{f' and {cfg.n_encoder_layers} encoder layers over {cfg.n_audio_frames} frames' if cfg.family == 'encdec' else ''}"
             f"{f' ({cfg.n_vision_tokens} patch positions)' if cfg.family == 'vlm' else ''}"
             f", same width, float32, "
             f"TF32 off: batch {batch}, prompt {prompt_len}, "
             f"{LM_CUT_ROUNDS} greedy rounds, card vs CPU port: "
             + "; ".join(f"{w} max abs {e:.3g} max rel {r:.3g} (max |cpu| "
                         f"{m:.3g}; rtol 1e-4, atol {t:.3g}) "
                         f"{'ok' if ok else 'FAIL'}"
                         for w, (e, r, ok, m, t) in errs.items())
             + f"; tokens identical {same} {res['card'][2].tolist()}")
    if not same or not all(e[2] for e in errs.values()):
        raise AssertionError("the depth-cut run differs between card and CPU")
    return {"errors": errs, "num_passive": card.easter.num_passive,
            "weights_gb": nbytes / 1e9}


def _frontend_cuts():
    """whisper-small cut to 2 encoder and 2 decoder layers over the full
    1500 frames, and qwen2-vl-7b cut to 2 layers with a 1,100-token prompt
    (its 1024 patches inserted), each float32 against the CPU port.
    qwen2-vl's logits are held to atol 1e-5 x max|logit| (the CPU parity
    tests' tolerance for logits, as for qwen2-moe): its 18,944-wide MLP
    and 3,584-wide attention sums over 1,100 positions round apart on the
    two devices by up to ~3e-6 of the logits' scale (1.44e-5 at max
    |logit| 5.37 on the H100), past the absolute 1e-5."""
    return (_cut_phase("whisper_cut", WHISPER_ARCH, WHISPER_CUT_LAYERS,
                       n_encoder_layers=WHISPER_CUT_LAYERS),
            _cut_phase("vlm_cut", VLM_ARCH, VLM_CUT_LAYERS, check_host=True,
                       batch=VLM_CUT_BATCH, prompt_len=VLM_CUT_PROMPT,
                       scaled_atol=True))


def _check_train_launches(what, launches, steps, joint_steps=0):
    """A training step launches one blind_agg_fwd, blind_agg_bwd only in
    joint mode, and neither prompt kernel (they have no backward)."""
    want = {"blind_agg_fwd": steps, "blind_agg_bwd": joint_steps,
            "flash_attention_fwd": 0, "rglru_scan_fwd": 0}
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


def _train_full(tag):
    """qwen2-1.5b at full width and depth in bfloat16, trained through
    Trainer for TRAIN_CHUNKS chunks of TRAIN_CHUNK steps; a counted main
    path. Then one chunk under the profiler and one joint step (sgd)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import api
    from repro_torch.core.easter_lm import EasterLM
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.tree import tree_leaves
    cfg = get_config(TRAIN_ARCH)
    sys_ = _lm_system(cfg, "cuda")
    _free_card()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = sys_.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_all = sum(t.numel() for p in params["parties"] for t in tree_leaves(p))
    cfgs = sys_.party_cfgs
    trainer = api.build_trainer(sys_, api.TrainConfig(chunk=TRAIN_CHUNK))
    state = trainer.init(params)
    log(tag, f"{cfg.name}: {cfgs[0].n_layers} layers, d_model "
             f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}x"
             f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
             f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; C = "
             f"{sys_.C} ({len(cfgs) - 1} passive proxies of "
             f"{cfgs[1].n_layers} layers), d_embed {sys_.easter.d_embed}, "
             f"{sys_.easter.mask_mode} wire, {sys_.engine} engine; {n_all} "
             f"parameters ({n_all / 1e9:.3f}e9) drawn on the card in "
             f"{init_s:.1f} s; adam 1e-3 clip 1.0 (float32 m and v); device "
             f"memory {torch.cuda.memory_allocated() / 1e9:.1f} GB")
    it = lm_batch_iterator(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    chunks = [[next(it) for _ in range(TRAIN_CHUNK)]
              for _ in range(TRAIN_CHUNKS + 1)]
    starts = []                  # host clock at each step's start, synced
    loss_fn = sys_.loss_fn

    def timed_loss(*a):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return loss_fn(*a)

    sys_.loss_fn = timed_loss
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_launches()
    per, ends = [], []
    for batches in chunks[:TRAIN_CHUNKS]:
        state, m = trainer.run(state, batches)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        per.append(m["per_party"].cpu())
    launches = _lm_launches()
    sys_.loss_fn = loss_fn
    steps = TRAIN_CHUNK * TRAIN_CHUNKS
    _check_train_launches("qwen2-1.5b training", launches, steps)
    peak = torch.cuda.max_memory_allocated()
    per = torch.cat(per)
    totals = per.sum(1)
    step_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:] + [ends[-1]])]
    ms = statistics.median(step_ms[TRAIN_CHUNK:])
    toks = TRAIN_BATCH * TRAIN_SEQ
    log(tag, f"{steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
             f"{TRAIN_CHUNKS} chunks of {TRAIN_CHUNK}: ms per step "
             f"{[round(v, 1) for v in step_ms]}; median of the second "
             f"chunk {ms:.1f} ms, {toks / ms * 1e3:.0f} tokens/s; peak "
             f"device memory {peak / 1e9:.2f} GB "
             f"(torch.cuda.max_memory_allocated); launches {launches}")
    log(tag, f"per-party losses by step: "
             f"{[[round(float(v), 4) for v in r] for r in per]}")
    if not bool(torch.isfinite(per).all()):
        raise AssertionError(f"non-finite training losses {per.tolist()}")
    if not float(totals[-2:].mean()) < float(totals[0]):
        raise AssertionError(f"the total loss did not fall: "
                             f"{totals.tolist()}")
    box = {"state": state}
    prof = _profile_window(
        tag, f"a chunk of {PROFILE_STEPS} training step",
        lambda: box.update(state=trainer.run(
            box["state"], chunks[-1][:PROFILE_STEPS])[0]), PROFILE_STEPS,
        by_op=True)
    # one joint step: the aggregate's gradient goes back through the
    # kernel (sgd: no second optimizer state beside adam's)
    joint = EasterLM(cfg, sys_.easter, grad_mode="joint", device="cuda")
    jtrainer = api.build_trainer(joint, api.TrainConfig(optimizer="sgd",
                                                        lr=1e-4))
    jstate = jtrainer.init(box["state"].params)
    jstate = api.TrainState(jstate.params, jstate.opt_state,
                            box["state"].step)
    _reset_lm_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jstate, jm = jtrainer.run(jstate, chunks[0][:1])
    torch.cuda.synchronize()
    joint_ms = (time.perf_counter() - t0) * 1e3
    jlaunch = _lm_launches()
    _check_train_launches("qwen2-1.5b joint step", jlaunch, 1, 1)
    if not bool(torch.isfinite(jm["per_party"]).all()):
        raise AssertionError("non-finite joint-step losses")
    log(tag, f"one grad_mode='joint' sgd step: {joint_ms:.1f} ms, per-party "
             f"losses {[round(float(v), 4) for v in jm['per_party'][0]]}, "
             f"launches {jlaunch}")
    del state, box, jstate, trainer, jtrainer, params
    return (launches, jlaunch), {
        "arch": cfg.name, "params": n_all, "init_s": init_s,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "step_ms": step_ms,
        "ms_per_step": ms, "tokens_per_s": toks / ms * 1e3,
        "peak_bytes": peak, "per_party": per.tolist(), "profile": prof,
        "joint_ms": joint_ms}


def _train_step_on(sys_, params0, batch):
    """One sgd step (lr 0.01, clip 1.0) from host weights ``params0``
    (numpy, reference layout): (per-party losses, grads, updated params,
    launches), the tensors where ``sys_`` computed them."""
    import torch
    from repro_torch.core import train_loop
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves
    params = sys_.load_params(params0)
    _reset_lm_launches()
    _, per, grads = train_loop.loss_and_grads(sys_, params, batch, 3,
                                              sys_.mask_seeds())
    tree = {"parties": params["parties"]}
    opt = make_optimizer("sgd", 0.01, grad_clip=1.0)
    opt.update(grads, opt.init(tree), tree)
    if sys_.device.type == "cuda":
        torch.cuda.synchronize()
    launches = _lm_launches()
    flat = lambda t: [x.detach() for x in tree_leaves(t)]
    return per.detach(), flat(grads), flat(tree), launches


def _train_cut_check(tag, name, cfg, batch):
    """One sgd step of ``cfg`` in float32 (TF32 off) on the card and on the
    CPU port from the same weights: per-party losses, gradients and the
    updated params within rtol 1e-4 / atol 1e-5, and the card's launches
    checked (one blind_agg_fwd, no prompt kernel). The card's results stay
    on the card and are compared there, a CPU leaf copied over at a time
    (on the host the comparisons of 2 x 5.9 GB took ~20 s)."""
    import torch
    from repro_torch.tree import tree_leaves
    _free_card()
    card = _lm_system(cfg, "cuda")
    cpu = _lm_system(cfg, "cpu")
    params0 = card.export_params(
        card.init_params(torch.Generator(device="cuda").manual_seed(0)))
    nbytes = sum(a.nbytes for a in tree_leaves(params0))
    got = _train_step_on(card, params0, batch)
    _check_train_launches(f"{name} step", got[3], 1)
    _free_card()
    want = _train_step_on(cpu, params0, batch)
    errs = {}
    for i, what in ((0, "losses"), (1, "gradients"), (2, "updated params")):
        a = got[i] if i else [got[i]]
        b = want[i] if i else [want[i]]
        worst, ok = 0.0, True
        for x, y in zip(a, b):
            y = y.to(x.device)
            worst = max(worst, float((x - y).abs().max()))
            ok = ok and bool(torch.allclose(x, y, rtol=1e-4, atol=1e-5))
        errs[what] = (worst, ok)
    log(tag, f"{name}, float32, TF32 off, {nbytes / 1e9:.2f} GB of weights, "
             f"batch {tuple(batch['tokens'].shape)}: one sgd step card vs "
             f"CPU port: "
             + "; ".join(f"{w} max abs {e:.3g} {'ok' if ok else 'FAIL'}"
                         for w, (e, ok) in errs.items())
             + f" (rtol 1e-4, atol 1e-5); card launches {got[3]}; losses "
             f"card {[round(float(v), 5) for v in got[0]]}")
    if not all(ok for _, ok in errs.values()):
        raise AssertionError(f"{name}: the training step differs between "
                             f"card and CPU")
    return {"errors": errs, "weights_gb": nbytes / 1e9}


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, f"{path}/{i}")]
    return [path]


def _train_repeatability(tag):
    """On the card, a chunk of 2 adam steps against the step loop from the
    same weights (the same code, so any difference is a nondeterministic
    op), and one step's gradients computed twice; reports the leaves that
    differ, which name the op (an embedding table: the embedding
    backward). Reported, not asserted."""
    import torch
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core import train_loop
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves
    cfg = smoke_variant(get_config(TRAIN_ARCH))
    sys_ = _lm_system(cfg, "cuda")
    params0 = sys_.export_params(
        sys_.init_params(torch.Generator(device="cuda").manual_seed(0)))
    it = lm_batch_iterator(cfg.vocab_size, 4, 256, seed=2)
    batches = [next(it) for _ in range(2)]
    opt = make_optimizer("adam", 1e-3, grad_clip=1.0)
    finals = []
    for mode in ("chunk", "loop"):
        params = sys_.load_params(params0)
        state = opt.init({"parties": params["parties"]})
        if mode == "chunk":
            params, state, _, _ = train_loop.build_train_chunk(sys_, opt)(
                params, state, train_loop.stack_batches(batches, "cuda"), 0)
        else:
            step = train_loop.make_train_step(sys_, opt)
            for i, b in enumerate(batches):
                params, state, _ = step(params, state, b, i)
        finals.append([t.detach().cpu()
                       for t in tree_leaves(params["parties"])])
    names = _leaf_paths(sys_.export_params(sys_.load_params(params0))
                        ["parties"])
    chunk_diff = [n for n, a, b in zip(names, *finals)
                  if not torch.equal(a, b)]
    grads = []
    for _ in range(2):
        params = sys_.load_params(params0)
        g = train_loop.loss_and_grads(sys_, params, batches[0], 0,
                                      sys_.mask_seeds())[2]
        grads.append([t.cpu() for t in tree_leaves(g["parties"])])
    grad_diff = [n for n, a, b in zip(names, *grads)
                 if not torch.equal(a, b)]
    log(tag, f"{cfg.name} float32, 2 adam steps of 4 x 256 tokens on the "
             f"card: a chunk equals the step loop bit for bit: "
             f"{not chunk_diff} (leaves that differ: {chunk_diff[:6]}); one "
             f"step's gradients twice, bit for bit: {not grad_diff} (leaves "
             f"that differ: {grad_diff[:6]})")
    return {"chunk_equals_loop": not chunk_diff, "chunk_diff": chunk_diff,
            "grads_repeat": not grad_diff, "grad_diff": grad_diff}


def phase_train():
    """EasterLM training: qwen2-1.5b at full width and depth (bfloat16),
    then the depth cut and the recurrentgemma-9b smoke variant in float32
    against the CPU port, and the frontend families' smoke variants with
    their frontend inputs in the batch. Returns (counted launches,
    results)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.data.synthetic import lm_batch_iterator
    (launches, jlaunch), res = _train_full("train")
    _free_card()
    cut = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CUT_LAYERS, dtype="float32")
    res["depth_cut"] = _train_cut_check(
        "train", f"{TRAIN_ARCH} cut to {TRAIN_CUT_LAYERS} active layers",
        cut, next(lm_batch_iterator(cut.vocab_size, TRAIN_CUT_BATCH,
                                    TRAIN_CUT_SEQ, seed=1)))
    rg = smoke_variant(get_config(RG_ARCH))
    res["rg_smoke"] = _train_cut_check(
        "train", f"{RG_ARCH} smoke variant", rg,
        next(lm_batch_iterator(rg.vocab_size, 2, 40, seed=1)))
    # the frontend families: the batch's audio_embed / vision_embed reach
    # every party's encoder or patch insert (float32 unit normals, numpy
    # seed 1; 40 tokens cover qwen2-vl's 8 patch positions)
    for arch in (WHISPER_ARCH, VLM_ARCH):
        fc = smoke_variant(get_config(arch))
        batch = next(lm_batch_iterator(fc.vocab_size, 2, 40, seed=1))
        n = fc.n_audio_frames if fc.family == "encdec" else \
            fc.n_vision_tokens
        key = "audio_embed" if fc.family == "encdec" else "vision_embed"
        batch[key] = np.random.default_rng(1).normal(
            size=(2, n, fc.d_model)).astype(np.float32)
        res[f"{fc.family}_smoke"] = _train_cut_check(
            "train", f"{arch} smoke variant ({key} {batch[key].shape})", fc,
            batch)
    res["repeatability"] = _train_repeatability("train")
    return (launches, jlaunch), res


def _sdpa_backend(fn):
    """Which SDPA backend the default call ``fn`` ran: the backends whose
    output, each run alone under ``sdpa_kernel``, is bit-identical to it."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    want = fn()
    same = []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                got = fn()
        except RuntimeError:  # the backend does not take these inputs
            continue
        if torch.equal(got, want):
            same.append(backend.name)
    return "/".join(same) or "none alone matches the default bit for bit"


def _causal_pairs(S, window):
    """(query, key) pairs a causal (windowed) prompt of S tokens attends:
    sum over rows i of min(i + 1, window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _flash_timing_case(B, S, heads, window, gen, T=None, causal=True):
    """One timing shape, bfloat16: a causal (windowed) prefill with T = S,
    or non-causal attention of S queries over T keys (whisper's encoder
    and cross-attention)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    Hq, Hkv, hd = heads
    T = S if T is None else T
    q = torch.randn((B, S, Hq, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, Hkv, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, Hkv, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kern = lambda: tfa.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
    plain = lambda: ref.reference_attention(q, k, v, causal=causal,
                                            window=window)
    if not causal:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     enable_gqa=True)
    elif window == 0 or window >= S:
        # a window of at least S keeps every causal pair: SDPA's causal
        # mask is then the same function
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        # the causal band of the window as a boolean mask (True = attend)
        i = torch.arange(S, device="cuda")
        band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    # turns: plain, kernel, kernel, plain; then the library call
    p1 = _time_ms(plain, reps=10, inner=5)
    k1 = _time_ms(kern, reps=10, inner=5)
    k2 = _time_ms(kern, reps=10, inner=5)
    p2 = _time_ms(plain, reps=10, inner=5)
    l1 = _time_ms(lib, reps=10, inner=5)
    backend = _sdpa_backend(lib)
    pairs = _causal_pairs(S, window) if causal else S * T
    flops = 4 * hd * Hq * B * pairs
    nbytes = 2 * B * (2 * S * Hq * hd + 2 * T * Hkv * hd)
    op_ms = flops / BF16_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(op_ms, byte_ms)
    ms = min(k1, k2)
    what = ("causal" if causal else f"non-causal over T = {T}")
    log("timing", f"flash_attention_fwd ({B}, {S}, {Hq}/{Hkv}, {hd}) {what}"
                  f"{f' window {window}' if window else ''} bfloat16: kernel "
                  f"{k1:.4f}/{k2:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"bound/time {bound / ms:.3f}), plain {p1:.4f}/{p2:.4f} "
                  f"ms, SDPA (library yardstick, backend {backend}) "
                  f"{l1:.4f} ms; bound {bound:.5f} ms ({flops} flops of the "
                  f"attended pairs at 989 TFLOP/s bf16 {op_ms:.5f} ms; {nbytes}"
                  f" B at 3.35 TB/s {byte_ms:.5f} ms; data-sheet peaks), "
                  f"kernel at {ms / bound:.2f}x it")
    return {"ms": ms, "plain_ms": min(p1, p2), "library_ms": l1,
            "bound_ms": bound,
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "flops": flops, "bytes": nbytes,
            "tflops": flops / ms / 1e9, "sdpa_backend": backend}


def phase_timing_flash():
    """flash_attention_fwd at the serving paths' attention shapes,
    bfloat16, beside its plain version and SDPA (the library yardstick):
    qwen2.5-3b at (1 | 3, 1023 | 2047); recurrentgemma-9b's window-2048
    heads, gemma3-4b's window-1024 8/4/256 heads and qwen2-moe-a2.7b's
    16/16/128 heads at (1 | 3, 2047); whisper-small's 12/12/64 at (4 |
    12, 1500 | 3 | 1) non-causal over T = 1500 (encoder, prefill and
    decode cross-attention), and a model rank's 3/3/64 of them under the
    fsdp phase's (h) at (4 | 12, 1500 | 64 | 1); qwen2-vl-7b's 28/4/128
    causal at (4 | 12, 2047) and (1 | 3, 1279). Keys "B x S"
    (qwen2.5-3b), "rg B x S", "gemma B x S", "moe B x S", "whisper B x
    S", "whisper tp B x S" and "vlm B x S"."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    return {f"{label}{B}x{S}": _flash_timing_case(B, S, heads, window, gen,
                                                  T, causal)
            for label, B, S, heads, window, T, causal in FLASH_TIMING}


# ---------------------------------------------------------------------------
# the sharded engine: ranks of a party group sharing the card over gloo
# ---------------------------------------------------------------------------

SHARDED_RANKS, SHARDED_LM_RANKS = 4, 3
SHARDED_ROUNDS = 10
SHARDED_LM_LANES, SHARDED_LM_PROMPT, SHARDED_LM_ROUNDS = 4, 2048, 16


def _many_rounds(cls, params, data, n, snap=None):
    """n adam rounds of the many-party classifier ``cls`` on the card:
    (ms per round, per-party losses per round (numpy), blind_agg
    launches per round, ``snap(params)`` before each round). Masks round
    i. ``snap`` runs outside the timing."""
    import torch
    from repro_torch.kernels import blind_agg as tba
    init_opt, step = cls.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    xs, y = _to(*data, "cuda")
    ms, pers, launches, snaps = [], [], [], []
    for i in range(n):
        if snap is not None:
            snaps.append(snap(params))
        tba.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, per = step(params, opt, xs, y,
                                   cls.masks(MP_BATCH, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        pers.append(per.cpu().numpy())
        launches.append(_agg_launches())
    return ms, pers, launches, snaps


def _many_grads(cls, params, data):
    """Round 0's per-party losses and gradients (numpy, per party)."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.tree import tree_leaves, tree_unflatten
    xs, y = _to(*data, "cuda")
    total, per = cls.loss_fn(params, xs, y, cls.masks(MP_BATCH, 0))
    g = torch.autograd.grad(total, tree_leaves(params), allow_unused=True,
                            materialize_grads=True)
    return per.detach().cpu().numpy(), checkpoint.params_to_numpy(
        tree_unflatten(params, g))


def _sharded_many(grp):
    """Rank side: the many-party rounds on the sharded engine (float,
    int8, one joint round), round 0's gradients gathered to rank 0. Each
    round's weights are gathered to rank 0 first, where the vectorized
    engine's forward on them gives the per-party losses that round must
    equal bit for bit (``"same_weights"``: the rounds' losses, rank 0
    only)."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.core import party_group
    out = {}
    data = None
    for mode, gm, n in (("float", "easter", SHARDED_ROUNDS),
                        ("int8", "easter", SHARDED_ROUNDS),
                        ("float", "joint", 1)):
        cls = _build_many("cuda", fused=False, mode=mode, grad_mode=gm,
                          engine="sharded", group=grp)
        data = data or _many_data(cls)
        params = cls.init_params(torch.Generator().manual_seed(0))
        if mode == "float" and gm == "easter":
            per0, grads = _many_grads(cls, params, data)
            out["grads"] = party_group.gather_tree(grp, grads)
            out["held"] = cls._eng.held()
        rounds = _many_rounds(
            cls, params, data, n,
            snap=lambda p: party_group.gather_tree(grp, p))
        out[(mode, gm)] = rounds[:3]
        if grp.rank == 0:
            vec = _build_many("cuda", fused=False, mode=mode, grad_mode=gm)
            xs, y = _to(*data, "cuda")
            with torch.no_grad():
                out[("same_weights", mode, gm)] = [
                    vec.loss_fn(checkpoint.params_from_numpy(w, "cuda"), xs,
                                y, vec.masks(MP_BATCH, i))[1].cpu().numpy()
                    for i, w in enumerate(rounds[3])]
    return out


def _lm_prompt(vocab):
    import numpy as np
    return np.random.default_rng(3).integers(
        0, vocab, size=(SHARDED_LM_LANES, SHARDED_LM_PROMPT)).astype(
            np.int32)


def _serve_lm(sys_, params):
    """A 2047-token prefill of every lane (nonce 5), then greedy rounds:
    (tokens (numpy), prefill ms, ms per round, prefill launches, launches
    a round, the prefill's E and every round's logits as float32 on the
    host (None off the active party's rank))."""
    import torch
    from repro_torch.core import decode
    prompt = torch.from_numpy(_lm_prompt(sys_.cfg.vocab_size)).cuda()
    seeds = sys_.mask_seeds()
    caches = sys_.init_caches(SHARDED_LM_LANES,
                              SHARDED_LM_PROMPT + SHARDED_LM_ROUNDS)
    _reset_lm_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    E, caches = sys_.prefill(params, prompt[:, :-1], caches, seeds=seeds,
                             round_idx=5)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = _lm_launches()
    _reset_lm_launches()
    t0 = time.perf_counter()
    out, _, _, _, logits = decode.serve_tokens(
        sys_, params, prompt[:, -1:], caches, SHARDED_LM_PROMPT - 1,
        SHARDED_LM_ROUNDS, seeds, return_logits=True)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / SHARDED_LM_ROUNDS
    # numpy, not torch tensors: a rank's torch tensors would cross the
    # pipe as shared-memory handles, gone once the rank exits
    host = lambda t: None if t is None else t.float().cpu().numpy()
    return (out.cpu().numpy(), prefill_ms, round_ms, pre, _lm_launches(),
            host(E), host(logits))


def _forced_rounds(sys_, params, tokens):
    """The lm prompt's prefill, then SHARDED_LM_ROUNDS decode rounds fed
    ``tokens`` (the vectorized engine's greedy tokens, teacher forcing):
    every round's logits, float32 numpy, on the active party's rank (None
    elsewhere)."""
    import numpy as np
    import torch
    prompt = torch.from_numpy(_lm_prompt(sys_.cfg.vocab_size)).cuda()
    seeds = sys_.mask_seeds()
    caches = sys_.init_caches(SHARDED_LM_LANES,
                              SHARDED_LM_PROMPT + SHARDED_LM_ROUNDS)
    _, caches = sys_.prefill(params, prompt[:, :-1], caches, seeds=seeds,
                             round_idx=5)
    feed = torch.cat([prompt[:, -1:], torch.from_numpy(tokens).cuda()], 1)
    out = []
    for i in range(SHARDED_LM_ROUNDS):
        logits, caches = sys_.serve_step(params, feed[:, i:i + 1], caches,
                                         SHARDED_LM_PROMPT - 1 + i, seeds)
        out.append(None if logits is None
                   else logits[:, -1].float().cpu().numpy())
    return None if out[0] is None else np.stack(out, 1)


def _sharded_lm(grp, cut_prompt, vec_tokens):
    """Rank side: qwen2.5-3b at full width and depth in bfloat16 over the
    LM's ranks (each rank draws every party in order from the card's
    generator seeded 0 and keeps its own), served as the parent serves it;
    then the 4-layer float32 cut with the lm phase's prompt."""
    import dataclasses
    import torch
    from repro_torch.configs.base import EasterConfig, get_config
    from repro_torch.core import decode
    from repro_torch.core.easter_lm import EasterLM
    cfg = get_config(LM_ARCH)
    sys_ = EasterLM(cfg, EasterConfig(), engine="sharded", group=grp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = sys_.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    res = {"draw_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9,
           "rows": list(sys_._rows()),
           "devices": _devices([params, sys_.init_caches(1, 8)])}
    res["serve"] = _serve_lm(sys_, params)
    res["forced"] = _forced_rounds(sys_, params, vec_tokens)
    del params
    torch.cuda.empty_cache()
    cut = EasterLM(dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS,
                                       dtype="float32"), EasterConfig(),
                   engine="sharded", group=grp)
    p = cut.init_params(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(cut_prompt).cuda()
    seeds = cut.mask_seeds()
    caches = cut.init_caches(LM_CUT_BATCH, LM_CUT_PROMPT + LM_CUT_ROUNDS)
    E, caches = cut.prefill(p, toks[:, :-1], caches, seeds=seeds,
                            round_idx=5)
    out, _, _, _, logits = decode.serve_tokens(
        cut, p, toks[:, -1:], caches, LM_CUT_PROMPT - 1, LM_CUT_ROUNDS,
        seeds, return_logits=True)
    host = lambda t: None if t is None else t.cpu().numpy()
    res["cut"] = (host(E), host(logits), host(out))
    return res


def _devices(tree):
    """The devices of a tree's tensors, as sorted strings."""
    from repro_torch.tree import tree_leaves
    return sorted({str(t.device) for t in tree_leaves(tree)
                   if hasattr(t, "device")})


def _rule(world, rank):
    """(backend, card) that launch/mesh.py's rule gives rank ``rank`` of
    ``world`` ranks on the card: NCCL on cuda:<rank> where every rank has
    a card of its own, else gloo with every rank on cuda:0."""
    import torch
    if torch.cuda.device_count() >= world:
        return "nccl", f"cuda:{rank}"
    return "gloo", "cuda:0"


def _rule_failures(what, r, world, devices=()):
    """A rank's backend, card and the cards its tensors lie on (each of
    ``devices``: a list of device strings) against ``_rule``."""
    backend, card = _rule(world, r["rank"])
    out = []
    if (r["backend"], r["device"]) != (backend, card):
        out.append(f"{what} rank {r['rank']}: {r['backend']} on "
                   f"{r['device']}, the rule gives {backend} on {card}")
    for d in devices:
        if d != [card]:
            out.append(f"{what} rank {r['rank']}: tensors on {d}, want "
                       f"[{card!r}]")
    return out


def _sharded_rank(cut_prompt, vec_tokens, t_spawn):
    """One rank of the sharded phase (a spawned process on the card):
    joins the 4-rank group, runs the many-party rounds, then ranks 0-2 the
    LM. Returns its results, the seconds from the spawn to its joining the
    group (wall clock) and its peak device memory."""
    import torch
    from repro_torch.launch import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grp = mesh.make_party_group(device="cuda")
    torch.zeros((), device=grp.device)          # this rank's CUDA context
    res = {"rank": grp.rank, "backend": grp.backend,
           "device": str(grp.device), "start_s": time.time() - t_spawn}
    res["many"] = _sharded_many(grp)
    res["many_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    lm_grp = mesh.make_party_group(SHARDED_LM_RANKS, device="cuda")
    if lm_grp is not None:
        torch.cuda.reset_peak_memory_stats()
        res["lm"] = _sharded_lm(lm_grp, cut_prompt, vec_tokens)
        res["lm_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def _sum_launches(launches):
    """Per-round launch dicts -> one dict (fwd_groups summed too)."""
    tot = {}
    for d in launches:
        for k, v in d.items():
            if k == "fwd_groups":
                g = tot.setdefault(k, {})
                for G, n in (v or {}).items():
                    g[G] = g.get(G, 0) + n
            else:
                tot[k] = tot.get(k, 0) + v
    return tot


def phase_sharded(cut_ref):
    """The sharded engine on the card (the module docstring's ``sharded``):
    4 ranks spawned at once, by launch/mesh.py's rule sharing the card over
    gloo (or over NCCL, a card a rank, where 4 cards are visible: --phase
    nccl); many-party C = 64 and qwen2.5-3b over 3 ranks against the
    vectorized engine on the card, the 4-layer float32 cut against
    ``cut_ref`` (the lm cut's prompt and a reference's outputs: the CPU
    port's, or one process's on one card). Every check is logged; the
    phase fails at its end if any failed. Returns (the counted paths'
    launches, the numbers)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.base import EasterConfig, get_config
    from repro_torch.core.easter_lm import EasterLM
    from repro_torch.launch import dryrun, mesh, steps
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    res = {}
    # the single-process vectorized engine on the card, the reference
    ref = {}
    data = None
    for mode, gm, n in (("float", "easter", SHARDED_ROUNDS),
                        ("int8", "easter", SHARDED_ROUNDS),
                        ("float", "joint", 1)):
        cls = _build_many("cuda", fused=False, mode=mode, grad_mode=gm)
        data = data or _many_data(cls)
        params = cls.init_params(torch.Generator().manual_seed(0))
        if mode == "float" and gm == "easter":
            ref["grads"] = _many_grads(cls, params, data)[1]
        ref[(mode, gm)] = _many_rounds(cls, params, data, n)
    # qwen2.5-3b, drawn as the lm phase draws it; the dry run's weight
    # bytes against what the draw allocated
    cfg = get_config(LM_ARCH)
    _free_card()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sys_ = _lm_system(cfg, "cuda")
    params = sys_.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    drawn = torch.cuda.memory_allocated() - before
    tree = dryrun.tree_bytes({"parties": params["parties"]})
    allocs = len(tree_leaves(params["parties"][0])) + len(
        tree_leaves(params["passive_stacked"]))
    meta = steps.make_system(cfg, EasterConfig(), device="meta")
    dry = dryrun.tree_bytes({"parties": steps.abstract_params(
        meta)["parties"]})
    res["dryrun_weight_bytes"] = {"dry_run": dry, "tree": tree,
                                  "allocated": drawn,
                                  "allocations": allocs}
    log("sharded", f"dry run vs the lm draw ({cfg.name}, bfloat16, C = "
                   f"{sys_.C}): the dry run's weight bytes {dry}, the drawn "
                   f"tree's {tree}, the caching allocator's growth over the "
                   f"draw {drawn} ({allocs} allocations; the allocator "
                   f"rounds a large one up to 2 MiB segments and leaves a "
                   f"remainder under 1 MiB unsplit)")
    if not (dry == tree and 0 <= drawn - tree < 2 ** 20 * allocs):
        raise AssertionError("the dry run's weight bytes differ from the "
                             "draw's")
    vec = _serve_lm(sys_, params)
    del params, sys_
    _free_card()
    # the loop engine, drawn from the same generator (the same weights),
    # runs each passive party alone: one party's GEMM batch, as a rank of
    # the sharded engine holding one party runs it
    loop_sys = EasterLM(cfg, EasterConfig(), engine="loop", device="cuda")
    loop = _serve_lm(loop_sys, loop_sys.init_params(
        torch.Generator(device="cuda").manual_seed(0)))
    del loop_sys
    _free_card()
    cut_prompt = cut_ref["prompt"]
    # the ranks: spawned at once, each joining the group on the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        ranks = mesh.spawn_ranks(_sharded_rank, SHARDED_RANKS, cut_prompt,
                                 vec[0], time.time(), store_dir=store,
                                 device="cuda", timeout_s=300)
    res["ranks_s"] = time.perf_counter() - t0
    res["start_s"] = [r["start_s"] for r in ranks]
    log("sharded", f"{SHARDED_RANKS} ranks spawned at once on "
                   f"{ranks[0]['device']} over {ranks[0]['backend']}: each "
                   f"in the group with its CUDA context "
                   f"{[round(s, 2) for s in res['start_s']]} s after the "
                   f"spawn; every rank done in {res['ranks_s']:.1f} s")
    res["backend"] = ranks[0]["backend"]
    # many-party: losses bit for bit, gradients, launches; every check is
    # logged, and the phase fails at its end if any failed
    paths, failures = [], []
    for r in ranks:
        failures += _rule_failures("sharded", r, SHARDED_RANKS, [
            r["lm"]["devices"]] if "lm" in r else [])
    for key in (("float", "easter"), ("int8", "easter"), ("float", "joint")):
        want = ref[key][1]
        same = ranks[0]["many"][("same_weights",) + key]
        for r in ranks:
            got = r["many"][key][1]
            # every round's forward bit for bit the vectorized engine's on
            # the same weights (the round's, gathered to rank 0 first)
            if len(same) != len(got) or not all(
                    np.array_equal(a, b) for a, b in zip(got, same)):
                failures.append(f"many-party {key} rank {r['rank']}: a "
                                f"round's losses differ from the vectorized "
                                f"engine's forward on the same weights")
            # the two engines' own adam runs: round 0 from the same
            # weights bit for bit; later rounds carry the gradients'
            # rounding (held below at atol 5e-6 / rtol 1e-6) through the
            # updates, held at rtol 1e-5; the ranks agree bit for bit
            rel = [float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in zip(got, want)]
            if rel[0] != 0.0 or max(rel) > 1e-5:
                failures.append(f"many-party {key} rank {r['rank']}: "
                                f"losses differ from the vectorized "
                                f"engine's run by {rel} relative by round")
            if not all(np.array_equal(a, b) for a, b in
                       zip(got, ranks[0]["many"][key][1])):
                failures.append(f"many-party {key}: rank {r['rank']}'s "
                                f"losses differ from rank 0's")
            n_fwd = [d["blind_agg_fwd"] for d in r["many"][key][2]]
            n_bwd = [d["blind_agg_bwd"] for d in r["many"][key][2]]
            want_fwd = 1 if r["rank"] == 0 and key[0] == "float" else 0
            want_bwd = 1 if r["rank"] == 0 and key[1] == "joint" else 0
            if set(n_fwd) != {want_fwd} or set(n_bwd) != {want_bwd}:
                failures.append(f"many-party {key} rank {r['rank']}: "
                                f"blind_agg_fwd {n_fwd}, blind_agg_bwd "
                                f"{n_bwd} a round")
        paths.append(_sum_launches(ranks[0]["many"][key][2]))
        ms = {r["rank"]: statistics.median(r["many"][key][0][2:] or
                                           r["many"][key][0])
              for r in ranks}
        vms = statistics.median(ref[key][0][2:] or ref[key][0])
        res[f"many_{key[0]}_{key[1]}"] = {"ms_by_rank": ms,
                                          "vectorized_ms": vms}
        log("sharded", f"many-party C = {MP_C} {key[0]} {key[1]}: "
                       f"{len(want)} rounds, every rank's per-party losses "
                       f"bit for bit rank 0's and, every round, the "
                       f"vectorized engine's forward on the same weights; "
                       f"their max relative difference from the vectorized "
                       f"engine's own run by round {rel} (round 0 bit for "
                       f"bit, then rtol 1e-5); "
                       f"failures so far {len(failures)}; ms per "
                       f"round by rank {ms} (median from round 2) beside "
                       f"the vectorized engine's {vms:.3f} on one process; "
                       f"rank 0 launches {paths[-1]}")
    got = ranks[0]["many"]["grads"]
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(ref["grads"])):
        if not np.allclose(a, b, atol=5e-6, rtol=1e-6):
            failures.append("many-party round 0 gradients beyond atol 5e-6 "
                            "/ rtol 1e-6")
        worst = max(worst, float(np.abs(a - b).max()))
    res["many_grad_max_abs"] = worst
    log("sharded", f"round 0 gradients gathered to rank 0, against the "
                   f"vectorized engine's: max |difference| {worst:.3g} "
                   f"(atol 5e-6, rtol 1e-6)")
    # the LM: tokens, launches
    lm = {r["rank"]: r["lm"] for r in ranks if "lm" in r}
    cfgs = _lm_system(cfg, "cpu").party_cfgs
    attn_a, attn_p = _layer_kinds(cfgs[0])[0], _layer_kinds(cfgs[1])[0]
    # against the loop engine (the same GEMM batches as a rank): the
    # prefill's E, every free-running round's logits and the greedy tokens
    # bit for bit
    E, logits, toks0 = lm[0]["serve"][5], lm[0]["serve"][6], lm[0]["serve"][0]
    res["lm_vs_loop"] = {
        "prefill_E_max_abs": float(np.abs(E - loop[5]).max()),
        "logits_max_abs": float(np.abs(logits - loop[6]).max()),
        "tokens_equal": bool(np.array_equal(toks0, loop[0]))}
    log("sharded", f"rank 0 against the loop engine: prefill E max "
                   f"|difference| {res['lm_vs_loop']['prefill_E_max_abs']!r}, "
                   f"the {SHARDED_LM_ROUNDS} greedy rounds' logits "
                   f"{res['lm_vs_loop']['logits_max_abs']!r}, tokens "
                   f"identical {res['lm_vs_loop']['tokens_equal']} (all bit "
                   f"for bit required)")
    if res["lm_vs_loop"] != {"prefill_E_max_abs": 0.0, "logits_max_abs": 0.0,
                             "tokens_equal": True}:
        failures.append("qwen2.5-3b: the sharded prefill, logits or tokens "
                        "differ from the loop engine's")
    # against the vectorized engine: the prefill's E bit for bit; the
    # decode rounds as information, each fed the vectorized engine's tokens
    # (teacher forcing): its passive decode attention runs the float32
    # probs x V GEMM over all K parties at once, which cuBLAS rounds
    # otherwise than one party's (tests/test_torch_cuda.py::
    # test_cuda_decode_attention_rounds_by_party_batch; ROADMAP.md queue 3)
    forced = lm[0]["forced"]
    want = vec[6]
    diffs = [float(np.abs(forced[:, i] - want[:, i]).max())
             for i in range(SHARDED_LM_ROUNDS)]
    rel = [d / float(np.abs(want[:, i]).max()) for i, d in enumerate(diffs)]
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]                   # (lanes, rounds)
    agree = forced.argmax(-1) == want.argmax(-1)
    free_same = [bool(np.array_equal(r["serve"][0], vec[0]))
                 for r in lm.values()]
    first = [int(np.argmax(~(toks0[b] == vec[0][b])))
             if not np.array_equal(toks0[b], vec[0][b]) else None
             for b in range(SHARDED_LM_LANES)]
    res["lm_vs_vectorized"] = {
        "prefill_E_max_abs": float(np.abs(E - vec[5]).max()),
        "forced_logits_max_abs_by_round": diffs,
        "forced_logits_rel_by_round": rel,
        "min_top2_margin_by_round": margin.min(axis=0).tolist(),
        "forced_tokens_equal": int(agree.sum()),
        "free_run_tokens_equal_by_rank": free_same,
        "free_run_first_difference_by_lane": first,
        "loop_free_run_tokens_equal": bool(np.array_equal(loop[0], vec[0]))}
    log("sharded", f"rank 0 against the vectorized engine: prefill E max "
                   f"|difference| {res['lm_vs_vectorized']['prefill_E_max_abs']!r} "
                   f"(bit for bit required); as information, the "
                   f"teacher-forced rounds' logits max |difference| by round "
                   f"{diffs}, relative to the round's max |logit| {rel}; "
                   f"greedy tokens equal in {int(agree.sum())} of "
                   f"{agree.size} (lane, round)s; the free-running tokens "
                   f"equal the vectorized engine's on every rank "
                   f"{free_same}, first difference by lane {first}, the loop "
                   f"engine's equal them "
                   f"{res['lm_vs_vectorized']['loop_free_run_tokens_equal']} "
                   f"(the smallest top-2 margin by round "
                   f"{[round(m, 4) for m in margin.min(axis=0).tolist()]})")
    if res["lm_vs_vectorized"]["prefill_E_max_abs"] != 0.0:
        failures.append("qwen2.5-3b: the prefill E differs from the "
                        "vectorized engine's")
    for rank, r in lm.items():
        toks, pre_ms, round_ms, pre, per_rounds = r["serve"][:5]
        if not np.array_equal(toks, lm[0]["serve"][0]):
            failures.append(f"qwen2.5-3b rank {rank}: its tokens differ "
                            f"from rank 0's")
        want = {"flash_attention_fwd": attn_p + (attn_a if rank == 0 else 0),
                "blind_agg_fwd": 1 if rank == 0 else 0}
        for name, n in want.items():
            if pre[name] != n or per_rounds["flash_attention_fwd"] != 0 or \
                    per_rounds["blind_agg_fwd"] != (SHARDED_LM_ROUNDS
                                                    if rank == 0 else 0):
                failures.append(f"qwen2.5-3b rank {rank}: prefill "
                                f"launches {pre}, decode {per_rounds}")
    paths.append(_sum_launches([lm[r]["serve"][3] for r in lm]
                               + [lm[r]["serve"][4] for r in lm]))
    res["lm"] = {"prefill_ms_by_rank": {k: v["serve"][1]
                                        for k, v in lm.items()},
                 "round_ms_by_rank": {k: v["serve"][2]
                                      for k, v in lm.items()},
                 "vectorized_prefill_ms": vec[1],
                 "vectorized_round_ms": vec[2],
                 "draw_s_by_rank": {k: v["draw_s"] for k, v in lm.items()},
                 "weights_gb_by_rank": {k: v["weights_gb"]
                                        for k, v in lm.items()},
                 "rows_by_rank": {k: v["rows"] for k, v in lm.items()}}
    log("sharded", f"{cfg.name} at full width and depth, bfloat16, K = 3 "
                   f"over {SHARDED_LM_RANKS} ranks (passive rows "
                   f"{res['lm']['rows_by_rank']}): {SHARDED_LM_LANES} lanes, "
                   f"{SHARDED_LM_PROMPT - 1}-token prefill then "
                   f"{SHARDED_LM_ROUNDS} greedy rounds, the same tokens "
                   f"on every rank (failures so far {len(failures)}); "
                   f"prefill ms by rank {res['lm']['prefill_ms_by_rank']} "
                   f"(vectorized {vec[1]:.1f}), ms a round by rank "
                   f"{res['lm']['round_ms_by_rank']} (vectorized "
                   f"{vec[2]:.2f}); flash_attention_fwd a prefill: rank 0 "
                   f"{attn_a} + {attn_p}, ranks 1-2 {attn_p}; blind_agg_fwd "
                   f"on rank 0 only; weights GB by rank "
                   f"{res['lm']['weights_gb_by_rank']}")
    # the 4-layer float32 cut against the reference (the CPU port, or one
    # process on one card)
    E, logits, out = lm[0]["cut"]
    cE, clogits, cout = (t.numpy() for t in cut_ref["ref"])
    errs = {}
    for what, a, b in (("prefill embeddings", E, cE),
                       ("logits", logits, clogits)):
        errs[what] = (float(np.abs(a - b).max()),
                      bool(np.allclose(a, b, rtol=1e-4, atol=1e-5)))
    same = all(np.array_equal(r["cut"][2], cout) for r in lm.values())
    res["lm_cut"] = {"errors": errs, "tokens_equal": same}
    log("sharded", f"{cfg.name} cut to {LM_CUT_LAYERS} layers, float32, "
                   f"over {SHARDED_LM_RANKS} ranks, against "
                   f"{cut_ref['label']}: "
                   + "; ".join(f"{w} max abs {e:.3g} "
                               f"{'ok' if ok else 'FAIL'} (rtol 1e-4, atol "
                               f"1e-5)" for w, (e, ok) in errs.items())
                   + f"; tokens identical on every rank {same}")
    if not same or not all(ok for _, ok in errs.values()):
        failures.append(f"the sharded depth cut differs from "
                        f"{cut_ref['label']}")
    res["peak_gb_by_rank"] = {r["rank"]: (r["many_peak_gb"],
                                          r.get("lm_peak_gb"))
                              for r in ranks}
    res["seconds"] = time.perf_counter() - t_phase
    res["card"] = _card()
    log("sharded", f"peak device memory by rank (many-party, LM) GB "
                   f"{res['peak_gb_by_rank']}; phase took "
                   f"{res['seconds']:.1f} s on {res['card']}")
    if failures:
        raise AssertionError("sharded phase: " + "; ".join(failures))
    return paths, res


# ---------------------------------------------------------------------------
# the FSDP plan: 4 ranks share the card over gloo as a 2 x 2 mesh
# ---------------------------------------------------------------------------

# (a)'s steps: at full depth 3 took 62 + 41 + 41 s a rank over gloo and 2
# took 73 + 48 (H100 80GB HBM3 at 700 W; PERF.md), past the phase's 180
# s with (b) and (c); at 14 layers the phase fit, but the whole script
# took ~1,010 s of the 1000 asked; so 2 steps at 8 layers; since (e)-(g)
# joined the phase, 6 layers (three 2-layer proxies)
FSDP_RANKS, FSDP_MESH, FSDP_STEPS, FSDP_TRAIN_LAYERS = 4, (2, 2), 2, 6
FSDP_CUT_LAYERS, FSDP_CUT_BATCH, FSDP_CUT_SEQ, FSDP_LR = 2, 4, 128, 1e-3
FSDP_SERVE_LAYERS, FSDP_SERVE_LANES = 2, 4
FSDP_SERVE_PROMPT, FSDP_SERVE_ROUNDS = 64, 4
# (d): qwen2.5-3b at full width and depth under the tensor-parallel
# compute, 4 lanes (2 a data rank) of 512-token prompts, 4 greedy rounds
# (16 before (h) joined the phase: a round moves the same bytes and
# launches the same kernels as the last, and (e) covers the main path)
FSDP_FULL_LANES, FSDP_FULL_PROMPT, FSDP_FULL_ROUNDS = 4, 512, 4
# (d)'s round 0 is teacher-forced (it feeds the prompt's last token): its
# logits are held to the one process's on the same weights within 2^-4 of
# their largest magnitude (bfloat16 partials rounded before their sum over
# the model ranks; 0.0282 of it measured on the H100, about 7 bfloat16
# ulps; a wrong head, block or reduction moves them by the order of 1)
FSDP_FULL_LOGIT_REL = 2.0 ** -4
# (e)-(g): the split MoE, SSD and RG-LRU stacks at full width under the
# tensor-parallel compute, served as (d): (key, arch, mesh (data, model),
# active layers (None: full depth), greedy rounds, the active layers of a
# float32 cut run beside it (None: none), the limit on round 0's logits
# against the one process's, as a share of its largest |logit| (None:
# printed)). (g) is cut to two whole (lru, lru, attn) repeats: at full
# depth (38 layers) it took 45 s of the ranks' work and the phase 233 s
# (H100 80GB HBM3, 700 W). (f) is cut to 16 layers, its float32 cut's
# depth: at 64 its 4 rounds, each all-gathering 0.60 GB of SSD states
# over gloo, and its prefill took 18.6 s of the ranks' 129 (H100 80GB
# HBM3, 700 W; --phase split_depth holds it at 64). Each runs 4 greedy
# rounds: a round moves the
# same bytes and launches the same kernels as the last, and (e)'s and
# (f)'s 16 took 40 s of the phase. In bfloat16 the round-0 logits part
# from the one process's with depth, each rounding amplified layer by
# layer (H100 80GB HBM3, 700 W; --phase split_depth): (f) 0.031 of the
# largest |logit| at 16 layers and 0.0715 at 64, the size of the one
# process's own bfloat16 error against its float32 run (0.031, 0.069):
# (f) is held within 2^-3. (e) 0.023 at 2 layers, 0.123 at 6 (0.107 from
# the float32 one process, whose own bfloat16 run is 0.028 from it: the
# split rounds each rank's partial sum to bfloat16 and gloo sums them in
# bfloat16) and 0.862 at 24, near the largest |logit| itself, where no
# limit tells a fault from rounding: (e) is printed. Each of (e) and (f)
# also runs a float32 cut at full width on the same mesh, held to the
# one process within FSDP_SPLIT_F32_REL of the largest |logit|: 6 layers
# for (e) and 16 for (f), layers past the first two checked against one
# process
FSDP_RG_LAYERS, FSDP_SPLIT_F32_REL, FSDP_SPLIT_ROUNDS = 6, 1e-4, 4
FSDP_SSD_LAYERS = 16
FSDP_SPLIT = (("e", MOE_ARCH, (1, 4), None, FSDP_SPLIT_ROUNDS, 6, None),
              ("f", MAMBA_ARCH, (2, 2), FSDP_SSD_LAYERS, FSDP_SPLIT_ROUNDS,
               16, 2.0 ** -3),
              ("g", RG_ARCH, (1, 4), FSDP_RG_LAYERS, FSDP_SPLIT_ROUNDS, None,
               FSDP_FULL_LOGIT_REL))


# (h): whisper-small at full width and depth (12 encoder and 12 decoder
# layers, 12/12 heads of 64: 3 a rank) on a 1 x 4 mesh, its encoder, cross
# K/V and cross-attention on each rank's heads: 4 lanes of 1500-frame
# audio (models/build.frontend_inputs, the card's generator seeded
# FSDP_H_AUDIO_SEED) through encoder_kv under the plan, 64-token prompts,
# 4 greedy rounds, held as (d)
FSDP_H_MESH, FSDP_H_PROMPT, FSDP_H_AUDIO_SEED = (1, 4), 64, 9
# (i), --phase tsplit: qwen2-1.5b at full width and depth on a 1 x 3 mesh
# (three ranks sharing the card), whose 12/2 heads do not divide 3: each
# attention runs whole over its cache's T block (516 = 512 + 4 slots, 172
# a rank), the ranks' partial softmax merged; 4 lanes of 512-token
# prompts, 4 greedy rounds, held as (d)
TSPLIT_RANKS, TSPLIT_MESH, TSPLIT_ARCH = 3, (1, 3), TRAIN_ARCH


def _fsdp_batches(cfg):
    from repro_torch.data.synthetic import lm_batch_iterator
    it = lm_batch_iterator(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    return [next(it) for _ in range(FSDP_STEPS)]


def _fsdp_cut_batch(cfg):
    from repro_torch.data.synthetic import lm_batch_iterator
    return next(lm_batch_iterator(cfg.vocab_size, FSDP_CUT_BATCH,
                                  FSDP_CUT_SEQ, seed=1))


def _fsdp_cfgs():
    """(qwen2-1.5b cut to FSDP_TRAIN_LAYERS, its float32 depth cut,
    qwen2.5-3b's float32 depth cut)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(TRAIN_ARCH)
    return (dataclasses.replace(cfg, n_layers=FSDP_TRAIN_LAYERS),
            dataclasses.replace(cfg, n_layers=FSDP_CUT_LAYERS,
                                dtype="float32"),
            dataclasses.replace(get_config(LM_ARCH),
                                n_layers=FSDP_SERVE_LAYERS, dtype="float32"))


def _fsdp_step_loop(run, params, opt_state, batches):
    """FSDP_STEPS train steps through ``run`` (a built or sharded step):
    (params, opt_state, total losses, ms a step, launches)."""
    import torch
    losses, ms = [], []
    _reset_lm_launches()
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = run(params, opt_state, b, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return params, opt_state, losses, ms, _lm_launches()


def _fsdp_one_process(cfg, batches):
    """(a)'s one-process run on the card: qwen2-1.5b's step (adam 1e-3,
    clip 1.0) on the whole batch."""
    import torch
    from repro_torch.launch import dryrun, steps
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    sys_ = _lm_system(cfg, "cuda")
    params = sys_.init_params(torch.Generator(device="cuda").manual_seed(0))
    step, opt = steps.build_train_step(sys_, "adam", lr=1e-3)
    state = opt.init({"parties": params["parties"]})
    on = lambda b: {k: torch.as_tensor(v, device="cuda")
                    for k, v in b.items()}
    params, state, losses, ms, launches = _fsdp_step_loop(
        step, params, state, [on(b) for b in batches])
    _check_train_launches("one-process qwen2-1.5b", launches, FSDP_STEPS)
    w = dryrun.tree_bytes({"parties": params["parties"]})
    out = {"losses": losses, "step_ms": ms, "weights": w, "grads": w,
           "adam": dryrun.tree_bytes(state),
           "peak": torch.cuda.max_memory_allocated()}
    del params, state, step, opt, sys_
    _free_card()
    return out


def _fsdp_rank(batches, cut_batch, prompt, prompt_full, prompts_split, ref_dir,
               go, t_spawn):
    """One rank of the fsdp phase: started while the parent's one-process
    runs hold the card, it joins the group and waits for the file ``go``;
    then (a) qwen2-1.5b under zero3 + ZeRO-1, (b) its float32 cut's joint
    adam step under tp, its blocks held against the CPU port's step
    (``ref_dir``, written by the parent meanwhile), (c) qwen2.5-3b's
    float32 cut served under serve_shardings, (d) qwen2.5-3b at full width
    and depth served under the tensor-parallel compute
    (``prompt_full``), (e)-(g) the split MoE, SSD and RG-LRU stacks
    (``FSDP_SPLIT``, ``prompts_split``) and (h) whisper-small; results for
    the parent, numpy, with the seconds each part ended at
    (``marks``)."""
    import torch
    from repro_torch.configs.base import EasterConfig
    from repro_torch.core.easter_lm import EasterLM
    from repro_torch.launch import mesh
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    m = mesh.make_debug_mesh(*FSDP_MESH, device="cuda")
    # the other shapes of the same ranks, made by every rank in one order
    meshes = {tuple(FSDP_MESH): m}
    for shape in sorted({sh for _, _, sh, *_ in FSDP_SPLIT}
                        | {FSDP_H_MESH} - set(meshes)):
        meshes[shape] = mesh.make_debug_mesh(*shape, device="cuda")
    torch.zeros((), device=m.device)            # this rank's CUDA context
    res = {"rank": m.rank, "coords": dict(m.coords), "backend": m.backend,
           "device": str(m.device),
           "start_s": time.time() - t_spawn,
           "loaded_s": LOADED_AT - t_spawn,
           "in_group_s": time.time() - t_spawn - (time.perf_counter()
                                                  - t_start),
           "marks": {}}
    mark = lambda k: res["marks"].__setitem__(
        k, round(time.perf_counter() - t_start, 2))
    mark("mesh")
    res["all_gather_gbps"] = _group_rate(m)
    mark("all-gather probe")
    _wait_go(go)
    t_go = time.perf_counter()
    mark("go")
    cfg, cut, serve_cfg = _fsdp_cfgs()
    on = lambda b: {k: torch.as_tensor(v, device="cuda")
                    for k, v in b.items()}
    # (a) full width: zero3 + ZeRO-1, one row a rank
    res["a"] = _fsdp_train_a(m, cfg, [on(b) for b in batches])
    mark("(a) steps")
    log("fsdp", f"rank {m.rank}: (a) losses {res['a']['losses']}, ms a step "
                f"{[round(x, 1) for x in res['a']['step_ms']]}, peak "
                f"{res['a']['peak'] / 1e9:.2f} GB; all-gather "
                f"{res['all_gather_gbps']} GB/s; {res['marks']}")
    torch.cuda.reset_peak_memory_stats()
    # (b) the float32 cut: one joint adam step under tp (blind_agg_bwd),
    # each rank's blocks against the CPU port's whole leaves
    sys_ = EasterLM(cut, EasterConfig(), grad_mode="joint", device="cuda")
    run, lp, lo, lbs, pspec = _fsdp_sharded_train(sys_, m, "adam", "tp",
                                                  False, [on(cut_batch)])
    mark("(b) drawn and cut")
    lp, lo, losses, _, launches = _fsdp_step_loop(run, lp, lo, lbs)
    mark("(b) step")
    # the blocks wait on the host for the CPU port's step (the parent's
    # thread), compared once (c)-(h) are served
    b_blocks = tree_map(lambda t: t.detach().cpu(),
                        {"parties": lp["parties"]})
    b_spec = pspec
    res["b"] = {"loss": losses[0], "launches": launches,
                "peak": torch.cuda.max_memory_allocated()}
    del run, lo, lp, lbs, sys_
    _free_card()
    # (c) serving: a 4-lane prefill and greedy rounds under serve_shardings
    sys_ = _lm_system(serve_cfg, "cuda")
    res["c"] = _fsdp_serve(sys_, m, prompt)
    mark("(c) served")
    log("fsdp", f"rank {m.rank}: (c) tokens {res['c']['tokens'].tolist()}; "
                f"{res['marks']}")
    del sys_
    _free_card()
    # (d) the full-width, full-depth path under the tensor-parallel compute
    sys_ = _lm_system(_fsdp_full_cfg(), "cuda")
    res["d"] = _fsdp_serve(sys_, m, prompt_full, FSDP_FULL_ROUNDS,
                           detail=True)
    mark("(d) served")
    d = res["d"]
    log("fsdp", f"rank {m.rank}: (d) prefill {d['prefill_ms']:.1f} ms, ms a "
                f"round {[round(x, 1) for x in d['round_ms']]}, resident "
                f"{d['resident'] / 1e9:.3f} GB, peak {d['peak'] / 1e9:.2f} "
                f"GB; {res['marks']}")
    del sys_
    _free_card()
    # (e)-(g) the split MoE, SSD and RG-LRU stacks, every rank drawing its
    # blocks at once
    for key, cfg_, shape, rounds in _fsdp_split_runs():
        sys_ = _lm_system(cfg_, "cuda")
        res[key] = r = _fsdp_serve(sys_, meshes[shape],
                                   prompts_split[key[0]], rounds, detail=True)
        mark(f"({key}) served")
        log("fsdp", f"rank {m.rank}: ({key}) prefill {r['prefill_ms']:.1f} "
                    f"ms, ms a round {[round(x, 1) for x in r['round_ms']]}, "
                    f"resident {r['resident'] / 1e9:.3f} GB, peak "
                    f"{r['peak'] / 1e9:.2f} GB; {res['marks']}")
        del sys_
        _free_card()
    res["b"].update(_fsdp_compare_blocks(b_blocks, b_spec, m, ref_dir,
                                         adam=True))
    mark("(b) compared")
    log("fsdp", f"rank {m.rank}: (b) loss {res['b']['loss']}, blocks max "
                f"abs {res['b']['max_abs']:.3g} ok {res['b']['ok']}, peak "
                f"{res['b']['peak'] / 1e9:.2f} GB; {res['marks']}")
    res["work_s"] = time.perf_counter() - t_go
    return res


def _then_ranks(go, runs):
    """``runs()`` (the parent's one-process runs, with the card to
    itself), then the word to the ranks waiting on the file ``go``
    (``_wait_go``): "go", or "stop" if ``runs`` raised, so that they fail
    at once instead of waiting out their spawn's timeout."""
    word = "stop"
    try:
        out = runs()
        word = "go"
    finally:
        with open(go + ".part", "w") as f:
            f.write(word)
        os.replace(go + ".part", go)
    return out


def _wait_go(go):
    """A rank's wait for ``_then_ranks``' word; raises on "stop"."""
    while not os.path.exists(go):
        time.sleep(0.1)
    with open(go) as f:
        if f.read() != "go":
            raise RuntimeError("the parent's one-process runs failed")


def _fsdp_sharded_train(sys_, m, opt_name, layout, zero1, batch_list,
                        lr=FSDP_LR, run_mesh=None):
    """``sys_``'s train step under the plan of ``m`` (``run_mesh``: the
    mesh its collectives go through, a RecordingMesh over ``m``; default
    ``m``), from the card's generator seeded 0: (the step, this rank's
    blocks of the parameters and optimizer state, its rows of each batch,
    the parameters' specs). The whole tree is drawn, cut and freed."""
    import torch
    from repro_torch import sharding
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    params = sys_.init_params(torch.Generator(device="cuda").manual_seed(0))
    step, opt = steps.build_train_step(sys_, opt_name, lr=lr)
    mp = tree_map(lambda t: torch.empty_like(t, device="meta"),
                  {"parties": params["parties"]})
    in_sh, out_sh = steps.train_shardings(
        sys_, m, {"batch": batch_list[0]}, params, opt.init(mp),
        zero1=zero1, layout=layout)
    pspec, ospec, bspec, _ = in_sh
    lp = sharding.shard_tree(params, pspec, m)
    del params
    _free_card()
    lo = sharding.init_opt_state(opt, lp, pspec, ospec, m)
    lbs = [sharding.shard_tree(b, bspec, m) for b in batch_list]
    run = steps.shard_step(step, run_mesh or m, in_sh, out_sh, layout)
    return run, lp, lo, lbs, pspec


def _fsdp_train_a(m, cfg, batches):
    """(a) on this rank: ``cfg`` (qwen2-1.5b) under zero3 + ZeRO-1 on the
    mesh ``m``, adam 1e-3, FSDP_STEPS steps on ``batches`` (on the card):
    losses, ms a step, launches, the resident bytes of the blocks by kind,
    the rows a rank, the devices of its blocks and the peak memory."""
    import torch
    from repro_torch.launch import dryrun
    torch.cuda.reset_peak_memory_stats()
    sys_ = _lm_system(cfg, "cuda")
    run, lp, lo, lbs, _ = _fsdp_sharded_train(sys_, m, "adam", "zero3", True,
                                              batches)
    lp, lo, losses, ms, launches = _fsdp_step_loop(run, lp, lo, lbs)
    w = dryrun.tree_bytes({"parties": lp["parties"]})
    out = {"losses": losses, "step_ms": ms, "launches": launches,
           "weights": w, "grads": w, "adam": dryrun.tree_bytes(lo),
           "rows": int(lbs[0]["tokens"].shape[0]),
           "devices": _devices([lp, lo]),
           "peak": torch.cuda.max_memory_allocated()}
    del run, lp, lo, lbs, sys_
    _free_card()
    return out


def _fsdp_check_train(tag, ranks, one, failures, cfg, shape):
    """(a)'s checks (failures appended) and numbers: one blind_agg_fwd a
    step on every rank, the same finite losses on every rank, step 0
    within rtol 1e-2 of the one process's; ms a step, resident and peak
    bytes by rank beside the one process's."""
    a = {r["rank"]: r["a"] for r in ranks}
    for rank, ra in a.items():
        try:
            _check_train_launches(f"{tag} (a) rank {rank}", ra["launches"],
                                  FSDP_STEPS)
        except AssertionError as e:
            failures.append(str(e))
        if ra["losses"] != a[0]["losses"] or not all(
                math.isfinite(v) for v in ra["losses"]):
            failures.append(f"(a) rank {rank}: losses {ra['losses']} vs "
                            f"rank 0's {a[0]['losses']}")
    if abs(a[0]["losses"][0] - one["losses"][0]) > 1e-2 * abs(
            one["losses"][0]):
        failures.append(f"(a) step 0's loss {a[0]['losses'][0]} vs the one "
                        f"process's {one['losses'][0]} (rtol 1e-2)")
    resident = {k: a[k]["weights"] + a[k]["grads"] + a[k]["adam"] for k in a}
    one_res = one["weights"] + one["grads"] + one["adam"]
    out = {"losses_rank0": a[0]["losses"],
           "losses_one_process": one["losses"],
           "step_ms_by_rank": {k: v["step_ms"] for k, v in a.items()},
           "step_ms_one_process": one["step_ms"],
           "resident_bytes_by_rank": resident,
           "resident_bytes_one_process": one_res,
           "adam_bytes_by_rank": {k: v["adam"] for k, v in a.items()},
           "peak_bytes_by_rank": {k: v["peak"] for k, v in a.items()},
           "peak_bytes_one_process": one["peak"],
           "rows_by_rank": {k: v["rows"] for k, v in a.items()},
           "params": _fsdp_n_params(cfg), "layers": cfg.n_layers}
    log(tag, f"(a) {cfg.name} at full width, {cfg.n_layers} layers (three "
             f"{_lm_system(cfg, 'meta').party_cfgs[1].n_layers}-layer "
             f"proxies; {out['params']} parameters), bfloat16, remat "
             f"{cfg.remat}, adam 1e-3 clip 1.0, {TRAIN_BATCH} x "
             f"{TRAIN_SEQ} tokens a step over a {shape[0]} x {shape[1]} mesh "
             f"(zero3 + ZeRO-1, rows a rank {out['rows_by_rank']}), "
             f"{len(ranks)} ranks on {ranks[0]['backend']}: losses rank 0 "
             f"{[round(v, 4) for v in a[0]['losses']]} vs one process "
             f"{[round(v, 4) for v in one['losses']]}; ms a step by rank "
             f"{ {k: [round(x, 1) for x in v['step_ms']] for k, v in a.items()} } "
             f"(one process {[round(x, 1) for x in one['step_ms']]}); "
             f"resident weights + gradients + adam GB by rank "
             f"{ {k: round(v / 1e9, 3) for k, v in resident.items()} } "
             f"(one process {one_res / 1e9:.3f}); "
             f"torch.cuda.max_memory_allocated GB by rank "
             f"{ {k: round(v['peak'] / 1e9, 2) for k, v in a.items()} } "
             f"(one process {one['peak'] / 1e9:.2f})")
    return out


def _fsdp_split_cfg(arch, layers=None, dtype=None):
    """``arch``'s config, cut to ``layers`` active layers and in ``dtype``
    where given."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    kw = {k: v for k, v in (("n_layers", layers), ("dtype", dtype))
          if v is not None}
    return dataclasses.replace(cfg, **kw)


def _fsdp_split_runs():
    """(key, config, mesh, rounds) of every split-block run of the fsdp
    phase: each FSDP_SPLIT path, then its float32 cut ("e32", "f32"), one
    teacher-forced round, then (h) whisper-small."""
    runs = [(key, _fsdp_split_cfg(arch, layers), shape, rounds)
            for key, arch, shape, layers, rounds, *_ in FSDP_SPLIT]
    return runs + [(key + "32", _fsdp_split_cfg(arch, cut, "float32"),
                    shape, 1)
                   for key, arch, shape, _, _, cut, _ in FSDP_SPLIT if cut] \
        + [("h", _fsdp_split_cfg(WHISPER_ARCH), FSDP_H_MESH,
            FSDP_SPLIT_ROUNDS)]


def _draw_blocks(sys_, gen, pspec, m, full):
    """This rank's blocks of ``sys_.init_params(gen)`` (the one process's
    bits: every leaf drawn from ``gen`` in the same order) without holding
    the whole tree: each layer stack's rows cut to this rank's block as
    they are drawn (``transformer.stack_drawn`` swapped for a cutting one
    during the draw; a stack row's spec is the stacked leaf's without its
    first entry, which no axis of more than one rank splits), the other
    leaves (tables, norms, the decision MLPs) cut once it ends. ``full``:
    the whole tree on the meta device. The draw holds this rank's blocks,
    one drawn layer and every party's whole tables."""
    import torch
    from repro_torch import sharding
    from repro_torch.core.party_engine import unstack_tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map
    fsdp = steps.use_fsdp(sys_)
    P, zip3 = sharding.P, sharding._zip3

    def cutting(draw, n, empty=None):
        out = None
        for i in range(n):
            tree = draw(i)
            if out is None:
                meta = tree_map(lambda a: torch.empty(
                    (n,) + tuple(a.shape), dtype=a.dtype, device="meta"),
                    tree)
                specs = sharding.param_specs(meta, m, fsdp)
                if any(s[0] is not None and m.axis_size(s[0]) > 1
                       for s in sharding.spec_leaves(specs)):
                    raise AssertionError("a layer stack split by its rows")
                out = zip3(lambda a, mt, s: a.new_empty(sharding.local_shape(
                    mt.shape, s, m)), tree, meta, specs)
            zip3(lambda dst, src, s: dst[i].copy_(sharding.local_block(
                src, P(*tuple(s)[1:]), m)), out, tree, specs)
            del tree
        return out

    plain = transformer.stack_drawn
    transformer.stack_drawn = cutting
    try:
        params = sys_.init_params(gen)
    finally:
        transformer.stack_drawn = plain

    def cut(x, s, f):
        want = sharding.local_shape(f.shape, s, m)
        if tuple(x.shape) == want and want != tuple(f.shape):
            return x                                     # cut as drawn
        return sharding.local_block(x, s, m).clone()
    out = {"passive_stacked": zip3(cut, params["passive_stacked"],
                                   pspec["passive_stacked"],
                                   full["passive_stacked"])}
    K = len(params["parties"]) - 1
    out["parties"] = [zip3(cut, params["parties"][0], pspec["parties"][0],
                           full["parties"][0])] + unstack_tree(
        out["passive_stacked"], K)
    return out


def _fsdp_full_cfg():
    from repro_torch.configs.base import get_config
    return get_config(LM_ARCH)


def _fsdp_full_one_process(prompt, cfg=None, rounds=FSDP_FULL_ROUNDS):
    """(d)'s (or ``cfg``'s: (e)-(g)) one process on the card: the same
    weights (the card's generator seeded 0), prompt and greedy rounds."""
    _free_card()
    sys_ = _lm_system(cfg or _fsdp_full_cfg(), "cuda")
    out = _fsdp_serve(sys_, None, prompt, rounds)
    del sys_
    _free_card()
    return out


def _fsdp_overlay_identity(cfg, shape):
    """Where the data axis has one rank, use_fsdp's overlay (over 1e10
    parameters) leaves every leaf's block as it is: the failures, none
    expected."""
    from repro_torch import sharding
    from repro_torch.launch import mesh, steps
    from repro_torch.tree import tree_leaves
    params = steps.abstract_params(_lm_system(cfg, "meta"))
    am = mesh.abstract_mesh(shape, ("data", "model"))
    leaves = tree_leaves(params)
    blocks = [[sharding.local_shape(x.shape, s, am) for x, s in zip(
        leaves, sharding.spec_leaves(sharding.param_specs(params, am, f)))]
        for f in (True, False)]
    return [] if blocks[0] == blocks[1] else [
        f"{cfg.name} on {shape}: the FSDP overlay changes a block"]


def _group_rate(m):
    """The mesh's all-gather over all its ranks, 16 MB a rank, of a tensor
    on the rank's device (a card: NCCL, or under gloo staged through the
    host) and of a host tensor (gloo, also the NCCL group's host half):
    GB/s by the bytes gathered, the best of three, beside the backend
    that carries the device's tensors; and the microseconds of one small
    all-reduce on the device (16 KB, a decode round's exit size), the
    best of three runs of 20 back to back."""
    import torch

    def best(fn, reps=1):
        t = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                y = fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) / reps)
        return min(t), y

    out = {"backend": m.backend}
    for where, dev in (("device", m.device), ("host", "cpu")):
        x = torch.ones(4 * 2 ** 20, device=dev)
        dt, y = best(lambda: m.all_gather(x, m.axis_names))
        out[where] = round(y.numel() * 4 / dt / 1e9, 3)
    # one decode round's exit: an all-reduce of (4, 1, 2048) bfloat16
    x = torch.ones((4, 1, 2048), dtype=torch.bfloat16, device=m.device)
    out["small_all_reduce_us"] = round(best(
        lambda: m.all_reduce(x, m.axis_names), 20)[0] * 1e6, 1)
    return out


def _fsdp_compare_blocks(lp, pspec, m, ref_dir, adam=False, before=None):
    """This rank's blocks of a train step's updated parameters against the
    same blocks of a one-process step's whole leaves (``ref_dir``: one .npy
    a leaf, written by the parent: the CPU port's for (b), one process's on
    one card for (k); read mapped, a block at a time), with no parameter
    crossing the ranks: within rtol 1e-4 / atol 1e-5; after ``adam``'s
    first step (about lr sign(g)) only where the clipped |g| >= 1e-4 (a
    mask a leaf beside it) and within 2 lr + 1e-5 elsewhere. With
    ``before`` (this rank's blocks before the step, by leaf) also the
    share of the elements that the step moved by more than that atol
    (``moved``): what the tolerance sees of the step."""
    import numpy as np
    import torch
    from repro_torch import sharding
    from repro_torch.tree import tree_leaves
    done = os.path.join(ref_dir, "done")
    t0 = time.perf_counter()
    while not os.path.exists(done):
        if time.perf_counter() - t0 > 600:
            raise TimeoutError("the one-process step never arrived")
        time.sleep(0.5)
    load = lambda k, i, s: sharding.local_block(torch.from_numpy(np.load(
        os.path.join(ref_dir, f"{k}{i}.npy"), mmap_mode="r")), s, m)
    worst, ok, moved, n = 0.0, True, 0, 0
    for i, (x, s) in enumerate(zip(
            tree_leaves({"parties": lp["parties"]}),
            sharding.spec_leaves({"parties": pspec["parties"]}))):
        x = x.detach().float()
        ref = load("p", i, s).to(x.device).float()
        d = (x - ref).abs()
        worst = max(worst, float(d.max()))
        if adam:
            big = load("g", i, s).to(x.device)
            ok = ok and bool(torch.allclose(x[big], ref[big], rtol=1e-4,
                                            atol=1e-5)) \
                and bool((d <= 2 * FSDP_LR + 1e-5).all())
        else:
            ok = ok and bool(torch.allclose(x, ref, rtol=1e-4, atol=1e-5))
        if before is not None:
            moved += int(((x - before[i].float()).abs() > 1e-5).sum())
            n += x.numel()
    return {"max_abs": worst, "ok": ok, "moved": moved / max(n, 1)}


def _fsdp_serve(sys_, m, prompt, rounds=FSDP_SERVE_ROUNDS, detail=False):
    """A len(prompt)-lane prefill of ``prompt[:, :-1]`` into caches of
    prompt + rounds slots, then ``rounds`` greedy decode rounds from its
    last token: (E, logits by round, tokens, launches), numpy. An
    encoder-decoder first runs ``encoder_kv`` on 1500-frame audio
    (``models/build.frontend_inputs``, the generator seeded
    FSDP_H_AUDIO_SEED; under a mesh on this rank's rows and heads), whose
    cross K/V every step reads; its ms, launches, bytes and the cross
    K/V's bytes are reported apart (``encoder_*``). With a
    mesh ``m`` each step runs under the plan on this rank's blocks (the
    prefill's specs from prefill_shardings, the rounds' from
    serve_shardings; the ranks draw the weights in turns, each keeping its
    blocks only, ``_draw_blocks``: a rank's draw holds the whole tables
    and a drawn layer beside its blocks, and four such at once overflow
    the card at qwen2-moe-a2.7b's width; ranks with a card each draw at
    once); without, in one process.
    ``detail``
    (the (d) path, under a mesh): instead of E and the logits, whether
    every logit is finite and each round's logits' digest; the prefill's
    and each round's ms, the launches of the prefill and of the rounds
    apart, the collectives' bytes by kind of the prefill and of the last
    round (a RecordingMesh over ``m``) and their counts by kind, that
    round's all-gathers of a leaf the model axis splits and of a K/V
    cache or cross K/V (``_kv_gathers``), the rglru_scan_fwd launches of
    the prefill by kernel path, the resident parameter bytes and the peak
    device memory, and the devices of the blocks and caches."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import sharding
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import RecordingMesh
    dev = sys_.device
    gen = torch.Generator(device=dev.type).manual_seed(0)
    B, P = prompt.shape
    T = P - 1 + rounds
    seeds = sys_.mask_seeds()
    toks = torch.as_tensor(prompt, device=dev)

    def prefill(params, batch, *fe):
        caches = sys_.init_caches(batch["tokens"].shape[0], T)
        return sys_.prefill(params, batch["tokens"], caches, seeds=seeds,
                            round_idx=5, fe_list=fe[0] if fe else None)

    serve = steps.build_serve_step(sys_, InputShape("fsdp", T, B, "decode"))
    batch = {"tokens": toks[:, :-1]}
    out = {}
    audio = None
    if sys_.cfg.family == "encdec":
        from repro_torch.models.build import frontend_inputs
        audio = {"tokens": toks[:, :1], **frontend_inputs(
            sys_.cfg, B, torch.Generator(device=dev.type).manual_seed(
                FSDP_H_AUDIO_SEED))}
    encode = lambda params, a: sys_.encoder_kv(params, a["audio_embed"])
    if m is None:
        params = sys_.init_params(gen)
        run_serve = lambda: serve
    else:
        meta = steps.abstract_params(_lm_system(sys_.cfg, "meta"))
        pre_in, pre_out = steps.prefill_shardings(
            sys_, m, {"batch": batch}, meta, _meta_caches(sys_, B, T))
        dec_in, dec_out = steps.serve_shardings(
            sys_, m, {"batch": {"tokens": toks[:, -1:]},
                      "caches": _meta_caches(sys_, B, T)}, meta)
        torch.cuda.reset_peak_memory_stats()
        # ranks sharing a card draw in turns; a card a rank, at once
        turns = range(m.size) if m.backend == "gloo" else [m.rank]
        for r in turns:
            if m.rank == r:
                params = _draw_blocks(sys_, gen, pre_in[0], m, meta)
                _free_card()
            if m.backend == "gloo":
                dist.barrier()
        batch = sharding.shard_tree(batch, pre_in[1], m)
        rec = (lambda: RecordingMesh(m)) if detail else (lambda: m)
        pre_mesh = rec()
        prefill = steps.shard_step(prefill, pre_mesh, pre_in, pre_out)
        if audio is not None:
            a_spec = sharding.batch_specs(audio, m)
            audio = sharding.shard_tree(audio, a_spec, m)
            enc_mesh = rec()
            encode = steps.shard_step(encode, enc_mesh, (pre_in[0], a_spec),
                                      None)
        meshes = []

        def run_serve():
            meshes.append(rec())
            return steps.shard_step(serve, meshes[-1], dec_in, dec_out)
    rows = (lambda t: t) if m is None else \
        (lambda t: sharding.shard_tree({"tokens": t}, dec_in[1], m)["tokens"])
    if m is not None:           # the CPU run (a thread) leaves them alone
        _reset_lm_launches()
    fe = ()
    if audio is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fe = (encode(params, audio),)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["encoder_ms"] = (time.perf_counter() - t0) * 1e3
        out["cross_kv_bytes"] = dryrun.tree_bytes(fe[0])
        if detail:
            out.update(encoder_launches=_lm_launches(),
                       encoder_bytes=dict(enc_mesh.bytes),
                       encoder_counts=_kind_counts(enc_mesh.calls))
        if m is not None:
            _reset_lm_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    E, caches = prefill(params, batch, *fe)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    if detail:
        from repro_torch.kernels import rg_lru as trg
        out.update(prefill_launches=_lm_launches(),
                   prefill_rglru_paths=dict(trg.PATH_LAUNCHES),
                   prefill_bytes=dict(pre_mesh.bytes),
                   prefill_counts=_kind_counts(pre_mesh.calls))
        _reset_lm_launches()
    tok, logits, toks_out, ms = toks[:, -1:], [], [], []
    finite, digests = True, []
    for i in range(rounds):
        step = run_serve()
        t0 = time.perf_counter()
        lg, caches = step(params, {"tokens": rows(tok)}, caches, P - 1 + i,
                          *fe)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        toks_out.append(tok.cpu().numpy())
        ms.append((time.perf_counter() - t0) * 1e3)
        if detail:
            finite = finite and bool(torch.isfinite(lg).all())
            digests.append(hashlib.sha256(
                lg.float().cpu().numpy().tobytes()).hexdigest())
            if i == 0:
                out["first_logits"] = lg.float().cpu().numpy()
        else:
            logits.append(lg.float().cpu().numpy())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = None if m is None else _lm_launches()
    out.update(tokens=np.concatenate(toks_out, 1), launches=launches,
               round_ms=ms, prompt_tokens=P - 1)
    if not detail:
        out.update(E=E.float().cpu().numpy(), logits=np.stack(logits))
        return out
    last = meshes[-1]
    kv_t = set()
    sharding._map_with_path(lambda names, t: kv_t.add(int(t.shape[-3]))
                            if names[-1] in ("k", "v") else None, caches)
    out.update(
        round_launches=launches, finite=finite, kv_cache_t=sorted(kv_t),
        digests=digests, round_bytes=dict(last.bytes),
        round_calls=len(last.calls), round_counts=_kind_counts(last.calls),
        round_weight_gathers=_split_leaf_gathers(
            last.calls, meta, dec_in[0], sys_, m.shape["model"]),
        round_kv_gathers=_kv_gathers(last.calls, sys_, T),
        resident=dryrun.tree_bytes({"parties": params["parties"]}),
        devices=_devices([params, caches]),
        peak=torch.cuda.max_memory_allocated())
    out["launches"] = _sum_launches([out.get("encoder_launches", {}),
                                     out["prefill_launches"], launches])
    return out


def _kind_counts(calls):
    """A recording's collectives counted by kind."""
    out = {}
    for c in calls:
        out[c[0]] = out.get(c[0], 0) + 1
    return out


def _split_leaf_gathers(calls, params, pspec, sys_, m):
    """The recorded all-gathers and broadcasts of a parameter leaf that
    the model axis splits, whole or one layer of it (the passive group's
    K parties stacked in front): under the tensor-parallel compute, none
    but the takes of an attention whose heads do not divide the ``m``
    model ranks, which a round gathers once a layer to run whole. Told
    apart by path and counted by shape: of each shape, the gathers beyond
    the whole attentions' takes of it, so that a split leaf of a whole
    leaf's shape still shows."""
    import collections
    from repro_torch import sharding
    K = sys_.C - 1
    shapes, takes = set(), collections.Counter()

    def one(names, x, s):
        if "model" not in tuple(s):
            return
        active = names[1] == "i0"
        sh = tuple(x.shape)
        shapes.update({sh, sh[1:], sh[2:], (K,) + sh[1:]})
        cfg = sys_.party_cfgs[0 if active else 1]
        if names[1] in ("i0", "i1") and "attn" in names \
                and sharding.attn_mode(cfg.n_heads, cfg.n_kv_heads,
                                       cfg.resolved_head_dim, m) == "whole":
            # a layer's take: the active party's, or the group's at once
            takes[sh[1:] if active else (K,) + sh[1:]] += sh[0]
    sharding._zip_path(one, {"parties": params["parties"]},
                       {"parties": pspec["parties"]})
    seen, out = collections.Counter(), []
    for c in calls:
        if c[0] in ("all-gather", "broadcast") and c[2] in shapes:
            seen[c[2]] += 1
            if seen[c[2]] > takes[c[2]]:
                out.append(c)
    return out


def _kv_gathers(calls, sys_, T):
    """The recorded all-gathers of a K/V cache of T slots, or of an
    encoder-decoder's cross K/V over its frames, whole or a model rank's
    heads (their last three dims): under the tensor-parallel compute,
    none (a cache keeps its heads or T block, the cross K/V its
    heads)."""
    out = []
    for cfg in sys_.party_cfgs:
        hd, hk = cfg.resolved_head_dim, cfg.n_kv_heads
        lens = {T, cfg.n_audio_frames} - {0, 1}
        out += [c for c in calls if c[0] == "all-gather" and len(c[2]) >= 4
                and c[2][-1] == hd and c[2][-3] in lens
                and (c[2][-2] == hk or hk % c[2][-2] == 0)]
    return sorted(set(out))


def _meta_caches(sys_, B, T):
    """``sys_``'s caches for B lanes of T slots, as meta tensors."""
    from repro_torch.models import transformer
    return [transformer.init_cache(c, B, T, device="meta")
            for c in sys_.party_cfgs]


def _fsdp_n_params(cfg):
    """Every party's parameters of ``cfg``'s EasterLM (counted on meta)."""
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    p = steps.abstract_params(_lm_system(cfg, "meta"))
    return sum(t.numel() for t in tree_leaves({"parties": p["parties"]}))


def _fsdp_cpu_refs(weights, cut_batch, prompt, ref_dir):
    """The CPU port's one-process counterparts of (b) and (c) from the
    card's weights (host numpy, popped from ``weights`` as they are loaded,
    so the host holds one copy): (b)'s updated params and where the
    clipped gradient is at least 1e-4 written to ``ref_dir`` for the ranks
    (``_fsdp_compare_blocks``), its loss returned; (c)'s prefill, logits
    and tokens."""
    import numpy as np
    import torch
    from repro_torch import checkpoint
    from repro_torch.configs.base import EasterConfig
    from repro_torch.core import train_loop
    from repro_torch.core.easter_lm import EasterLM
    from repro_torch.launch import steps
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_leaves
    _, cut, serve_cfg = _fsdp_cfgs()
    threads = torch.get_num_threads()
    # the cores the ranks (one torch thread each, and gloo's staging) and
    # the parent's main thread leave: at every core but two it took 217 s
    # of CPU in 87 s beside the ranks (H100 80GB HBM3 machine, 8 cores),
    # and the ranks need its output only after their last served model
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              - FSDP_RANKS - 1))
    sys_ = EasterLM(cut, EasterConfig(), grad_mode="joint", device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in cut_batch.items()}
    params = sys_.load_params(weights.pop("cut"))
    # the step train_loop.make_train_step builds, its gradients kept for
    # the mask: loss_and_grads, then the optimizer's update
    loss, _, grads = train_loop.loss_and_grads(sys_, params, batch, 0,
                                               sys_.mask_seeds())
    scale = min(1.0, 1.0 / (float(global_norm(grads)) + 1e-9))
    big = [np.abs(g.detach().numpy()) * scale >= 1e-4
           for g in tree_leaves(grads)]
    _, opt = steps.build_train_step(sys_, "adam", lr=FSDP_LR)
    tree = {"parties": params["parties"]}
    opt.update(grads, opt.init(tree), tree)
    del grads
    for i, (p, g) in enumerate(zip(tree_leaves(tree), big)):
        np.save(os.path.join(ref_dir, f"p{i}.npy"),
                checkpoint.params_to_numpy(p))
        np.save(os.path.join(ref_dir, f"g{i}.npy"), g)
    open(os.path.join(ref_dir, "done"), "w").close()
    b = {"loss": float(loss)}
    del params, tree, opt, sys_, big
    serve_sys = _lm_system(serve_cfg, "cpu")
    serve_sys.init_params = lambda gen: serve_sys.load_params(
        weights.pop("serve"))
    c = _fsdp_serve(serve_sys, None, prompt)
    torch.set_num_threads(threads)
    return b, c


def phase_fsdp():
    """The FSDP plan on the card (the module docstring's ``fsdp``).
    Returns (the counted paths' launches, the numbers)."""
    import concurrent.futures
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import mesh
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg, cut, serve_cfg = _fsdp_cfgs()
    batches = _fsdp_batches(cfg)
    # the cuts' weights, drawn on the card as the ranks draw them; the
    # ranks start, and the CPU steps run (two threads), while the one
    # process trains on the card; the ranks then work once it is done
    weights = {k: _lm_system(c, "cuda").export_params(_lm_system(
        c, "cuda").init_params(torch.Generator(device="cuda").manual_seed(0)))
        for k, c in (("cut", cut), ("serve", serve_cfg))}
    _free_card()
    cut_batch = _fsdp_cut_batch(cfg)
    prompt = np.random.default_rng(2).integers(
        0, serve_cfg.vocab_size, (FSDP_SERVE_LANES, FSDP_SERVE_PROMPT),
        dtype=np.int32)
    prompt_full = np.random.default_rng(3).integers(
        0, serve_cfg.vocab_size, (FSDP_FULL_LANES, FSDP_FULL_PROMPT + 1),
        dtype=np.int32)
    runs = _fsdp_split_runs()
    prompts_split = {key: np.random.default_rng(3).integers(
        0, c.vocab_size, (FSDP_FULL_LANES, 1 + (
            FSDP_H_PROMPT if key == "h" else FSDP_FULL_PROMPT)),
        dtype=np.int32) for key, c, _, _ in runs if len(key) == 1}
    with concurrent.futures.ThreadPoolExecutor(2) as ex, \
            tempfile.TemporaryDirectory() as store:
        ref_dir, go = os.path.join(store, "b"), os.path.join(store, "go")
        os.makedirs(ref_dir)
        # one torch thread a rank: the host's 8 cores among the 4 ranks
        # (whose host work is gloo's staging) and the CPU port's steps
        spawned = ex.submit(mesh.spawn_ranks, _fsdp_rank, FSDP_RANKS,
                            batches, cut_batch, prompt, prompt_full,
                            prompts_split, ref_dir, go, time.time(),
                            store_dir=store, device="cuda", threads=1,
                            timeout_s=900)
        cpu = ex.submit(_fsdp_cpu_refs, weights, cut_batch, prompt, ref_dir)
        one, one_d, one_split = _then_ranks(go, lambda: (
            _fsdp_one_process(cfg, batches),
            _fsdp_full_one_process(prompt_full),
            {key: _fsdp_full_one_process(prompts_split[key[0]], c, rounds)
             for key, c, _, rounds in runs}))
        pre_s = time.perf_counter() - t_phase
        ranks = spawned.result()
        ranks_s = max(r["work_s"] for r in ranks)
        b_cpu, c_cpu = cpu.result()
    res = {"ranks_s": ranks_s, "before_ranks_s": pre_s,
           "mesh": list(FSDP_MESH), "train_layers": FSDP_TRAIN_LAYERS,
           "rank_marks_s": ranks[0]["marks"],
           "all_gather_gbps": ranks[0]["all_gather_gbps"],
           "start_s": [r["start_s"] for r in ranks]}
    failures = []
    for r in ranks:
        failures += _rule_failures("fsdp", r, FSDP_RANKS, [r["a"]["devices"]])
    res["a"] = _fsdp_check_train("fsdp", ranks, one, failures, cfg, FSDP_MESH)
    # (b): the float32 cut's joint adam step against the CPU port
    b = ranks[0]["b"]
    loss_ok = bool(np.isclose(b["loss"], b_cpu["loss"], rtol=1e-4,
                              atol=1e-5))
    blocks_ok = all(r["b"]["ok"] for r in ranks)
    worst = max(r["b"]["max_abs"] for r in ranks)
    for r in ranks:
        try:
            _check_train_launches(f"fsdp (b) rank {r['rank']}",
                                  r["b"]["launches"], 1, 1)
        except AssertionError as e:
            failures.append(str(e))
    res["b"] = {"loss": b["loss"], "cpu_loss": b_cpu["loss"],
                "params_max_abs": worst, "ok": loss_ok and blocks_ok}
    log("fsdp", f"(b) {cut.name} cut to {FSDP_CUT_LAYERS} layers, float32, "
                f"TF32 off, grad_mode joint, one adam {FSDP_LR} step at "
                f"{FSDP_CUT_BATCH} x {FSDP_CUT_SEQ} under layout tp: loss "
                f"{b['loss']:.6f} vs the CPU port's {b_cpu['loss']:.6f} "
                f"{'ok' if loss_ok else 'FAIL'} (rtol 1e-4, atol 1e-5); "
                f"every rank's blocks of the updated params against the "
                f"CPU port's, max abs {worst:.3g} "
                f"{'ok' if blocks_ok else 'FAIL'} (rtol 1e-4 / atol 1e-5 "
                f"where the clipped |g| >= 1e-4, 2 lr + 1e-5 elsewhere)")
    if not res["b"]["ok"]:
        failures.append("(b) the sharded float32 step differs from the CPU "
                        "port's")
    # (c): serving against the CPU port
    attn = _layer_kinds(serve_cfg)[0] + _layer_kinds(
        _lm_system(serve_cfg, "meta").party_cfgs[1])[0]
    for r in ranks:
        got = r["c"]["launches"]
        want = {"flash_attention_fwd": attn,
                "blind_agg_fwd": 1 + FSDP_SERVE_ROUNDS}
        if any(got[k] != n for k, n in want.items()):
            failures.append(f"(c) rank {r['rank']}: launches {got}, want "
                            f"{want}")
        if not np.array_equal(r["c"]["tokens"], c_cpu["tokens"]):
            failures.append(f"(c) rank {r['rank']}: greedy tokens differ "
                            f"from the CPU port's")
    c = ranks[0]["c"]
    c_errs = {w: (float(np.abs(c[w] - c_cpu[w]).max()),
                  bool(np.allclose(c[w], c_cpu[w], rtol=1e-4, atol=1e-5)))
              for w in ("E", "logits")}
    res["c"] = {"errors": c_errs, "tokens": c["tokens"].tolist()}
    log("fsdp", f"(c) {serve_cfg.name} cut to {FSDP_SERVE_LAYERS} layers, "
                f"float32: a {FSDP_SERVE_LANES}-lane "
                f"{FSDP_SERVE_PROMPT - 1}-token prefill then "
                f"{FSDP_SERVE_ROUNDS} greedy rounds under serve_shardings: "
                + "; ".join(f"{w} max abs {e:.3g} {'ok' if ok else 'FAIL'}"
                            for w, (e, ok) in c_errs.items())
                + f" (rtol 1e-4, atol 1e-5); tokens identical on every rank "
                f"and to the CPU port's "
                f"{not any('tokens' in f for f in failures)}; launches a "
                f"rank {c['launches']}")
    if not all(ok for _, ok in c_errs.values()):
        failures.append("(c) the sharded serving differs from the CPU port's")
    res["d"] = _fsdp_check_full(ranks, one_d, failures)
    limits = {key: lim for key, *_, lim in FSDP_SPLIT}
    for key, c, shape, _ in runs:
        if shape[0] == 1 and len(key) == 1:
            failures += _fsdp_overlay_identity(c, shape)
        limit = (FSDP_SPLIT_F32_REL if len(key) > 1
                 else limits.get(key, FSDP_FULL_LOGIT_REL))
        res[key] = _fsdp_check_full(ranks, one_split[key], failures, key, c,
                                    shape, limit)
    res["seconds"] = time.perf_counter() - t_phase
    res["card"] = _card()
    log("fsdp", f"before the ranks' work (the draws, the one process, "
                f"meanwhile the ranks' start) {pre_s:.1f} s; a rank loaded "
                f"this script {[round(r['loaded_s'], 1) for r in ranks]} s "
                f"after the spawn and was in the group at "
                f"{[round(r['in_group_s'], 1) for r in ranks]} s; "
                f"the ranks' work took {ranks_s:.1f} s (joined the group "
                f"{[round(s_, 1) for s_ in res['start_s']]} s after the "
                f"spawn); phase took {res['seconds']:.1f} s on {res['card']}")
    if failures:
        raise AssertionError("fsdp phase: " + "; ".join(failures))
    paths = [_sum_launches([r[k]["launches"] for r in ranks])
             for k in ("a", "b", "c", "d") + tuple(key for key, *_ in runs)]
    return paths, res


def _tsplit_rank(prompt):
    """One rank of ``--phase tsplit``: (i) on the TSPLIT_MESH mesh of the
    TSPLIT_RANKS ranks sharing the card (``_fsdp_serve``, detail)."""
    import torch
    from repro_torch.launch import mesh
    m = mesh.make_debug_mesh(*TSPLIT_MESH, device="cuda")
    torch.zeros((), device=m.device)            # this rank's CUDA context
    t0 = time.perf_counter()
    sys_ = _lm_system(_fsdp_split_cfg(TSPLIT_ARCH), "cuda")
    res = {"rank": m.rank, "coords": dict(m.coords), "backend": m.backend,
           "device": str(m.device),
           "i": _fsdp_serve(sys_, m, prompt, FSDP_SPLIT_ROUNDS, detail=True)}
    res["work_s"] = time.perf_counter() - t0
    return res


def phase_tsplit():
    """(i): qwen2-1.5b at full width and depth on a 1 x 3 mesh, whose
    attention runs whole on every rank over its T block of the cache
    (``TSPLIT_*``), held as (d) against the one process (run first, in
    this process); every rank's K/V caches hold T / 3 slots. Returns the
    numbers."""
    import tempfile
    import numpy as np
    from repro_torch.launch import mesh
    t0 = time.perf_counter()
    cfg = _fsdp_split_cfg(TSPLIT_ARCH)
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (FSDP_FULL_LANES, FSDP_FULL_PROMPT + 1),
        dtype=np.int32)
    one = _fsdp_full_one_process(prompt, cfg, FSDP_SPLIT_ROUNDS)
    with tempfile.TemporaryDirectory() as store:
        ranks = mesh.spawn_ranks(_tsplit_rank, TSPLIT_RANKS, prompt,
                                 store_dir=store, device="cuda", threads=1,
                                 timeout_s=600)
    failures = []
    res = _fsdp_check_full(ranks, one, failures, "i", cfg, TSPLIT_MESH)
    T = FSDP_FULL_PROMPT + FSDP_SPLIT_ROUNDS
    for r in ranks:
        if r["i"]["kv_cache_t"] != [T // TSPLIT_MESH[1]]:
            failures.append(f"(i) rank {r['rank']}: K/V caches of "
                            f"{r['i']['kv_cache_t']} slots, want "
                            f"{T // TSPLIT_MESH[1]} of {T}")
    res["kv_cache_t_by_rank"] = {r["rank"]: r["i"]["kv_cache_t"]
                                 for r in ranks}
    res["work_s_by_rank"] = {r["rank"]: r["work_s"] for r in ranks}
    res["seconds"] = time.perf_counter() - t0
    res["card"] = _card()
    log("tsplit", f"(i) K/V cache slots a rank {res['kv_cache_t_by_rank']} "
                  f"of {T}; the ranks' work {res['work_s_by_rank']} s; phase "
                  f"took {res['seconds']:.1f} s on {res['card']}")
    if failures:
        raise AssertionError("tsplit phase: " + "; ".join(failures))
    return res


# --phase split_depth: (path, mesh, active layers, dtype) of the split MoE
# and SSD runs whose round-0 logits it holds against one process's; and
# (path, active layers) where only the one process runs, in both dtypes
# (the float32 split does not fit four ranks on the card)
SPLIT_DEPTH = (("e", (1, 4), 6, "float32"), ("e", (1, 4), 6, "bfloat16"),
               ("f", (2, 2), 16, "float32"), ("f", (2, 2), 16, "bfloat16"))
SPLIT_DEPTH_ONE = (("f", 64),)


def _split_depth_cfgs():
    arch = {key: a for key, a, *_ in FSDP_SPLIT}
    return [_fsdp_split_cfg(arch[key], layers, dtype)
            for key, _, layers, dtype in SPLIT_DEPTH]


def _split_depth_rank(prompts):
    """One rank of ``--phase split_depth``: each SPLIT_DEPTH run's prefill
    and one teacher-forced round under the plan."""
    import torch
    from repro_torch.launch import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    m = mesh.make_debug_mesh(*FSDP_MESH, device="cuda")
    meshes = {tuple(FSDP_MESH): m, (1, 4): mesh.make_debug_mesh(
        1, 4, device="cuda")}
    res = {"rank": m.rank, "coords": dict(m.coords), "backend": m.backend,
           "device": str(m.device)}
    for (key, shape, _, _), cfg in zip(SPLIT_DEPTH, _split_depth_cfgs()):
        sys_ = _lm_system(cfg, "cuda")
        res[f"{key}{cfg.n_layers}{cfg.dtype}"] = _fsdp_serve(
            sys_, meshes[shape], prompts[key], 1, detail=True)
        del sys_
        _free_card()
    return res


def phase_split_depth():
    """The fsdp phase's split MoE ((e), 1 x 4) and SSD ((f), 2 x 2) paths
    at full width cut in depth, in float32 and bfloat16: round 0's
    (teacher-forced) logits of every rank against the one process's on
    the same weights, as a share of its largest |logit|, by depth and
    dtype (the one process first, then 4 ranks sharing the card); beside
    them the witness of bfloat16's own error at that depth: the one
    process in bfloat16 against the one process in float32 (the same
    float32 draw, rounded), and the split in bfloat16 against the float32
    one process; SPLIT_DEPTH_ONE's depths give the witness alone."""
    import tempfile
    import numpy as np
    from repro_torch.launch import mesh
    cfgs = _split_depth_cfgs()
    arch = {key: a for key, a, *_ in FSDP_SPLIT}
    prompt = lambda cfg: np.random.default_rng(3).integers(
        0, cfg.vocab_size, (FSDP_FULL_LANES, FSDP_FULL_PROMPT + 1),
        dtype=np.int32)
    prompts = {key: prompt(cfg) for (key, *_), cfg in zip(SPLIT_DEPTH, cfgs)}
    name = lambda key, cfg: f"{key}{cfg.n_layers}{cfg.dtype}"
    first = {name(key, cfg): _fsdp_full_one_process(
        prompts[key], cfg, 1)["logits"][0]
        for (key, *_), cfg in zip(SPLIT_DEPTH, cfgs)}
    for key, layers in SPLIT_DEPTH_ONE:
        for dtype in ("float32", "bfloat16"):
            cfg = _fsdp_split_cfg(arch[key], layers, dtype)
            first[name(key, cfg)] = _fsdp_full_one_process(
                prompt(cfg), cfg, 1)["logits"][0]
    with tempfile.TemporaryDirectory() as store:
        ranks = mesh.spawn_ranks(_split_depth_rank, FSDP_RANKS, prompts,
                                 store_dir=store, device="cuda", threads=1,
                                 timeout_s=900)
    rel = lambda got, want: float(np.abs(got - want).max()
                                  / np.abs(want).max())
    out = {}
    for (key, shape, layers, _), cfg in zip(SPLIT_DEPTH, cfgs):
        n = name(key, cfg)
        out[n] = max(rel(r[n]["first_logits"], first[n]) for r in ranks)
        log("split_depth", f"({key}) {cfg.name} at full width, {layers} "
                           f"layers, {cfg.dtype}, on a {shape[0]} x "
                           f"{shape[1]} mesh: round 0's logits {out[n]:.4g} "
                           f"of the one process's largest |logit| at worst "
                           f"over the ranks")
        f32 = n[:-len(cfg.dtype)] + "float32"
        if cfg.dtype == "bfloat16" and f32 in first:
            out[n + "_vs_one_float32"] = max(
                rel(r[n]["first_logits"], first[f32]) for r in ranks)
            log("split_depth", f"({key}) {layers} layers: the split in "
                               f"bfloat16 {out[n + '_vs_one_float32']:.4g} "
                               f"of the float32 one process's largest "
                               f"|logit| from it")
    for n in [n for n in first if n.endswith("bfloat16")]:
        f32 = n[:-len("bfloat16")] + "float32"
        out["one_" + n + "_vs_float32"] = w = rel(first[n], first[f32])
        log("split_depth", f"({n[0]}) {n[1:-len('bfloat16')]} layers: the "
                           f"one process in bfloat16 {w:.4g} of the float32 "
                           f"one process's largest |logit| from it "
                           f"(bfloat16's own error at this depth)")
    return out


def _fsdp_check_full(ranks, one, failures, key="d", cfg=None,
                     shape=FSDP_MESH, limit=FSDP_FULL_LOGIT_REL, tag="fsdp"):
    """(d)'s (or ``key``'s: (e)-(g) and their float32 cuts, of ``cfg`` on a
    ``shape`` mesh) checks
    (failures appended) and its numbers: every rank's logits finite, the
    model ranks of one data rank holding the same logits bit for bit, the
    same greedy tokens on every rank; per rank a flash_attention_fwd a
    prefill for each attending layer (36 + 9 for (d)), an rglru_scan_fwd
    for each RG-LRU layer, all on the TMA path, and one blind_agg_fwd a
    prefill, one blind_agg_fwd a round and no flash or rglru launch; no
    all-gather of a leaf the model axis splits in a round; round 0's
    (teacher-forced) logits within ``limit`` of the largest of the one
    process's (None: printed, not asserted; FSDP_SPLIT). The tokens beside
    the one process's are printed, not asserted (bfloat16 partial sums in
    another order may break a near tie)."""
    import numpy as np
    cfg = cfg or _fsdp_full_cfg()
    pcfg = _lm_system(cfg, "meta").party_cfgs[1]
    attn = _layer_kinds(cfg)[0] + _layer_kinds(pcfg)[0]
    lru = _layer_kinds(cfg)[1] + _layer_kinds(pcfg)[1]
    n_rounds = len(ranks[0][key]["round_ms"])
    # an encoder-decoder's decoder layer also attends to the encoder's
    # K/V, in the prefill and in every round; encoder_kv runs the active
    # party's encoder and the passive group's (one launch a layer)
    xattn = cfg.family == "encdec"
    for r in ranks:
        d, k = r[key], f"({key}) rank {r['rank']}"
        if not d["finite"]:
            failures.append(f"{k}: logits not finite")
        failures += _rule_failures(f"({key})", r, len(ranks), [d["devices"]])
        want_p = {"flash_attention_fwd": attn * (2 if xattn else 1),
                  "blind_agg_fwd": 1, "rglru_scan_fwd": lru}
        want_r = {"flash_attention_fwd": attn * n_rounds if xattn else 0,
                  "blind_agg_fwd": n_rounds, "rglru_scan_fwd": 0}
        checks = [("prefill", d["prefill_launches"], want_p),
                  ("rounds", d["round_launches"], want_r)]
        if xattn:
            checks.append(("encoder_kv", d["encoder_launches"], {
                "flash_attention_fwd": (cfg.n_encoder_layers
                                        + pcfg.n_encoder_layers),
                "blind_agg_fwd": 0}))
        for what, got, want in checks:
            if any(got[n] != v for n, v in want.items()):
                failures.append(f"{k}: {what} launches {got}, want {want}")
        if d["prefill_rglru_paths"].get("tma", 0) != lru:
            failures.append(f"{k}: rglru_scan_fwd paths "
                            f"{d['prefill_rglru_paths']}, want {lru} on the "
                            f"TMA path")
        if d["round_weight_gathers"]:
            failures.append(f"{k}: a round all-gathered split leaves "
                            f"{d['round_weight_gathers'][:3]}")
        if d["round_kv_gathers"]:
            failures.append(f"{k}: a round all-gathered a K/V cache or the "
                            f"cross K/V {d['round_kv_gathers'][:3]}")
        if not np.array_equal(d["tokens"], ranks[0][key]["tokens"]):
            failures.append(f"{k}: greedy tokens differ from rank 0's")
        for o in ranks:
            if o["coords"]["data"] == r["coords"]["data"] \
                    and o[key]["digests"] != d["digests"]:
                failures.append(f"{k}: logits differ from rank "
                                f"{o['rank']}'s of the same data rank")
    d0 = ranks[0][key]
    same_one = bool(np.array_equal(d0["tokens"], one["tokens"]))
    # where a lane's tokens first part from the one process's, the one
    # process's top-1 minus top-2 logit there: the tie the partial sums'
    # bfloat16 rounding broke
    ties = {}
    for lane in range(d0["tokens"].shape[0]):
        diff = np.nonzero(d0["tokens"][lane] != one["tokens"][lane])[0]
        if len(diff):
            top = np.sort(one["logits"][diff[0], lane, -1])[-2:]
            ties[lane] = (int(diff[0]), float(top[1] - top[0]))
    first = one["logits"][0]
    all_same = all(r[key]["digests"] == d0["digests"] for r in ranks)
    rel = float(np.abs(d0["first_logits"] - first).max()
                / np.abs(first).max())
    if limit is not None and not rel <= limit:
        failures.append(f"({key}): round 0's logits {rel:.4g} of the "
                        f"largest |logit| from the one process's, limit "
                        f"{limit}")
    out = {"arch": cfg.name, "mesh": list(shape), "layers": cfg.n_layers,
           "rounds": n_rounds,
           "prefill_ms_by_rank": {r["rank"]: r[key]["prefill_ms"]
                                  for r in ranks},
           "round_ms_by_rank": {r["rank"]: r[key]["round_ms"] for r in ranks},
           "resident_bytes_by_rank": {r["rank"]: r[key]["resident"]
                                      for r in ranks},
           "peak_bytes_by_rank": {r["rank"]: r[key]["peak"] for r in ranks},
           "prefill_bytes_by_rank": {r["rank"]: r[key]["prefill_bytes"]
                                     for r in ranks},
           "round_bytes_by_rank": {r["rank"]: r[key]["round_bytes"]
                                   for r in ranks},
           "prefill_counts": d0["prefill_counts"],
           "round_counts": d0["round_counts"],
           "prefill_launches": d0["prefill_launches"],
           "round_collectives": d0["round_calls"],
           "tokens": d0["tokens"].tolist(),
           "one_process_tokens": one["tokens"].tolist(),
           "tokens_as_one_process": same_one,
           "first_divergence_and_gap_by_lane": ties,
           "round0_logits_max_abs_vs_one_process": float(
               np.abs(d0["first_logits"] - first).max()),
           "logits_max_abs": float(np.abs(first).max()),
           "round0_logits_rel_vs_one_process": rel,
           "one_process_prefill_ms": one["prefill_ms"],
           "one_process_round_ms": one["round_ms"],
           "logits_same_on_all_ranks": all_same,
           "params": _fsdp_n_params(cfg)}
    if xattn:
        out.update({
            "encoder_kv_ms_by_rank": {r["rank"]: r[key]["encoder_ms"]
                                      for r in ranks},
            "cross_kv_bytes_by_rank": {r["rank"]: r[key]["cross_kv_bytes"]
                                       for r in ranks},
            "encoder_bytes_by_rank": {r["rank"]: r[key]["encoder_bytes"]
                                      for r in ranks},
            "encoder_counts": d0["encoder_counts"],
            "encoder_launches": d0["encoder_launches"],
            "one_process_encoder_kv_ms": one["encoder_ms"],
            "one_process_cross_kv_bytes": one["cross_kv_bytes"]})
        log(tag, f"({key}) encoder_kv ms by rank "
                    f"{ {k: round(v, 1) for k, v in out['encoder_kv_ms_by_rank'].items()} }"
                    f" (one process {one['encoder_ms']:.1f}); cross K/V MB "
                    f"a rank "
                    f"{ {k: round(v / 1e6, 2) for k, v in out['cross_kv_bytes_by_rank'].items()} }"
                    f" (one process {one['cross_kv_bytes'] / 1e6:.2f}); "
                    f"collectives' bytes a rank {d0['encoder_bytes']} "
                    f"(counts {d0['encoder_counts']}); launches "
                    f"{d0['encoder_launches']}")
    log(tag, f"({key}) {cfg.name} at full width ({cfg.n_layers} "
                f"layers, three {pcfg.n_layers}-layer proxies; "
                f"{out['params']} parameters), {cfg.dtype}, on a {shape[0]} x "
                f"{shape[1]} mesh under prefill_shardings / serve_shardings "
                f"(tensor-parallel compute over model): {FSDP_FULL_LANES} "
                f"lanes of {d0['prompt_tokens'] + 1}-token prompts, then "
                f"{n_rounds} greedy rounds; prefill ms by rank "
                f"{ {k: round(v, 1) for k, v in out['prefill_ms_by_rank'].items()} }"
                f"; median ms a round by rank "
                f"{ {k: round(statistics.median(v), 1) for k, v in out['round_ms_by_rank'].items()} }"
                f"; resident parameter GB by rank "
                f"{ {k: round(v / 1e9, 3) for k, v in out['resident_bytes_by_rank'].items()} }"
                f"; torch.cuda.max_memory_allocated GB by rank "
                f"{ {k: round(v / 1e9, 2) for k, v in out['peak_bytes_by_rank'].items()} }"
                f"; collectives' bytes a rank, prefill "
                f"{d0['prefill_bytes']} (counts {d0['prefill_counts']}), "
                f"the last round {d0['round_bytes']} (counts "
                f"{d0['round_counts']}); prefill launches "
                f"{d0['prefill_launches']} (rglru paths "
                f"{d0['prefill_rglru_paths']}); logits the same on "
                f"every rank {all_same}; tokens identical on every rank "
                f"{not any('tokens' in f for f in failures)}, as the one "
                f"process's {same_one}: rank 0 {out['tokens']}, one process "
                f"{out['one_process_tokens']}; first differing round and the "
                f"one process's top-2 logit gap there, by lane {ties}; round "
                f"0's logits max abs {out['round0_logits_max_abs_vs_one_process']:.4g}"
                f" from the one process's (max |logit| "
                f"{out['logits_max_abs']:.4g}: {rel:.4g} of it, limit "
                f"{limit}); the one process: prefill "
                f"{one['prefill_ms']:.1f} ms, median ms a round "
                f"{statistics.median(one['round_ms']):.1f}")
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# --phase nccl: the party group and the FSDP plan over NCCL, a card a rank
# ---------------------------------------------------------------------------

NCCL_RANKS, NCCL_MESHES = 4, ((2, 2), (1, 4), (4, 1))
# (j): qwen2-vl-7b at full width and depth (13.68e9 parameters with its
# three 7-layer proxies, bfloat16, remat "full" as its config trains)
# under zero3 + ZeRO-1 on a 4 x 1 (data x model) mesh, adam 1e-3 clip
# 1.0: TRAIN_BATCH rows of TRAIN_SEQ tokens a step (one a rank) from
# lm_batch_iterator(seed=0), each row's first 1024 positions the patch
# embeddings of models/build.frontend_inputs (the card's generator seeded
# NCCL_J_SEED + step); the first step warms the allocator. 164 GB of
# weights, gradients and adam state over 4 ranks: 41 GB a rank, held
# under NCCL_J_RESIDENT
NCCL_J_MESH, NCCL_J_STEPS, NCCL_J_SEED, NCCL_J_RESIDENT = (4, 1), 3, 11, 45e9
# (k): (j) cut to 2 active layers (2 a proxy; 4.13e9 parameters) in
# float32 at full width, one sgd step at TRAIN_BATCH x 1280 tokens (the
# 1024 patch positions and 256 more) on the same mesh, against one
# process on one card; lr 10 so that the update (a clipped unit gradient
# over 4.1e9 parameters, ~1.6e-5 rms an element) stands above the atol
# 1e-5 the parameters are held to
NCCL_K_LAYERS, NCCL_K_SEQ, NCCL_K_LR, NCCL_K_SEED = 2, 1280, 10.0, 12
# the split runs of the fsdp phase that --phase nccl repeats: (e) and its
# float32 cut; (e)'s bfloat16 round-0 gap over gloo (the fsdp phase at
# 24 layers, H100 80GB HBM3 at 700 W), printed beside NCCL's
NCCL_SPLIT, NCCL_E_GLOO_GAP = ("e", "e32"), 0.862
# seconds the parent waits on a rank of the plan's spawn (its one-process
# runs included): a hung collective fails the phase within it
NCCL_TIMEOUT_S = 600


def _nccl_split_runs():
    return [r for r in _fsdp_split_runs() if r[0] in NCCL_SPLIT]


def _nccl_k_cfg():
    return _fsdp_split_cfg(VLM_ARCH, NCCL_K_LAYERS, "float32")


def _vlm_batch(cfg, batch, seed):
    """``batch`` (numpy tokens, labels) on the card with the patch
    embeddings of every row (the card's generator seeded ``seed``)."""
    import torch
    from repro_torch.models.build import frontend_inputs
    out = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    out.update(frontend_inputs(cfg, batch["tokens"].shape[0],
                               torch.Generator(device="cuda").manual_seed(
                                   seed)))
    return out


def _nccl_k_one_process(batch, ref_dir):
    """(k)'s one process on one card: the float32 cut's sgd step on the
    whole batch from the card's generator seeded 0; each updated leaf
    saved to ``ref_dir`` for the ranks (``_fsdp_compare_blocks``). Returns
    the loss and the launches."""
    import numpy as np
    import torch
    from repro_torch import checkpoint
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    _free_card()
    cfg = _nccl_k_cfg()
    sys_ = _lm_system(cfg, "cuda")
    params = sys_.init_params(torch.Generator(device="cuda").manual_seed(0))
    step, opt = steps.build_train_step(sys_, "sgd", lr=NCCL_K_LR)
    state = opt.init({"parties": params["parties"]})
    params, _, _, ms, launches = _fsdp_step_loop(
        step, params, state, [_vlm_batch(cfg, batch, NCCL_K_SEED)])
    out = {"launches": launches, "step_ms": ms}
    for i, p in enumerate(tree_leaves({"parties": params["parties"]})):
        np.save(os.path.join(ref_dir, f"p{i}.npy"),
                checkpoint.params_to_numpy(p))
    open(os.path.join(ref_dir, "done"), "w").close()
    del params, state, step, opt, sys_
    _free_card()
    return out


def _nccl_k_rank(m, batch, ref_dir):
    """(k) on this rank: the float32 cut's sgd step under zero3 on ``m``,
    its blocks and their update held to the one process's
    (``_fsdp_compare_blocks``)."""
    import torch
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    cfg = _nccl_k_cfg()
    sys_ = _lm_system(cfg, "cuda")
    run, lp, lo, lbs, pspec = _fsdp_sharded_train(
        sys_, m, "sgd", "zero3", True, [_vlm_batch(cfg, batch, NCCL_K_SEED)],
        lr=NCCL_K_LR)
    before = [t.detach().clone()
              for t in tree_leaves({"parties": lp["parties"]})]
    lp, lo, losses, ms, launches = _fsdp_step_loop(run, lp, lo, lbs)
    out = {"loss": losses[0], "step_ms": ms, "launches": launches,
           "devices": _devices(lp), "peak": torch.cuda.max_memory_allocated()}
    out.update(_fsdp_compare_blocks(lp, pspec, m, ref_dir, before=before))
    del run, lp, lo, lbs, before, sys_
    _free_card()
    return out


def _nccl_j_rank(m, batches):
    """(j) on this rank: qwen2-vl-7b at full width and depth trained under
    zero3 + ZeRO-1 on ``m`` through a RecordingMesh over it: losses, ms a
    step, each step's collective bytes by kind and count, launches, the
    resident bytes of the blocks by kind, peak memory, the devices of its
    blocks."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import RecordingMesh
    cfg = _fsdp_split_cfg(VLM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    sys_ = _lm_system(cfg, "cuda")
    rec = RecordingMesh(m)
    t0 = time.perf_counter()
    run, lp, lo, lbs, _ = _fsdp_sharded_train(
        sys_, m, "adam", "zero3", True,
        [_vlm_batch(cfg, b, NCCL_J_SEED + i) for i, b in enumerate(batches)],
        run_mesh=rec)
    torch.cuda.synchronize()
    out = {"draw_s": time.perf_counter() - t0, "losses": [], "step_ms": [],
           "step_bytes": [], "step_counts": [],
           "rows": int(lbs[0]["tokens"].shape[0])}
    _reset_lm_launches()
    for i, b in enumerate(lbs):
        was, n = dict(rec.bytes), rec.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, lo, mt = run(lp, lo, b, i)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(mt["loss"]))
        out["step_bytes"].append({k: rec.bytes[k] - was[k]
                                  for k in rec.bytes})
        out["step_counts"].append(rec.count - n)
    w = dryrun.tree_bytes({"parties": lp["parties"]})
    out.update(launches=_lm_launches(), weights=w, grads=w,
               adam=dryrun.tree_bytes(lo), devices=_devices([lp, lo]),
               peak=torch.cuda.max_memory_allocated())
    del run, lp, lo, lbs, sys_
    _free_card()
    return out


def _nccl_rank(batches_a, prompt_full, prompt_e, batches_j, batch_k,
               ref_dir, go, t_spawn):
    """One rank of --phase nccl (a spawned process, NCCL, its own card):
    the meshes (every group warmed as it is made) and the all-gather rate;
    then, once the parent's one-process runs are done (the file ``go``),
    (a) at full depth, (d), (e) and its float32 cut, (k) and (j); results
    for the parent, numpy, with the seconds each part ended at
    (``marks``)."""
    import torch
    from repro_torch.launch import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    meshes = {sh: mesh.make_debug_mesh(*sh, device="cuda")
              for sh in NCCL_MESHES}
    m = meshes[FSDP_MESH]
    res = {"rank": m.rank, "coords": dict(m.coords), "backend": m.backend,
           "device": str(m.device),
           "current_device": torch.cuda.current_device(),
           "start_s": time.time() - t_spawn, "marks": {}}
    mark = lambda k: res["marks"].__setitem__(
        k, round(time.perf_counter() - t_start, 2))
    mark("meshes warm")
    res["all_gather_gbps"] = _group_rate(m)
    mark("all-gather probe")
    _wait_go(go)
    t_go = time.perf_counter()
    mark("go")
    on = lambda b: {k: torch.as_tensor(v, device="cuda")
                    for k, v in b.items()}
    res["a"] = _fsdp_train_a(m, _fsdp_split_cfg(TRAIN_ARCH),
                             [on(b) for b in batches_a])
    mark("(a) steps")
    sys_ = _lm_system(_fsdp_full_cfg(), "cuda")
    res["d"] = _fsdp_serve(sys_, m, prompt_full, FSDP_FULL_ROUNDS,
                           detail=True)
    mark("(d) served")
    del sys_
    _free_card()
    for key, cfg_, shape, rounds in _nccl_split_runs():
        sys_ = _lm_system(cfg_, "cuda")
        res[key] = _fsdp_serve(sys_, meshes[shape], prompt_e, rounds,
                               detail=True)
        mark(f"({key}) served")
        del sys_
        _free_card()
    res["k"] = _nccl_k_rank(meshes[NCCL_J_MESH], batch_k, ref_dir)
    mark("(k) step compared")
    res["j"] = _nccl_j_rank(meshes[NCCL_J_MESH], batches_j)
    mark("(j) steps")
    log("nccl", f"rank {m.rank} on {m.device}: {res['marks']}")
    res["work_s"] = time.perf_counter() - t_go
    return res


def _nccl_check_k(ranks, one, failures):
    """(k)'s checks: every rank's blocks and their update within the
    tolerance of the one process's, the same loss on every rank, one
    blind_agg_fwd on every rank and in the one process."""
    k = {r["rank"]: r["k"] for r in ranks}
    for rank, rk in k.items():
        try:
            _check_train_launches(f"(k) rank {rank}", rk["launches"], 1)
        except AssertionError as e:
            failures.append(str(e))
        if rk["loss"] != k[0]["loss"]:
            failures.append(f"(k) rank {rank}: loss {rk['loss']} vs rank "
                            f"0's {k[0]['loss']}")
    _check_train_launches("(k) one process", one["launches"], 1)
    ok = all(rk["ok"] for rk in k.values())
    if not ok:
        failures.append("(k) the float32 cut's sgd step over NCCL differs "
                        "from one process's on one card")
    cfg = _nccl_k_cfg()
    out = {"loss": k[0]["loss"], "ok": ok,
           "params_max_abs": max(rk["max_abs"] for rk in k.values()),
           "moved": min(rk["moved"] for rk in k.values()),
           "step_ms_by_rank": {r: rk["step_ms"] for r, rk in k.items()},
           "step_ms_one_process": one["step_ms"],
           "peak_bytes_by_rank": {r: rk["peak"] for r, rk in k.items()},
           "params": _fsdp_n_params(cfg)}
    log("nccl", f"(k) {cfg.name} at full width cut to {cfg.n_layers} "
                f"layers ({out['params']} parameters), float32, TF32 off, "
                f"one sgd {NCCL_K_LR} step at {TRAIN_BATCH} x {NCCL_K_SEQ} "
                f"tokens with {cfg.n_vision_tokens} patch positions, zero3 "
                f"on {NCCL_J_MESH[0]} x {NCCL_J_MESH[1]} over NCCL: loss "
                f"{out['loss']:.6f} (every rank's the same); every rank's "
                f"blocks of the updated parameters against one process's "
                f"on one card max abs {out['params_max_abs']:.3g} "
                f"{'ok' if ok else 'FAIL'} (rtol 1e-4, atol 1e-5; the step "
                f"moved at least {out['moved']:.3f} of a rank's elements by "
                f"more than the atol); ms by "
                f"rank {out['step_ms_by_rank']}, one process "
                f"{one['step_ms']}")
    return out


def _nccl_check_j(ranks, failures):
    """(j)'s checks and numbers: losses finite, the same on every rank
    and falling; one blind_agg_fwd a step on every rank; the resident
    bytes within NCCL_J_RESIDENT a rank."""
    j = {r["rank"]: r["j"] for r in ranks}
    cfg = _fsdp_split_cfg(VLM_ARCH)
    for rank, rj in j.items():
        try:
            _check_train_launches(f"(j) rank {rank}", rj["launches"],
                                  NCCL_J_STEPS)
        except AssertionError as e:
            failures.append(str(e))
        if rj["losses"] != j[0]["losses"] or not all(
                math.isfinite(v) for v in rj["losses"]):
            failures.append(f"(j) rank {rank}: losses {rj['losses']} vs "
                            f"rank 0's {j[0]['losses']}")
        if rj["weights"] + rj["grads"] + rj["adam"] > NCCL_J_RESIDENT:
            failures.append(f"(j) rank {rank}: resident "
                            f"{(rj['weights'] + rj['grads'] + rj['adam']) / 1e9:.2f}"
                            f" GB, over {NCCL_J_RESIDENT / 1e9:.0f}")
    losses = j[0]["losses"]
    if not losses[-1] < losses[0]:
        failures.append(f"(j) losses {losses} do not fall")
    ms = {r: statistics.median(rj["step_ms"][1:]) for r, rj in j.items()}
    slow = max(ms.values())
    out = {"arch": cfg.name, "params": _fsdp_n_params(cfg),
           "mesh": list(NCCL_J_MESH), "steps": NCCL_J_STEPS,
           "tokens_a_step": TRAIN_BATCH * TRAIN_SEQ, "losses": losses,
           "step_ms_by_rank": {r: rj["step_ms"] for r, rj in j.items()},
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / slow * 1e3,
           "resident_bytes_by_rank": {
               r: {k: rj[k] for k in ("weights", "grads", "adam")}
               for r, rj in j.items()},
           "peak_bytes_by_rank": {r: rj["peak"] for r, rj in j.items()},
           "step_bytes_by_rank": {r: rj["step_bytes"][-1]
                                  for r, rj in j.items()},
           "step_collectives": j[0]["step_counts"],
           "draw_s_by_rank": {r: rj["draw_s"] for r, rj in j.items()},
           "rows_by_rank": {r: rj["rows"] for r, rj in j.items()}}
    log("nccl", f"(j) {cfg.name} at full width and depth ({cfg.n_layers} "
                f"layers, three "
                f"{_lm_system(cfg, 'meta').party_cfgs[1].n_layers}-layer "
                f"proxies; {out['params']} parameters), bfloat16, remat "
                f"{cfg.remat}, adam 1e-3 clip 1.0, zero3 + ZeRO-1 on "
                f"{NCCL_J_MESH[0]} x {NCCL_J_MESH[1]} over NCCL, "
                f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step (rows a rank "
                f"{out['rows_by_rank']}; {cfg.n_vision_tokens} patch "
                f"positions a row): losses {[round(v, 4) for v in losses]} "
                f"(every rank's the same); ms a step by rank "
                f"{ {r: [round(x, 1) for x in rj['step_ms']] for r, rj in j.items()} }"
                f" (median of steps 2-{NCCL_J_STEPS}: {slow:.1f} on the "
                f"slowest rank, {out['tokens_per_s']:.0f} tokens/s); "
                f"resident weights + gradients + adam GB by rank "
                f"{ {r: round((rj['weights'] + rj['grads'] + rj['adam']) / 1e9, 3) for r, rj in j.items()} }"
                f"; torch.cuda.max_memory_allocated GB by rank "
                f"{ {r: round(rj['peak'] / 1e9, 2) for r, rj in j.items()} }"
                f"; the last step's collective bytes a rank by kind "
                f"{out['step_bytes_by_rank'][0]} ("
                f"{sum(out['step_bytes_by_rank'][0].values()) / 1e9:.2f} "
                f"GB, {j[0]['step_counts'][-1]} collectives); the draw and "
                f"cut {[round(rj['draw_s'], 1) for rj in j.values()]} s")
    return out


def _smi(query):
    """nvidia-smi's csv lines for ``query`` (--query-gpu=...), one a
    card."""
    return subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()


def _card():
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return _smi("--query-gpu=name,power.limit")[0]


def phase_nccl():
    """--phase nccl (the module docstring): the sharded engine and the
    FSDP plan over NCCL on four cards, one a rank. Raises unless four
    cards are visible. Returns the numbers."""
    import concurrent.futures
    import tempfile
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.launch import mesh
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    if n < NCCL_RANKS:
        raise RuntimeError(f"--phase nccl needs {NCCL_RANKS} cards, one a "
                           f"rank; {n} visible")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    for line in (topo.stdout + topo.stderr).rstrip().splitlines():
        log("nccl", f"nvidia-smi topo -m | {line}")
    log("nccl", f"nvidia-smi topo -m exit code {topo.returncode}; peer "
                f"access between the cards (torch.cuda."
                f"can_device_access_peer, row i column j) "
                f"{[[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)] for i in range(n)]}")
    cards = _smi("--query-gpu=index,name,power.limit")
    log("nccl", f"cards {cards}")
    # the sharded engine over NCCL; its depth cut held to one process on
    # one card (itself held to the CPU port by the default run's lm cut)
    cut_ref = {}
    _cut_phase("lm", LM_ARCH, LM_CUT_LAYERS, keep=cut_ref, against_cpu=False)
    sharded_paths, sharded = phase_sharded(cut_ref)
    del cut_ref
    failures = []
    if sharded["backend"] != "nccl":
        failures.append(f"the sharded phase ran over {sharded['backend']}")
    t_plan = time.perf_counter()
    # the plan: (a) at full depth, (d), (e), (e32), (k), (j)
    cfg_a, vlm = _fsdp_split_cfg(TRAIN_ARCH), _fsdp_split_cfg(VLM_ARCH)
    batches_a = _fsdp_batches(cfg_a)
    prompt_full = np.random.default_rng(3).integers(
        0, _fsdp_full_cfg().vocab_size,
        (FSDP_FULL_LANES, FSDP_FULL_PROMPT + 1), dtype=np.int32)
    runs = _nccl_split_runs()
    prompt_e = np.random.default_rng(3).integers(
        0, runs[0][1].vocab_size, (FSDP_FULL_LANES, FSDP_FULL_PROMPT + 1),
        dtype=np.int32)
    it = lm_batch_iterator(vlm.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches_j = [next(it) for _ in range(NCCL_J_STEPS)]
    batch_k = next(lm_batch_iterator(vlm.vocab_size, TRAIN_BATCH,
                                     NCCL_K_SEQ, seed=1))
    with concurrent.futures.ThreadPoolExecutor(1) as ex, \
            tempfile.TemporaryDirectory() as store:
        ref_dir, go = os.path.join(store, "k"), os.path.join(store, "go")
        os.makedirs(ref_dir)
        spawned = ex.submit(mesh.spawn_ranks, _nccl_rank, NCCL_RANKS,
                            batches_a, prompt_full, prompt_e, batches_j,
                            batch_k, ref_dir, go, time.time(),
                            store_dir=store, device="cuda", threads=4,
                            timeout_s=NCCL_TIMEOUT_S)
        one_a, one_d, one_split, one_k = _then_ranks(go, lambda: (
            _fsdp_one_process(cfg_a, batches_a),
            _fsdp_full_one_process(prompt_full),
            {key: _fsdp_full_one_process(prompt_e, c, rounds)
             for key, c, _, rounds in runs},
            _nccl_k_one_process(batch_k, ref_dir)))
        pre_s = time.perf_counter() - t_plan
        ranks = spawned.result()
    ranks_s = max(r["work_s"] for r in ranks)
    for r in ranks:
        failures += _rule_failures("nccl", r, NCCL_RANKS, [
            r["a"]["devices"], r["k"]["devices"], r["j"]["devices"]])
        if r["current_device"] != r["rank"]:
            failures.append(f"rank {r['rank']} bound to card "
                            f"{r['current_device']}")
    res = {"backend": ranks[0]["backend"], "cards": cards,
           "devices_by_rank": {r["rank"]: r["device"] for r in ranks},
           "sharded": sharded,
           "all_gather_gbps_by_rank": {r["rank"]: r["all_gather_gbps"]
                                       for r in ranks},
           "rank_marks_s": {r["rank"]: r["marks"] for r in ranks},
           "start_s": [r["start_s"] for r in ranks],
           "before_ranks_s": pre_s, "ranks_s": ranks_s}
    res["a"] = _fsdp_check_train("nccl", ranks, one_a, failures, cfg_a,
                                 FSDP_MESH)
    res["d"] = _fsdp_check_full(ranks, one_d, failures, tag="nccl")
    for key, c, shape, _ in runs:
        res[key] = _fsdp_check_full(
            ranks, one_split[key], failures, key, c, shape,
            FSDP_SPLIT_F32_REL if len(key) > 1 else None, tag="nccl")
    log("nccl", f"(e) bfloat16 at {runs[0][1].n_layers} layers: round 0's "
                f"logits {res['e']['round0_logits_rel_vs_one_process']:.4g} "
                f"of the largest |logit| from one process's over NCCL, "
                f"beside {NCCL_E_GLOO_GAP} over gloo (printed, not held: "
                f"NCCL sums the bfloat16 partials in another order)")
    res["k"] = _nccl_check_k(ranks, one_k, failures)
    res["j"] = _nccl_check_j(ranks, failures)
    rate = ranks[0]["all_gather_gbps"]
    paths = [_sum_launches([r[k]["launches"] for r in ranks])
             for k in ("a", "d") + NCCL_SPLIT + ("k", "j")]
    res["launches"] = {"sharded": sharded_paths, "plan": dict(zip(
        ("a", "d") + NCCL_SPLIT + ("k", "j"), paths))}
    res["seconds"] = time.perf_counter() - t_phase
    log("nccl", f"all-gather of 16 MB a rank over the 4 ranks, by rank "
                f"{res['all_gather_gbps_by_rank']} GB/s (rank 0: CUDA "
                f"tensors over {rate['backend']} {rate['device']}, host "
                f"tensors over gloo {rate['host']}); an all-reduce of 16 "
                f"KB on the cards {rate['small_all_reduce_us']} us; "
                f"launches by path "
                f"{res['launches']}; the plan's one-process runs "
                f"{pre_s:.1f} s, the ranks' work {ranks_s:.1f} s after "
                f"(in the group {[round(x, 1) for x in res['start_s']]} s "
                f"after the spawn); phase took {res['seconds']:.1f} s on "
                f"{cards}")
    if failures:
        raise AssertionError("nccl phase: " + "; ".join(failures))
    return res


def _table2_batches(n):
    from repro_torch.data import batch_iterator, make_dataset, vertical_partition
    ds = make_dataset("mnist_like")
    ds.x_test_parts = vertical_partition(ds.x_test, 4, ds.image_hw)
    it = batch_iterator(ds.x_train, ds.y_train, SLICE_BATCH, seed=0)
    batches = []
    for _ in range(n):
        xb, yb = next(it)
        batches.append((vertical_partition(xb, 4, ds.image_hw), yb))
    return ds, batches


def _same_bits(outs, path):
    """How many of ``outs`` equal, bit for bit, the tensors saved at
    ``path`` by another run (of another checkout) on the same inputs."""
    import torch
    theirs = torch.load(path)
    if len(theirs) != len(outs):
        raise AssertionError(f"{path} holds {len(theirs)} outputs, this run "
                             f"{len(outs)}")
    bits = lambda t: t.cpu().contiguous().view(torch.uint8)
    return sum(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(bits(a), bits(b)) for a, b in zip(outs, theirs))


def run_phase(name, save=None, compare=None):
    """One timing phase alone (after the build), for comparing two
    checkouts in turns: ``engines`` (the Table II train step on both
    engines), ``many`` (three times 20 fused many-party rounds), ``rg``
    (the recurrentgemma-9b serving run, prefill and decode times and
    profiler windows), ``train`` (the train phase), ``agg`` (blind_agg_fwd and blind_agg_bwd at their
    timing shapes beside the launch floor; ``save`` / ``compare`` as for
    ``prng``, every backward output required to match), ``flash``
    (flash_attention_fwd at its timing shapes), ``rglru`` (rglru_scan_fwd
    at its timing shapes, checked bit for bit against its plain version)
    or ``prng`` (blind_agg_prng_fwd's cases against its plain version,
    then its timing shapes; ``save`` writes the kernel's outputs at those
    cases to a file, ``compare`` checks them bit for bit against such a
    file from another checkout). Prints its numbers as one JSON line."""
    import torch
    from repro_torch import checkpoint
    phase_build()
    if name == "engines":
        _, batches = _table2_batches(10)
        params0 = checkpoint.params_to_numpy(_build_slice(
            "easter", "cpu").init_params(torch.Generator().manual_seed(0)))
        res = phase_engines(batches, params0)
    elif name == "many":
        cpu, fused = _build_many("cpu"), _build_many("cuda")
        params0 = checkpoint.params_to_numpy(
            cpu.init_params(torch.Generator().manual_seed(0)))
        data = _many_data(cpu)
        res = {"fused_ms": []}
        for _ in range(3):
            ms = _rounds(fused, params0, data, MP_ROUNDS,
                         "blind_agg_prng_fwd")[0]
            res["fused_ms"].append(statistics.median(ms[5:]))
        log("many", f"fused ms per round (median of rounds 5-"
                    f"{MP_ROUNDS - 1}), three times: {res['fused_ms']}")
    elif name == "agg":
        outs = {}
        res = phase_timing(outs)
        # and the backward at C = 6, which 1/C does not represent exactly
        g = torch.randn((128, 128), generator=torch.Generator(
            device="cuda").manual_seed(5), device="cuda")
        from repro_torch.kernels import blind_agg as tba
        outs["blind_agg_bwd K=5"] = list(tba.blind_agg_bwd(
            g, 5, torch.float32, torch.bfloat16))
        if save:
            torch.save(outs, save)
        if compare:
            theirs = torch.load(compare)
            bits = lambda t: t.cpu().contiguous().view(torch.uint8)
            same = {k: len(v) == len(theirs[k]) and all(
                a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(bits(a), bits(b))
                for a, b in zip(v, theirs[k])) for k, v in outs.items()}
            log("agg", f"outputs bit for bit those in {compare}: {same}")
            res["bit_identical_to_compared"] = same
            if not all(v for k, v in same.items() if "bwd" in k):
                raise AssertionError(f"blind_agg_bwd outputs differ from "
                                     f"{compare}")
    elif name in ("baselines", "wire"):
        ds, batches = _table2_batches(SLICE_ROUNDS)
        if name == "baselines":
            res = phase_baselines(ds, batches)[1]
        else:
            res = phase_wire(ds, batches, checkpoint.params_to_numpy(
                _build_slice("easter", "cpu").init_params(
                    torch.Generator().manual_seed(0))))
    elif name == "flash":
        res = phase_timing_flash()
    elif name == "rglru":
        res = {str(k): v for k, v in phase_timing_rglru().items()}
    elif name == "rg":
        res = _serve_phase("rg", RG_ARCH)[1]
    elif name in ("moe", "mamba"):
        res = phase_moe_or_mamba(name)[1]
    elif name == "whisper":
        res = phase_whisper()[1]
    elif name == "vlm":
        res = phase_vlm()[1]
    elif name == "frontend_cuts":
        res = dict(zip(("whisper_cut", "vlm_cut"), _frontend_cuts()))
    elif name == "cuts":
        res = {"gemma_cut": _cut_phase(
                   "gemma_cut", GEMMA_ARCH, GEMMA_CUT_LAYERS,
                   check_host=True, batch=GEMMA_CUT_BATCH,
                   prompt_len=GEMMA_CUT_PROMPT),
               "moe_cut": _cut_phase("moe_cut", MOE_ARCH, MOE_CUT_LAYERS,
                                     check_host=True, scaled_atol=True),
               "mamba_cut": _cut_phase("mamba_cut", MAMBA_ARCH,
                                       MAMBA_CUT_LAYERS,
                                       prompt_len=MAMBA_CUT_PROMPT)}
        res.update(zip(("whisper_cut", "vlm_cut"), _frontend_cuts()))
    elif name == "train":
        res = phase_train()[1]
    elif name == "sharded":
        cut_ref = {}
        _cut_phase("lm", LM_ARCH, LM_CUT_LAYERS, keep=cut_ref)
        res = phase_sharded(cut_ref)[1]
    elif name == "fsdp":
        res = phase_fsdp()[1]
    elif name == "split_depth":
        res = phase_split_depth()
    elif name == "tsplit":
        res = phase_tsplit()
    elif name == "nccl":
        res = phase_nccl()
    elif name == "prng":
        outs = []
        phase_prng(outs)
        res = {str(k): v for k, v in phase_timing_prng().items()}
        if save:
            torch.save([o.cpu() for o in outs], save)
        if compare:
            same = _same_bits(outs, compare)
            log("prng", f"{same} of {len(outs)} outputs bit for bit those "
                        f"in {compare}")
            res["bit_identical_to_compared"] = f"{same}/{len(outs)}"
            if same != len(outs):
                raise AssertionError(f"prng outputs differ from {compare}")
    else:
        raise ValueError(f"unknown phase {name!r}")
    print(json.dumps({"phase": name, **res}))
    print(_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    from repro_torch import checkpoint
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "GPU; see the module docstring")
    ap.add_argument("--phase", help="run one timing phase alone")
    ap.add_argument("--save", help="--phase prng or agg: save the outputs "
                                   "here")
    ap.add_argument("--compare", help="--phase prng or agg: compare the "
                                      "outputs bit for bit with a saved "
                                      "file")
    args = ap.parse_args()
    if args.phase:
        return run_phase(args.phase, args.save, args.compare)
    log("setup", f"torch {torch.__version__} cuda {torch.version.cuda} on "
                 f"{torch.cuda.get_device_name(0)}; "
                 f"torch.backends.cuda.matmul.allow_tf32="
                 f"{torch.backends.cuda.matmul.allow_tf32} "
                 f"torch.backends.cudnn.allow_tf32="
                 f"{torch.backends.cudnn.allow_tf32}")

    t_main = [time.perf_counter()] * 2
    phase_s = {}

    def done(name):
        """The script's timeline: each phase's seconds, printed as it
        ends and kept for the result line."""
        now = time.perf_counter()
        phase_s[name] = round(now - t_main[1], 1)
        t_main[1] = now
        log("time", f"{name} took {phase_s[name]} s ({now - t_main[0]:.1f} "
                    f"s in)")

    libs = phase_build()
    _check_flash_build(libs["flash_attention"])
    _check_rglru_build(libs["rg_lru"])
    done("build")
    worst_f32 = phase_kernels()
    done("kernels")
    worst_f32["blind_agg_prng_fwd"] = phase_prng()
    done("prng")

    ds, batches = _table2_batches(SLICE_ROUNDS)
    table2 = _build_slice("easter", "cpu")
    params0 = checkpoint.params_to_numpy(
        table2.init_params(torch.Generator().manual_seed(0)))
    n_params = sum(a.size for a in tree_leaves(params0))
    log("slice", f"Table II: C=4 MLP parties, embedding widths "
                 f"{[a.hidden for a in table2.arches]}, d_embed {D_EMBED}, "
                 f"batch {SLICE_BATCH}, adam 1e-3, mnist_like split into "
                 f"4 strips of 28x7; {n_params} parameters, random from "
                 f"seed 0; {table2.engine} engine")

    slice_launches, ms_round = phase_slice(ds, batches, params0)
    joint_launches = phase_joint(batches, params0)
    done("slice, joint")
    many_launches, many_joint, many_unfused, fused_ms, unfused_ms = \
        phase_many()
    done("many")
    phase_wires(params0, batches)
    done("wires")
    topk_paths, baselines = phase_baselines(ds, batches)
    done("baselines")
    wire = phase_wire(ds, batches, params0)
    done("wire")
    engines = phase_engines(batches, params0)
    done("engines")
    timing = phase_timing()
    timing_prng = phase_timing_prng()
    phase_profile(batches, params0)
    done("timing, profile")
    worst_f32["flash_attention_fwd"] = phase_flash()
    done("flash")
    lm_launches, lm = _serve_phase("lm", LM_ARCH)
    done("lm")
    cut_ref = {}
    lm_cut = _cut_phase("lm", LM_ARCH, LM_CUT_LAYERS, keep=cut_ref)
    done("lm cut")
    sharded_paths, sharded = phase_sharded(cut_ref)
    done("sharded")
    del cut_ref
    worst_f32["rglru_scan_fwd"] = phase_rglru()
    done("rglru")
    rg_launches, rg = _serve_phase("rg", RG_ARCH)
    # every prefill scan runs at a width of 4096: the TMA ring
    if rg["rglru_paths"] != {"tma": rg_launches["rglru_scan_fwd"],
                             "per_column": 0}:
        raise AssertionError(f"rglru_scan_fwd paths on the serving path: "
                             f"{rg['rglru_paths']}")
    done("rg")
    rg_cut = _cut_phase("rg_cut", RG_ARCH, RG_CUT_LAYERS, check_host=True)
    done("rg cut")
    # the passive group's token embeddings are one offset gather: no copy
    # of the stacked tables in a prefill or a decode round
    timing_flash = phase_timing_flash()
    timing_rglru = phase_timing_rglru()
    done("flash and rglru timing")
    (train_launches, joint_launches_lm), train = phase_train()
    done("train")
    fsdp_paths, fsdp = phase_fsdp()
    done("fsdp")
    gemma_cut = _cut_phase("gemma_cut", GEMMA_ARCH, GEMMA_CUT_LAYERS,
                           check_host=True, batch=GEMMA_CUT_BATCH,
                           prompt_len=GEMMA_CUT_PROMPT)
    done("gemma cut")
    moe_launches, moe = phase_moe_or_mamba("moe")
    done("moe")
    moe_cut = _cut_phase("moe_cut", MOE_ARCH, MOE_CUT_LAYERS,
                         check_host=True, scaled_atol=True)
    done("moe cut")
    mamba_launches, mamba = phase_moe_or_mamba("mamba")
    done("mamba")
    mamba_cut = _cut_phase("mamba_cut", MAMBA_ARCH, MAMBA_CUT_LAYERS,
                           prompt_len=MAMBA_CUT_PROMPT)
    done("mamba cut")
    whisper_launches, whisper = phase_whisper()
    done("whisper")
    whisper_cut, vlm_cut = _frontend_cuts()
    done("frontend cuts")
    vlm_launches, vlm = phase_vlm()
    done("vlm")

    # the passive group's token embeddings are one offset gather and its
    # cross K/V is read in place: no copy of the stacked tables, nor of a
    # layer's group cross K/V, in a prefill or a decode round
    copies = {f"{tag} {w}": n
              for tag, r in (("qwen2.5-3b", lm), ("recurrentgemma-9b", rg),
                             (MOE_ARCH, moe), (MAMBA_ARCH, mamba),
                             (WHISPER_ARCH, whisper), (VLM_ARCH, vlm))
              for w, n in r["table_copies"].items()}
    if any(copies.values()):
        raise AssertionError(f"copies of the stacked embedding tables or "
                             f"cross K/V: {copies}")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    if bad:
        raise AssertionError(f"the port imported {bad[:5]}")

    paths = (slice_launches, joint_launches, many_launches, many_joint,
             many_unfused, topk_paths["easter_topk"],
             topk_paths["easter_topk_fused"], topk_paths["easter_topk_joint"],
             lm_launches, rg_launches, train_launches,
             joint_launches_lm, moe_launches, mamba_launches,
             whisper_launches, vlm_launches) + tuple(sharded_paths) \
        + tuple(fsdp_paths)
    launches = {name: sum(p.get(name, 0) for p in paths)
                for name in ("blind_agg_fwd", "blind_agg_bwd",
                             "blind_agg_prng_fwd", "flash_attention_fwd",
                             "rglru_scan_fwd")}
    log("launches", f"main paths {launches} (Table II slice "
                    f"{slice_launches}, Table II joint {joint_launches}, "
                    f"many-party fused {many_launches}, many-party joint "
                    f"{many_joint}, many-party unfused {many_unfused}, "
                    f"Table II top-k {topk_paths['easter_topk']}, Table II "
                    f"top-k fused {topk_paths['easter_topk_fused']}, Table "
                    f"II top-k joint {topk_paths['easter_topk_joint']}, "
                    f"qwen2.5-3b serving {lm_launches}, recurrentgemma-9b "
                    f"serving {rg_launches}, qwen2-1.5b training "
                    f"{train_launches}, qwen2-1.5b joint step "
                    f"{joint_launches_lm}, qwen2-moe-a2.7b serving "
                    f"{moe_launches}, mamba2-2.7b serving {mamba_launches}, "
                    f"whisper-small serving {whisper_launches}, "
                    f"qwen2-vl-7b serving {vlm_launches}, sharded engine "
                    f"(rank 0's many-party float, int8 and joint rounds, "
                    f"every LM rank's serving) {sharded_paths}, FSDP plan "
                    f"(every rank's qwen2-1.5b zero3 steps, float32 cut's "
                    f"joint step, qwen2.5-3b cut's serving, qwen2.5-3b's "
                    f"tensor-parallel serving, the split qwen2-moe-a2.7b, "
                    f"mamba2-2.7b, recurrentgemma-9b and whisper-small "
                    f"serving) "
                    f"{fsdp_paths})")
    # blind_agg_fwd's launches by party groups, path by path: each path's
    # histogram counts every one of its forward launches
    names = ("Table II slice", "Table II joint", "many-party fused",
             "many-party joint", "many-party unfused", "Table II top-k",
             "Table II top-k fused", "Table II top-k joint",
             "qwen2.5-3b serving",
             "recurrentgemma-9b serving", "qwen2-1.5b training",
             "qwen2-1.5b joint step", "qwen2-moe-a2.7b serving",
             "mamba2-2.7b serving", "whisper-small serving",
             "qwen2-vl-7b serving", "sharded many-party float",
             "sharded many-party int8", "sharded many-party joint",
             "sharded qwen2.5-3b serving", "fsdp qwen2-1.5b training",
             "fsdp qwen2-1.5b cut joint step", "fsdp qwen2.5-3b cut serving",
             "fsdp qwen2.5-3b tensor-parallel serving") + tuple(
                 f"fsdp {c.name} {c.dtype} {c.n_layers}-layer split serving"
                 for _, c, _, _ in _fsdp_split_runs())
    groups = {n: p["fwd_groups"] for n, p in zip(names, paths)}
    log("launches", f"blind_agg_fwd launches by party groups G, path by "
                    f"path: {groups}")
    for n, p in zip(names, paths):
        if sum(p["fwd_groups"].values()) != p["blind_agg_fwd"]:
            raise AssertionError(f"{n}: blind_agg_fwd launches by G "
                                 f"{p['fwd_groups']} do not sum to "
                                 f"{p['blind_agg_fwd']}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    csrc = "src/repro_torch/kernels/csrc/"
    replaces = {"blind_agg_fwd": "src/repro/kernels/blind_agg.py:38",
                "blind_agg_bwd": "src/repro/kernels/blind_agg.py:57",
                "blind_agg_prng_fwd": "src/repro/kernels/blind_agg.py:164",
                "flash_attention_fwd":
                    "src/repro/kernels/flash_attention.py:22",
                "rglru_scan_fwd": "src/repro/kernels/rg_lru.py:25"}
    kernels = []
    for name in ("blind_agg_fwd", "blind_agg_bwd"):
        t = timing["slice"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "blind_agg.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst_f32[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    t = timing_prng[MP_C - 1]
    kernels.append({
        "name": "blind_agg_prng_fwd", "route": "cuda",
        "source": csrc + "blind_agg_prng.cu",
        "replaces": replaces["blind_agg_prng_fwd"],
        "launches": launches["blind_agg_prng_fwd"],
        "max_abs_err": worst_f32["blind_agg_prng_fwd"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None})
    t = timing_flash["1x1023"]
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": csrc + "flash_attention.cu",
        "replaces": replaces["flash_attention_fwd"],
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": worst_f32["flash_attention_fwd"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    t = timing_rglru[1]
    kernels.append({
        "name": "rglru_scan_fwd", "route": "cuda",
        "source": csrc + "rg_lru.cu",
        "replaces": replaces["rglru_scan_fwd"],
        "launches": launches["rglru_scan_fwd"],
        "max_abs_err": worst_f32["rglru_scan_fwd"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels, "slice_ms_per_round": ms_round,
                      "table2_baselines": baselines, "wire": wire,
                      "table2_engines": engines,
                      "many_party_ms_per_round": {"fused": fused_ms,
                                                  "unfused": unfused_ms},
                      "blind_agg": timing,
                      "prng": {str(k): v for k, v in timing_prng.items()},
                      "flash": timing_flash,
                      "rglru": {str(k): v for k, v in timing_rglru.items()},
                      "lm": lm, "lm_depth_cut": lm_cut, "rg": rg,
                      "rg_depth_cut": rg_cut, "table_copies": copies,
                      "train": train, "gemma_cut": gemma_cut, "moe": moe,
                      "moe_cut": moe_cut, "mamba": mamba,
                      "mamba_cut": mamba_cut, "whisper": whisper,
                      "whisper_cut": whisper_cut, "vlm": vlm,
                      "vlm_cut": vlm_cut, "sharded": sharded,
                      "fsdp": fsdp, "phase_s": phase_s}))
    print(_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
