#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``gaussiank_sgd_torch``) on one GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
``python3 chip_smoke.py --zoo`` runs phases 1, 2 and 14 alone, ``--runtime``
phases 1, 2 and 15, ``--bench`` phases 1, 2 and 16, ``--lm`` phases 1, 2
and 17, ``--pod`` phases 1, 2 and 18, ``--elastic`` phases 1, 2 and 19,
``--headline`` phases 1, 2 and 20, ``--lint`` phases 1, 2 and 21, ``--bn``
phases 1, 2 and 22.
It needs one CUDA device and ``nvcc``; it exits nonzero, printing no result,
when either is missing or any phase fails. Phases, one output line each:

1. the card's ``name, power.limit`` as ``nvidia-smi`` gives them;
2. the kernel build (one ``nvcc`` for sm_90a per ``csrc/`` source, started
   together), with its seconds, and B4's registers, spills and shared
   memory from ``-Xptxas -v`` (at most 64 registers);
3. kernel B1 (fused EF accumulate + candidate select) against its plain
   PyTorch version on the card at VGG-16's padded shape [1, 15,073,280],
   cold (t = 0) and warm (t > 0): acc, values, indices and counts must be
   bit-identical; its device time per call (CUDA events around replays of
   a CUDA graph of 20 calls, so the host's launch overhead is left out) and
   the median of 20 eager calls (CUDA events, launch included) beside its
   bound and its plain version's device time;
4. kernel B2 (candidate select) the same way at [1, n] and [4, 65536];
5. kernels B3 (sum, sum of squares, max|x|) and B4 (counts over 32
   thresholds) at [n] = [14,986,698]: B3's max bit for bit and its sums
   within the summation-order tolerance, a second B3 launch bit-identical,
   B4's counts bit for bit on the estimate's log-spaced and linear
   candidates and on a skewed input (every |x| in one bin, so every
   element takes B4's whole search); their times beside their bounds, B4's
   on each of those three inputs, and B3's beside the three library
   reductions it replaces;
6. the main path: BASELINE config 2 (VGG-16 / CIFAR-shaped synthetic data,
   full width, batch 128, bf16, density 0.001) through ``Trainer``, with
   every launch count zeroed just before each run and read just after
   (in a, b and c, B5 exactly once each direction for each of VGG-16's
   13 BatchNorms a step and on the MFU probe's forward and backward):
   a. ``gaussian_fused`` for 2 dense + 4 sparse steps, then one call of the
      registry's flat ``gaussian_fused`` on the run's EF residual: B1 once
      per sparse step, B2 at least once; then the EF invariant
      ``decompress(sent) + residual == acc`` of one more sparse step, bit
      for bit; then 3 sparse steps under ``torch.profiler``;
   b. ``gaussian_pallas`` (the unfused step) for 2 dense + 4 sparse steps:
      B3 exactly 4 and B4 exactly 8 times, no B1 or B2, every sparse
      step's num_selected within 5% of k, then the EF invariant of one more
      sparse step;
   c. config 2 as shipped (``gaussian``) for 2 dense + 2 sparse steps and
      the EF invariant of one more step; every compressor call of the run
      replayed on the CPU from the card's Gaussian estimate, whose
      num_selected, indices and values must equal the card's exactly; a
      count outside the 5% band its ten bisection passes aim at prints each
      pass's count, the witness that the passes ran out;
   d. ``gaussian_warm`` (one host sync a sparse step) for 2 dense + 4
      sparse steps: the same, with a cold first sparse step;
   b, c and d end with 3 more sparse steps under ``torch.profiler``;
   then config 2 with ``gaussian_fused`` again from the same seed, whose
   first loss must repeat bit for bit; and two small narrow-VGG f32 runs
   (``gaussian_fused``, and ``gaussian_pallas`` on a uniform bucket plan)
   that must agree with the same runs on the CPU (the kernels' plain
   versions);
7. the exchange (``torch.distributed``) on this one card:
   a. B1 at the uniform plan's shape [229, 65,536], bit for bit and timed,
      and at one chunk's [1, 65,536] (the pipelined step's call) bit for
      bit;
   b. config 2 with ``gaussian_fused`` for 2 dense + 3 sparse steps on two
      plans, the whole-model bucket (legacy (i32, f32) wire) and 65,536-
      element uniform buckets (packed u16|bf16 wire), each first without a
      process group and then in an NCCL group of one (``parallel/mesh.py``,
      a FileStore): losses, params, momentum, EF row and thresholds bit
      for bit between the two, bytes_sent as the wire says, B1 once a
      sparse step on the whole bucket and once a chunk (229 a step) on
      the uniform plan, which takes the pipelined schedule by default,
      num_selected = k on the cold first sparse step (as on the main
      path), and the EF invariant of one more step against the decoded
      wire values; then the device time of one all-gather of each payload
      and of the 60 MB dense all-reduce;
   c. the ordered scatter: 8 payloads of 15,114 pairs whose coordinates
      repeat across payloads, with padding slots, into a 15M momentum,
      twice on the card and once on the CPU, bit for bit; its time beside
      one plain ``index_add_`` (whose duplicates the card adds in no fixed
      order);
   d. two workers on this card, one process each, in a gloo group (CUDA
      tensors): config 2 on the uniform plan (pipelined: B1 229 times a
      sparse step) for 1 dense + 2 sparse steps, both ranks' parameters
      bit-identical after every step;
8. the ResNet family:
   a. BASELINE config 1 as shipped (resnet20, dense, bf16, batch 128) for
      5 steps; its first loss again from the same seed, bit for bit; and
      resnet20 in f32 at batch 8 for 2 steps, card against CPU;
   b. B1 at ResNet-50's padded EF row [1, 25,559,040] as in phase 3;
   c. BASELINE config 3 (ResNet-50, synthetic ImageNet-shaped uint8 data at
      224^2, batch 64, bf16, density 0.001; in c, d and e B5 exactly once
      each direction for each of its 53 BatchNorms a step and on the MFU
      probe) at one worker with
      ``gaussian_fused`` for 2 dense + 4 sparse steps, then the registry's
      flat call on its EF row: B1 once a sparse step, num_selected = k on
      the cold step, bytes_sent k x 8 B (the legacy wire), the EF
      invariant, the peak device memory; B2 at the flat call's shape
      [1, 25,557,032] bit for bit and timed as in phase 4; then 3 sparse
      steps under ``torch.profiler``;
   d. config 3 as shipped (``gaussian``) for 2 dense + 2 sparse steps:
      num_selected within 5% of k, the EF invariant, and the CPU replay of
      6c;
   e. config 3 with ``gaussian_pallas`` for 2 dense + 4 sparse steps: B3
      exactly 4 and B4 exactly 8 times, num_selected within 5% of k, the EF
      invariant; then B3 and B4 at [25,557,032] on the run's EF row as in
      phase 5;
9. the training loop as users run it (every run up to here takes its
   steps through ``Trainer.train``, without eval passes or checkpoints):
   a. config 3 with ``gaussian_fused`` through ``Trainer.fit()`` for 20
      steps (1,024 synthetic images a split, 16 steps an epoch), an eval
      pass and a checkpoint every epoch, written to a temporary directory:
      eval lines at steps 16 and 20 over 1,024 images (val_loss finite,
      top1 <= top5 in [0, 1]), sealed checkpoints at steps 16 and 20, B1
      once a sparse step; each eval pass's wall time and images/s, each
      checkpoint's bytes and save time;
   b. a fresh trainer resumed from step 16 runs steps 17-20: its losses
      and, at step 20, its params, momentum, EF row (pad zero), thresholds
      and BatchNorm statistics equal the uninterrupted run's bit for bit
      (cuDNN pinned deterministic by ``device.py``); the restore's time;
   c. config 3 with ``--nsteps-update 2 --clip-norm 1.0`` for 2 dense + 2
      sparse steps of two 64-row microbatches: every post-clip gradient
      norm within 1.0 x (1 + 1e-6), the EF invariant exact on one more
      sparse step, peak memory beside phase 8c's;
   d. config 1 (resnet20, f32) after 2 steps, the same state evaluated on
      the card and on the CPU over 512 test images: top1 and top5 equal,
      val_loss within 1e-4;
10. BASELINE config 4 (2-layer LSTM, vocabulary 10,000, 650 wide, PTB-
   shaped synthetic tokens, bptt 35, batch 20, f32, density 0.01, clip
   0.25, the hidden state carried across windows) at one worker:
   a. ``gaussian_fused`` for 2 dense + 4 sparse steps, then the registry's
      flat call on the EF row: B1 once a sparse step (SEG 32), B2 in the
      flat call, B3 and B4 never; num_selected / k of each step; every compressor call
      replayed on the CPU from the card's inputs, equal bit for bit; the
      EF invariant of one more step; the next window's eval loss from the
      carried state and from zeros, which must differ; the share of exact
      zeros in the embedding's gradient; then 3 sparse steps under
      ``torch.profiler`` (device time a step, busy share, operators, peak
      memory);
   b. B1 at config 4's padded EF row [1, 19,791,872] on the run's EF row
      and a real gradient, cold and warm, bit for bit and timed; B2 on the
      accumulator at [1, 19,775,200] the same way;
   e. an eval pass over the validation stream from a zero carry:
      perplexity finite;
   c. ``gaussian_pallas`` for 2 dense + 4 sparse steps: B3 exactly 4 and
      B4 exactly 8 times; every B4 count replayed on the CPU from the
      card's input and thresholds, and each selection at the card's
      threshold, equal; the EF invariant; B3 and B4 timed at
      [19,775,200];
   d. config 4 as shipped (``gaussian``) for 2 dense + 2 sparse steps,
      each call replayed on the CPU as in 6c;
   f. a narrow LSTM (32 wide, f32, dropout off) for 3 steps on the card
      and on the CPU: losses within 1e-5 relative;
11. BASELINE config 5 (Transformer-base: vocabulary 32,000, 512 wide,
   6 + 6 layers, 8 heads, ffn 2048, synthetic copy-reverse pairs of 64
   tokens, batch 32, bf16, density 0.001, label smoothing 0.1, clip 1.0)
   at one worker:
   a. ``randomkec`` as shipped for 2 dense + 4 sparse steps: no kernel,
      num_selected = k and bytes_sent = k x 8 B on every sparse step, four
      distinct index sets of k distinct indices, the sent values equal
      ``acc[idx]``, the EF invariant of one more step; two generators
      seeded alike draw the same indices on the card and two ranks under
      ``decorrelate_comp_rng`` draw others; 3 sparse steps under
      ``torch.profiler`` with the draw's (``random_`` and ``topk``) device
      time and share;
   c. an eval pass: the loss finite, the masked token top1 in [0, 1];
   b. the comparison arm (``gaussian`` through ``gaussian_fused``) for 2
      dense + 4 sparse steps and the flat call: B1 once a sparse step, B2
      in the flat call, B3 and B4 never; the EF invariants, a profile; B1 at [1, 60,555,264] and B2 at
      [1, 60,524,544] on the run's rows, bit for bit and timed;
   d. a narrow transformer (64 wide, 2 + 2 layers, f32) evaluated on the
      card and on the CPU from one seed: logits within 1e-4 of their
      largest magnitude;
12. the comparison arms:
   a. BASELINE config 3's TopK arm (``--compressor topk``: ResNet-50 at
      full width, batch 64, bf16, one worker) for 2 dense + 4 sparse steps:
      no kernel; num_selected = k = 25,558 and bytes_sent = k x 8 B on
      every sparse step; the EF invariant of one more step; every call
      equal bit for bit to the CPU's replay from the card's accumulator;
      then 3 sparse steps under ``torch.profiler``: ``aten::topk``'s device
      time a step and its share, beside phase 8c's ``gaussian_fused`` step
      and B1's time, and the peak memory beside 8c's;
   b. config 2 at full width with ``approxtopk``, ``approxtopk16``,
      ``dgcsampling``, ``redsync`` and ``redsynctrim``, 2 dense + 2 sparse
      steps each: no kernel; num_selected (k on the top-k arms, RedSync's
      count in [k, 2k] or its miss), bytes_sent as the spec's slots make it
      (2k for ``redsync``), the EF invariant, every call equal to the CPU's
      replay (DGC's from the card's own sample indices);
   c. config 2 with ``--exchange gtopk`` and ``gaussian_fused`` in an NCCL
      group of one for 2 dense + 2 sparse steps: 0 rounds, bytes_sent 0,
      B2 once a sparse step (the fused EF layout is refused), B1 never, the
      EF invariant against ``global_residual``; then the butterfly of 4
      workers simulated in this process from 4 batches' accumulators (gloo
      refuses CUDA tensors in its point-to-point ops, and NCCL puts one
      rank on a card) on the legacy and the packed wire: every worker's
      global pairs bit-identical, and equal to the same rounds on the CPU;
   d. ``merge_sparse`` at k = 14,987 and 25,558, and ``topk_compress`` at
      [25,557,032] beside ``torch.topk(acc.abs(), k)``, timed as the
      kernels are;
13. the reference's optimizer and exchange options on config 2:
   a. ``gaussian_fused --nesterov --fold-lr --sigma-scale 2.5`` (the optax
      path at lr 1, the EF row accumulating ``lr(step) * g``) for 2 dense
      + 4 sparse steps: B1 once a sparse step, each at the schedule's
      scale (printed, none 1); num_selected / k of every step; every
      compressor call replayed on the CPU bit for bit; B1 bit for bit
      against its plain version at the last step's scale on the run's EF
      row and gradient, cold and warm, and timed; the EF invariant of one
      more step with ``acc = res + lr * g``; config 2's own ``gaussian``
      under the same flags, whose first sparse step's t0 must equal
      ``|mu| + 2.5 sigma`` computed on the CPU from the card's
      accumulator (``gaussian_fused``'s kernel path never estimates), its
      call replayed on the CPU; then 3 sparse steps under
      ``torch.profiler``, their device time a step beside phase 6a's;
   b. the run resumed from its step-4 checkpoint (a temporary directory)
      repeats steps 5-6 bit for bit: losses, params, trace, count, EF row
      and thresholds;
   c. four ranks of a gloo group on this card (CUDA tensors) in the
      two-level layout ``--ici-size 2 --dcn-size 2`` (it re-runs itself as
      ``chip_smoke.py --two-level-worker RANK 4 DIR``): config 2 with
      ``gaussian_fused`` for 1 dense + 2 sparse steps, every rank's
      parameters bit-identical after every step, B1 once a sparse step a
      rank, bytes_sent k x 8 B, the phase's wall time; then a narrow VGG
      (f32) in the same layout on the card and on the CPU: losses within
      rtol 1e-4 and params within rtol 1e-3 / atol 1e-4, the tolerances
      the CPU tests state;
14. the rest of the reference's model zoo at full width, one worker, the
   CLI's defaults (bf16, lr 0.1, SGD with momentum) but ``gaussian_fused``
   at density 0.001 and 2 dense warm-up steps, on the synthetic stand-ins,
   every loss printed; in each run every B1 call is held bit for bit
   against its plain version on the card and the whole compressor call
   against the CPU's replay:
   a. ``lstman4`` / ``an4`` (161 x 200 spectrograms, 8 labels, 256
      utterances, batch 32; n = 16,138,045, B1 at [1, 16,252,928]) for 2
      dense + 4 sparse steps and the registry's flat call (B2): B1 once a
      sparse step, B3 and B4 never, the EF invariant of one more step; the
      CTC loss's backward twice on one batch's logits and the whole
      backward twice on that batch, bit for bit (the determinism the
      resume and the card-vs-CPU checks rest on); an eval pass (val_loss,
      cer); the trained weights in f32 on the card and on the CPU on one
      test batch: CTC losses within 1e-4 and the edit and reference sums
      equal, or the frames whose arg-max differs listed; 3 sparse steps
      under ``torch.profiler``; B1 at its padded row and B2 at [1, n] on
      the run's rows, bit for bit and timed; a narrow lstman4 (hidden 32,
      2 layers, 41 x 24 input, f32) for 3 steps on the card and on the
      CPU: losses within 1e-5 relative; the real-data path: tone wavs in
      two width buckets with transcripts and manifests in a temporary
      directory, 2 steps through ``Trainer``;
   b. ``alexnet`` / ``cifar10`` (batch 128; n = 23,272,266) for 2 dense +
      4 sparse steps; B1 at [1, 23,330,816] on the run's rows, timed;
   c. ``mnistnet`` / ``mnist`` (batch 128; n = 1,663,370) for 2 dense + 2
      sparse steps;
15. the default-on runtime, on CIFAR-10 binary files written from a seed
   (5 x 256 train and 256 test records), every B1 call of the phase held
   bit for bit against its plain version as it runs:
   a. config 2 with ``gaussian_fused``, ``--save-every-steps 2
      --max-consecutive-skips 2 --log-every 1`` and NaN batches at steps
      5-6: two guard skips, one rollback to step 4 with ``lr_scale`` 0.5,
      the restored state that step's bit for bit, the EF invariant from
      the restored row, and steps 5-8 equal to a fresh trainer resumed
      from step 4 at lr / 2 bit for bit; then again under ``--fold-lr``
      (B1 at ``lr(step)``, halved after the rollback);
   b. a child ``python -m gaussiank_sgd_torch.train`` at config 2, sent
      SIGTERM at its first sparse step line: exit 0, one ``preempt`` event,
      a sealed checkpoint at that step; resumed here to step 40, its state
      equals an uninterrupted run's bit for bit;
   c. config 2's stream with one ``TransientIOError``: one ``io_retry``
      and the clean stream's batches bit for bit; config 3 through the
      prefetching loader (2 dense + 4 sparse steps, each one's wall ms,
      then 3 traced by ``--profile-steps``: the trace's busy share);
   d. ``make_cifar`` serves ``CifarPipeline``; config 2 with
      ``label_noise`` 0.1 for 2 dense + 2 sparse steps, every batch it fed
      equal to the CPU replay bit for bit;
16. the step's instruments and its pipelined schedule (``benchlib.py``),
   each run's launch counts zeroed before it and read after it:
   a. ``bench_model`` on config 2 (VGG-16, batch 128, bf16, density 0.001)
      with ``gaussian_fused``, ``gaussian_pallas``, ``ef_only`` and dense,
      10 steps a run, 4 rotated rounds (8 until phase 21 came; cut for
      the script's time): each program's min and median ms a
      step, each sparse arm's paired and noise-floored delta against
      dense and ``gaussian_fused``'s against ``ef_only`` (select + pack),
      sparse / dense, bytes_sent, MFU; then config 3 (ResNet-50, batch
      64, 224^2) with ``gaussian_fused`` and dense the same way;
   b. in an NCCL group of one, ``bench_overlap`` on config 2 at 4 chunks
      of 4,194,304 (k 4,195 a chunk, the legacy wire): the ``auto`` build
      pipelined, bytes_sent 134,240 B on both schedules, overlapped
      100,680 B, the four programs' ms and both ``exposed_exchange_ms``;
      then 3 sparse steps of each schedule from one seed through
      ``Trainer``, the states bit for bit, B1 once a step at [4,
      4,194,304] and 4 times a step at [1, 4,194,304], every call held
      bit for bit against its plain version, and B1 timed at both shapes;
   c. config 2 on the uniform 65,536 plan under ``--overlap auto`` and
      ``off``: 2 dense + 1 sparse step with every B1 call ([229, 65,536]
      sequentially, 229 at [1, 65,536] pipelined) held bit for bit
      against its plain version, then 2 dense + 3 sparse steps unchecked:
      the records' ``overlap``, bytes_sent 60,456 and
      overlapped_bytes_sent 60,192, the states bit for bit, B1 229 times a
      sparse step pipelined, the step ms of both; then 4,000,000-element
      chunks, which the fused-EF gate refuses: B2 once a sparse step at
      [4, 4,000,000] sequentially and once a chunk at [1, 4,000,000]
      pipelined, every call held bit for bit, the states bit for bit;
   d. two gloo ranks on this card (it re-runs itself as ``chip_smoke.py
      --bench-worker RANK 2 DIR``) at 4 chunks, both schedules: each rank
      bit for bit equal to the other and to its sequential run;
   e. config 2 with ``--phase-timing --log-every 2`` through ``Trainer``:
      the records' ``fwd_bwd_s``, ``select_s``, ``comm_update_s``,
      ``exposed_exchange_ms``, ``ex_per_s`` and ``mfu``;
17. transformer_lm, ring attention and the telemetry spine:
   a. transformer_lm at the reference's default width (dim 512, 8 heads, 6
      layers, ffn 2048, PTB's 10,000 words: n = 24,035,328) on synthetic
      PTB at bptt 256, bf16, ``gaussian_fused`` at density 0.001: 2 dense
      + 4 sparse steps and the registry's flat call, every B1 and B2 call
      held bit for bit as it runs (B1 4, B2 1, B3 and B4 0 launches); an
      eval pass (perplexity); the EF invariant of one more step; B1 timed
      at its padded row and B2 at [1, n]; 3 sparse steps under
      torch.profiler; a narrow f32 run card vs CPU, losses within rtol
      1e-5;
   b. the ring on the card, every rank of an sp ring in this one process
      (``ring_attention_blocks``) at T = 2048, 8 heads of 64, sp = 2, 4
      and 8, f32 and bf16 inputs, against plain causal attention within
      rtol 3e-4 / atol 3e-5;
   c. the trainer at (dp 1, sp 2): two gloo ranks on cuda:0 (it re-runs
      itself as ``chip_smoke.py --sp-worker RANK 2 DIR``; the ring's hops
      staged through host memory), full width, f32, dropout off, batch 8,
      2 dense + 2 sparse steps, every B1 call held: both ranks' parameters
      bit-identical after every step, the losses within rtol 1e-4 of the
      same run at sp = 1 (the ring's f32 sums in another order can move an
      entry across the threshold);
   d. config 2 through ``Trainer`` with ``--trace on --prom-textfile`` and
      beside it without: the stream validates strictly with ``seq``
      gap-free and a whole span tree, ``build_chrome_trace`` renders it,
      the textfile parses, and the sparse step's ms with the trace on and
      off (6 steps each, in turns);
18. the pod rig and run health:
   a. config 2 at full width through the pod launcher
      (``training/launch.py``'s ``Supervisor``, its worker command line
      overridden to ``chip_smoke.py --pod-worker I``, which runs the
      launcher's own ``worker_main`` with every B1 call held bit for bit):
      2 ranks on this card over gloo (``--dist-backend gloo``; NCCL puts
      one rank on a card), 4,096 synthetic images (16 steps an epoch, so
      the run stays inside the first), 2 dense + 8 sparse steps, a
      checkpoint every 4, worker 1 SIGKILLed when it pulls step 7's batch:
      a ``worker_lost`` record with exit code -9, a ``worker_relaunch``
      from the sealed ``step_00000004``, exit 0, ``telemetry merge
      --strict`` of both workers' streams and ``supervisor.jsonl`` exits 0
      and ``telemetry health`` of it 2; both ranks' final parameters
      (sha256) equal, and equal to the same pod's without the kill; the B1
      calls of each generation and rank; each generation's wall time and
      the time from the loss seen to the respawn; then a clean pod of 4
      steps through ``python -m gaussiank_sgd_torch.training.launch``:
      exit 0, both streams strictly valid;
   b. config 2 in one process with ``--health on --health-port 0
      --log-every 2``, 10 steps: 5 ``ok`` verdicts, ``/healthz`` worst
      ``ok``, ``telemetry health`` exit 0, ``ok`` in the report;
   c. the same with a NaN batch at step 7 and ``--max-consecutive-skips
      1``: an ``instability`` verdict within 2 log intervals, a
      ``rollback``, ``/healthz`` 503 and ``critical``, ``telemetry
      health`` exit 2, ``instability`` in the report; every B1 call of b
      and c held bit for bit;
   d. the wall ms of a sparse step (``train(1)``, synchronised) with
      health on and off, 6 steps each in turns, and the verdict pass's
      time;
19. the adaptive policy engine and the elastic service on config 2 at
   full width:
   a. ``--policy adaptive --log-every 2 --compress-warmup-steps 2
      --save-every-steps 2 --trace on``, 16 steps, the engine's rules
      replaced by a scripted one (hysteresis 1, no cooldown, a skip burst
      of 2): ``gaussian_fused`` -> ``gaussian_pallas`` at step 4 (the
      flat parameter, momentum and EF row from 15,073,280 to 14,986,698
      elements), density 0.001 -> 0.002 at step 10 once that decision's
      probation has passed, NaN batches at steps 13 and 14: the engine
      reverts and quarantines the density decision. At each rebuild the
      first n entries of the three vectors bit for bit and the tail zero;
      B1 only on the fused sparse steps, then B3 once and B4 twice a
      sparse step, every call held against its plain version as it runs
      (B1 and B4 bit for bit, B3's max bit for bit and its sums within
      phase 5's tolerance, non-finite in both on the NaN steps);
      num_selected within 5% of k at each density; 2 ``policy_decision``
      and 1 quarantined ``policy_revert``, ``recompiles`` 3, the stream
      strictly valid, the last loss finite; the wall ms of each
      ``policy_rebuild`` span and of the decisions' checkpoint seals;
   b. the shipped rules, 40 steps (4 dense), the engine handed a floor of
      the reference's fused-path bytes (``12n + 16nc + 12k``) over a copy
      rate measured here, printed beside the committed floor the trainer
      loads on the card (which must be there): the
      decisions, each arm's steady step EMA, ``recompiles`` against the
      budget; B1 exactly on the sparse steps run under ``gaussian_fused``,
      each bit for bit; the stream strictly valid;
   c. the elastic service: an ``ElasticSupervisor`` of 2 gloo ranks on
      this card (workers ``chip_smoke.py --pod-worker I``), 6,144
      synthetic images (12 steps inside the first epoch at 2 and 3
      ranks), a checkpoint every 2 steps, worker 1 SIGKILLed at the pull
      of step 3's batch in generation 0, then ``--resize-at 4:3 8:2`` with
      a step budget of 10: ``worker_lost`` -9 and a same-width relaunch,
      ``resize_commit`` (2, 3) and (3, 2) within the budget, exit 0;
      ``telemetry validate --strict`` of ``supervisor.jsonl``, ``merge
      --strict`` of every stream, ``health`` exit 1 or 2; every restored
      EF row bit for bit ``sum_p(rows) / P'`` of the sealed checkpoint's
      rank files; both ranks' final parameters equal; every B1 call held
      bit for bit, by generation and rank; each generation's wall and each
      resize's ``duration_s``; then ``python -m
      gaussiank_sgd_torch.service`` 2 -> 1 at step 4, 6 steps: exit 0, one
      ``resize_commit``, every stream strictly valid;
20. the headline bench driver (``python -m gaussiank_sgd_torch.bench``):
   a. in a fresh process (``chip_smoke.py --headline-worker full DIR``),
      ``bench.main`` over all five BASELINE configs at the reference's
      batches and rounds, in 1 window of the bench's 2 (cut for the
      script's time), its history in ``DIR``: per config
      the min-over-windows and pooled paired ratios, the round spread,
      dense and sparse step ms, MFU and the overhead against the
      committed floor, then the compact line; B1's and B2's launches by
      config equal to the counts derived from the tables (a warm-up and
      rounds x windows timed calls of n_steps sparse steps, one B1 each;
      B2 where the fused-EF gate refuses a plan); then one B1 call at each
      config's padded EF row bit for bit against its plain version;
   b. vgg16 alone with the overlap arm in another fresh process: its dense
      step beside 20a's, the arm's ``auto`` build ``pipelined`` on the
      4-chunk plan with ``overlapped_bytes_sent`` > 0, its B1 launches
      derived the same way (one a step sequentially, one a chunk
      pipelined, the exchange-less twins alike);
   c. the floor re-priced on this card: bytes, k and nc equal to the
      committed ``gaussiank_sgd_torch/artifacts/roofline.json``'s and
      every floor within 5% of it; ``load_roofline_floor`` on the card
      gives the committed floors (None for mnistnet); 19b's copy-rate
      floor printed beside the loaded vgg16 floor;
   d. the regression sentinel on the committed history: ``--self-test``
      exits 0, the comparison's table and exit code, and ``--emit-event``
      a strictly valid ``bench_regression`` record (``bench_matrix`` runs
      in 21b);
   then the script's total time;
21. the lint tool's step audit, the policy A/B harness and convergence
   parity:
   a. ``lint audit`` (``gaussiank_sgd_torch/lint/program_audit.py``) on
      the card in an NCCL group of one: each of the reference's 13 arms
      builds its ``DPTrainStep``, runs a step and two warm steps; each
      warm step's host syncs (``torch.cuda.set_sync_debug_mode``) within
      the arm's allow-list, printed beside it; its collective inventory
      equal to the committed ``.gklint-torch-programs.json``; both
      identities bit for bit; then the ``gaussian_fused`` arm again at
      density 1/32 (its own 0.0625 is above B1's 1/32 and runs the warm
      fallback), on its 128-element buckets, which the fused-EF gate
      refuses (B2 a bucket), and on 2,048-element ones (B1 a chunk), each
      B1/B2 call held bit for bit as it runs and each kernel launched;
   b. ``policy_ab --measure``: ``bench_matrix``'s quick matrix over the
      five BASELINE configs on the card at most 10 steps a timed run (B1's
      launches by config as derived: 4 x min(n_steps, 10) on the
      ``gaussian_fused`` cell), then the engine's
      replay against the card-priced floor (``load_roofline_floor``);
      each config's ratios, floor and the adaptive arm's path, the
      decision log and the acceptance block; then one untimed B1 call at
      each config's padded row bit for bit;
   c. ``convergence_parity`` at the committed artifact's settings
      (mnistnet, density 0.01, 300 steps, batch 8, lr 0.005, 10 dense
      steps; arms dense, ``gaussian``, ``topk``, ``gaussian@gtopk``,
      ``gaussian_fused``) on 2 gloo ranks on this card beside the
      reference's 8: every arm's val loss < 0.2 and each compressed arm's
      top-1 >= dense - 0.03; B1 once a sparse step a rank on the
      ``gaussian_fused`` arm, no kernel on the others; then one B1 call at
      mnistnet's padded row at density 0.01 bit for bit;
22. kernel B5 (train-mode BatchNorm, forward and backward) at every
   BatchNorm input layout of ResNet-50 (batch 64), VGG-16 (batch 1,024)
   and lstman4 (batch 16) in bf16, as the models hand them on (found by
   running each model's forward): y, the running statistics, dx, d scale
   and d bias against the plain version within ``B5_LIMITS`` (relative
   L2) for an upstream gradient affine in x per channel plus noise (so
   dx's mean and variance terms are most of it at every size), one launch
   of each direction counted, then forward and backward
   device time (CUDA graphs), an eager forward + backward through autograd,
   the plain version's and ``torch.batch_norm``'s (a yardstick the port
   never calls) beside the 14 B an element bound; per model the sums over
   a step's BatchNorms;
23. a ``{"kernels": [...]}`` line with each kernel's launches, error,
   device time (``ms``), eager call time (``call_ms``), plain-version time,
   bound and library time; B4's ``ms`` is on the linear candidates, with
   ``ms_log`` and ``call_ms_log`` on the log-spaced ones; B1 also at
   [229, 65,536] and its launches on the exchange runs; under
   ``resnet50`` each kernel's launches on config 3's runs and B1's, B2's,
   B3's and B4's times at ResNet-50's shapes; under ``training_loop`` B1's
   launches on phase 9's runs; under ``lstm`` and ``transformer`` each
   kernel's launches on config 4's and config 5's runs (B3 and B4 under
   ``transformer``: on the comparison arm, where they must be 0) and its
   times at their shapes; under ``comparison`` each kernel's launches on
   phase 12's runs (B2's on the gTop-k run, 0 for the rest); under
   ``options`` B1's launches on phase 13's runs and its times at the
   folded scale; under ``zoo`` B1's launches on phase 14's runs and its
   times at lstman4's and AlexNet's rows, and B2's launch and time at
   lstman4's [1, n]; under ``runtime`` B1's launches on phase 15's runs;
   under ``bench`` each kernel's launches on phase 16's runs and B1's times
   at [4, 4,194,304] and [1, 4,194,304]; under ``transformer_lm`` each
   kernel's launches on phase 17a's run and 17d's traced runs, B1's on
   17c's ranks and sp = 1 run, and B1's and B2's times at
   transformer_lm's padded row and [1, n]; under ``pod`` B1's launches on
   phase 18's checked runs, by pod, generation and rank, and on 18b-c;
   under ``policy_elastic`` B1's, B3's and B4's launches on phase 19's
   checked runs (B1's in 19c by generation and rank); under ``headline``
   each kernel's launches on phase 20's runs, by config; under ``lint``
   each kernel's launches on phase 21's runs (the audit, the matrix by
   config, convergence parity by arm and rank); B5's launches on the
   main path (6a), on config 2's runs (6a-c) and config 3's (8c-e), on
   phase 22's checks and, apart, in its timing loops, and its times by
   model and shape.

The last line is ``{"ok": true, "device": {...}}``. ``--worker RANK WORLD
DIR`` runs one rank of phase 7d, ``--two-level-worker RANK WORLD DIR`` one
of phase 13c, ``--bench-worker RANK WORLD DIR`` one of phase 16d and
``--sp-worker RANK WORLD DIR`` one of phase 17c, ``--pod-worker I``
one worker of phase 18a or 19c, its spec in the environment, and
``--headline-worker full|vgg16 DIR`` the process of phase 20a or 20b (the
script starts those processes itself).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
CONFIG1 = os.path.join(REPO, "exp_configs",
                       "config1_resnet20_cifar10_dense.json")
CONFIG2 = os.path.join(REPO, "exp_configs",
                       "config2_vgg16_cifar10_gaussian.json")
CONFIG3 = os.path.join(REPO, "exp_configs",
                       "config3_resnet50_imagenet_gaussian.json")
CONFIG4 = os.path.join(REPO, "exp_configs", "config4_lstm_ptb_gaussian.json")
CONFIG5 = os.path.join(REPO, "exp_configs",
                       "config5_transformer_wmt_randomk.json")
# n, k and padded EF row of config 4 (the LSTM at density 0.01) and of
# config 5 (Transformer-base at density 0.001)
LSTM = (19_775_200, 197_752, 19_791_872)
TRANSFORMER = (60_524_544, 60_525, 60_555_264)
WARMUP_2 = ["--compress-warmup-steps", "2", "--max-steps"]
# the small runs of phases 10-11 held card against CPU
DEVICES = {"card": "cuda", "cpu": "cpu"}
# ResNet-50's n, k at density 0.001 and its padded EF row
RESNET50 = (25_557_032, 25_558, 25_559_040)
# BatchNorms a forward of VGG-16 and of ResNet-50: B5's launches of each
# direction a step
BNS = {"vgg16": 13, "resnet50": 53}
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
# the exchange phase's plans: flags over config 2
PLANS = {"whole bucket": [],
         "uniform 65536": ["--bucket-size", "65536", "--bucket-policy",
                           "uniform"]}
EXCHANGE_ARGV = ["--compressor", "gaussian_fused", "--max-steps", "5",
                 "--compress-warmup-steps", "2"]
# each plan's wire, bytes a sent entry and fused EF layout (n_chunks,
# chunk, chunk_pad) at config 2's full width
EXCHANGE_WANT = {"whole bucket": ("i32f32", 8, (1, 14_986_698, 15_073_280)),
                 "uniform 65536": ("u16bf16", 4, (229, 65_536, 65_536))}

# device-memory rate by card name (bytes/s), from NVIDIA's data sheets
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
_F32_RATE = 67e12        # H100 SXM f32 outside the tensor cores, op/s
# operations per element of each kernel
_OPS_SELECT = 8          # B1/B2: abs, compare, key mask/or, max, count
                         # (+ mul, add)
_OPS_STATS = 4           # B3: add, multiply-add (2), max of |x|
_OPS_COUNTS = 65         # B4's function as 32 compare-and-counts: abs, 32
                         # compares, 32 adds (its binary search does less;
                         # the bound is by bytes either way)


def _mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def _bound_ms(n_bytes: int, n_ops: int, mem_rate: float):
    t_bytes = n_bytes / mem_rate * 1e3
    t_ops = n_ops / _F32_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _median_ms(fn, reps: int) -> float:
    import torch
    fn()                                       # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, the graph replayed 5 times between CUDA events, the median
    replay over ``reps``. Unlike ``_median_ms`` this leaves out the host's
    time to launch (Python, argument checks, ctypes), which at these sizes
    is as long as the kernels themselves."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def _time_kernel(what: str, kernel_fn, plain_fn, bound, lib_fn=None,
                 lib_what: str = "") -> dict:
    """Time a kernel's wrapper, its plain version and, where there is one,
    the library composition computing the same, and print them beside the
    bound: ``ms`` is device time (``_device_ms``), ``call_ms`` the eager
    call with its host launch overhead (``_median_ms``)."""
    bound_ms, bound_by = bound
    out = {"ms": _device_ms(kernel_fn, 20),
           "call_ms": _median_ms(kernel_fn, 20),
           "plain_ms": _device_ms(plain_fn, 5),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _device_ms(lib_fn, 20) if lib_fn else None}
    lib = (f", library {lib_what} {out['library_ms']:.4f} ms" if lib_fn
           else "")
    print(f"phase {what} time: {out['ms']:.4f} ms device time per call "
          f"(bound {bound_ms:.4f} ms by {bound_by}, "
          f"{bound_ms / out['ms']:.0%} of it); {out['call_ms']:.4f} ms per "
          f"eager call with its launch; plain version {out['plain_ms']:.4f} "
          f"ms{lib}")
    return out


def _b1_phase(n: int, density: float, gen, mem_rate: float):
    """Kernel B1 at a model's padded EF row ``[1, chunk_pad]`` (random
    residual and gradient on the first ``n`` elements, a zero tail), cold
    (t = 0) and warm (t > 0): acc, values, indices and counts bit for bit
    against its plain version, then timed. Returns ``(times, max abs
    error, res, g, warm threshold)``."""
    import torch
    from gaussiank_sgd_torch.ops import fused_select as fs
    dev = gen.device
    R, _, bpc, _ = fs._chunk_geometry(n, density)
    chunk_pad = bpc * R * 128
    res = torch.zeros(1, chunk_pad, device=dev)
    g = torch.zeros(1, chunk_pad, device=dev)
    res[:, :n] = torch.randn(1, n, device=dev, generator=gen) * 0.01
    g[:, :n] = torch.randn(1, n, device=dev, generator=gen) * 0.01
    return _b1_rows(res, g, n, density, mem_rate)


def _b1_rows(res, g, n: int, density: float, mem_rate: float,
             what: str = "", scale: float = 1.0):
    """B1 on the padded rows ``res`` and ``g`` ``[1, chunk_pad]`` (``n``
    live elements) at ``scale`` (1, or a folded learning rate), cold and
    warm, bit for bit against its plain version, then timed beside its
    bound: ``(times, max abs error, res, g, warm threshold)``."""
    import torch
    from gaussiank_sgd_torch.compressors import k_for
    from gaussiank_sgd_torch.ops import fused_select as fs
    dev = res.device
    k = k_for(n, density)
    nc = fs._chunk_geometry(n, density)[3]
    chunk_pad = res.shape[1]
    cold = torch.zeros(1, device=dev)
    _, warm = fs.gaussian_fused_ef_compress_batched(res, g, scale, k, cold,
                                                    density=density)
    err = 0.0
    for name, t in (("cold", cold), ("warm", warm)):
        out = fs.fused_ef_select_candidates_chunked(res, g, scale, t,
                                                    density)
        ref = fs.fused_ef_select_plain(res, g, scale, t, density)
        torch.cuda.synchronize()
        err = max(err, _same(out, ref, f"B1 [1, {chunk_pad}] {name}"))
        print(f"phase B1 [1, {chunk_pad}]{what} {name}: scale {scale!r}, "
              f"t={float(t[0]):.6g} count={int(out[3][0])} (k {k}, {nc} "
              f"candidate slots) bit-identical (acc, vals, idx, counts)")
    times = _time_kernel(
        f"B1 [1, {chunk_pad}]{what}",
        lambda: fs.fused_ef_select_candidates_chunked(res, g, scale, warm,
                                                      density),
        lambda: fs.fused_ef_select_plain(res, g, scale, warm, density),
        _bound_ms(3 * chunk_pad * 4 + nc * 8 + 8, _OPS_SELECT * chunk_pad,
                  mem_rate))
    return times, err, res, g, warm


def _b3_b4_phase(flat, k: int, mem_rate: float):
    """Kernels B3 and B4 at ``[n]`` on ``flat``: B3's max bit for bit and
    its sums within the summation-order tolerance, a second B3 launch
    bit-identical; B4's counts bit for bit on the estimate's log-spaced
    and linear candidates and on a skewed input (every |x| in one bin);
    then each timed. Returns ``(b3 times, b4 times, b3 error, b4
    error)``."""
    import torch
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops
    n = flat.numel()
    stats = ts_ops.fused_stats(flat)
    again = ts_ops.fused_stats(flat)
    plain = ts_ops.fused_stats_plain(flat)
    torch.cuda.synchronize()
    if not torch.equal(stats[2], plain[2]):
        raise AssertionError("B3: max|x| differs from the plain version")
    sum_abs = float(flat.abs().sum())
    d_sum = abs(float(stats[0] - plain[0]))
    d_sumsq = abs(float(stats[1] - plain[1]))
    if d_sum > 1e-6 * sum_abs or d_sumsq > 1e-5 * float(plain[1]):
        raise AssertionError(f"B3: sums {stats[:2]} vs plain {plain[:2]}")
    _same(again, stats, "B3 repeat")
    b3_err = max(d_sum, d_sumsq)
    print(f"phase B3 [{n}]: max|x| bit-identical, |d sum| {d_sum:.3g} <= "
          f"1e-6 * sum|x| ({sum_abs:.6g}), |d sumsq| {d_sumsq:.3g} <= 1e-5 * "
          f"sumsq ({float(plain[1]):.6g}); a second launch bit-identical")
    s, ss, amax = plain
    mu = s / n
    sigma = torch.sqrt(torch.clamp(ss / n - mu * mu, min=1e-30))
    lo0 = torch.maximum(0.05 * sigma, amax * 1e-7) + 1e-30
    log_cand = ts_ops._log_candidates(lo0, torch.maximum(amax, lo0 * 2.0))
    c1 = ts_ops.multi_threshold_counts(flat, log_cand)
    lin_cand = ts_ops._lin_candidates(*ts_ops._bracket(log_cand, c1, k))
    # a skewed input: every |x| in one bin of the linear candidates, so
    # every element takes the whole search
    mid = lin_cand.sort().values[15:17].mean()
    skewed = torch.where(flat < 0, -mid, mid)
    b4_inputs = (("log", flat, log_cand), ("linear", flat, lin_cand),
                 ("skewed", skewed, lin_cand))
    b4_err = 0.0
    for name, xx, cand in b4_inputs:
        out = ts_ops.multi_threshold_counts(xx, cand)
        ref = ts_ops.multi_threshold_counts_plain(xx, cand)
        torch.cuda.synchronize()
        b4_err = max(b4_err, _same((out,), (ref,), f"B4 [{n}] {name}"))
        print(f"phase B4 [{n}] {name} candidates: counts bit-identical "
              f"{[int(c) for c in out.tolist()]}")
    b3 = _time_kernel(
        f"B3 [{n}]", lambda: ts_ops.fused_stats(flat),
        lambda: ts_ops.fused_stats_plain(flat),
        _bound_ms(n * 4 + 12, _OPS_STATS * n, mem_rate),
        lambda: (flat.sum(), (flat * flat).sum(), flat.abs().amax()),
        "x.sum() + (x*x).sum() + x.abs().amax()")
    b4_by_input = {
        name: _time_kernel(
            f"B4 [{n}] x 32 {name}",
            lambda xx=xx, cand=cand: ts_ops.multi_threshold_counts(xx, cand),
            lambda xx=xx, cand=cand: ts_ops.multi_threshold_counts_plain(
                xx, cand),
            _bound_ms(n * 4 + 2 * 32 * 4, _OPS_COUNTS * n, mem_rate))
        for name, xx, cand in b4_inputs}
    b4 = {**b4_by_input["linear"],
          "ms_log": b4_by_input["log"]["ms"],
          "call_ms_log": b4_by_input["log"]["call_ms"]}
    return b3, b4, b3_err, b4_err


def _ptxas_usage(log: str, kernel: str):
    """``(registers, spill line, usage line)`` that ``-Xptxas -v`` reported
    for the entry function whose name contains ``kernel``, or None."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            spills = next(ln.strip() for ln in lines[i:] if "spill" in ln)
            used = next(ln.split(":", 1)[1].strip() for ln in lines[i:]
                        if "Used" in ln and "registers" in ln)
            return int(used.split()[1]), spills, used
    return None


def _bits(t):
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(kernel_out, plain_out, what: str) -> float:
    """Assert bit-identical outputs; return the max abs error (0.0)."""
    import torch
    err = 0.0
    for i, (a, b) in enumerate(zip(kernel_out, plain_out)):
        if not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"{what}: output {i} differs from the "
                                 f"plain version")
        if a.dtype == torch.float32:
            err = max(err, float((a - b).abs().max()))
    return err


def _reset_launches() -> None:
    from gaussiank_sgd_torch.ops import (batch_norm, fused_select,
                                         threshold_select)
    batch_norm.reset_launches()
    fused_select.reset_launches()
    threshold_select.reset_launches()


def _launches() -> dict:
    from gaussiank_sgd_torch.ops import fused_select, threshold_select
    return {**fused_select.LAUNCHES, **threshold_select.LAUNCHES}


def _bn_launches(trainer, records, per_step: int, what: str) -> dict:
    """B5's launches since the last ``_reset_launches()`` on a fresh
    trainer's run, held to one forward and one backward for each of the
    model's ``per_step`` BatchNorms on each step of ``records`` and on the
    MFU probe (``Trainer._maybe_probe_mfu``: one forward and backward of
    the ``grads`` probe at the run's first log record, where it counted)."""
    from gaussiank_sgd_torch.ops import batch_norm
    got = dict(batch_norm.LAUNCHES)
    passes = len(records) + int(trainer._flops_per_step is not None)
    want = per_step * passes
    if got != {"batch_norm_forward": want, "batch_norm_backward": want}:
        raise AssertionError(f"{what}: B5 launches {got}, want {want} of "
                             f"each ({per_step} BatchNorms x {passes} "
                             f"passes: {len(records)} steps and the MFU "
                             f"probe if it ran)")
    return got


def _config(path, extra, run_id: str, out_dir: str = RUN_DIR):
    """A config file (or, with ``path`` None, the CLI's defaults) through
    the trainer's own flag parsing, at one worker; ``extra`` flags
    override the file."""
    import argparse
    from gaussiank_sgd_torch.training.config import add_args, from_args
    from gaussiank_sgd_torch.training.trainer import Trainer
    argv = [*(["--config", path] if path else []), "--nworkers", "1",
            *extra, "--output-dir", out_dir, "--run-id", run_id]
    p = argparse.ArgumentParser()
    add_args(p)
    return Trainer(from_args(p.parse_args(argv), argv))


def _steps(trainer) -> list:
    """The trainer's steps up to ``max_steps`` (``Trainer.train``: no eval
    pass and no checkpoint, which phase 9 drives through ``fit``): their
    records."""
    done = len(trainer.records)
    trainer.train(trainer.total_steps - trainer.state.step)
    return trainer.records[done:]


def _drive(trainer, what: str, then=None, skips: bool = False):
    """``_steps(trainer)``, then ``then()`` if given, with every launch
    count zeroed just before and read just after: ``(records, launches,
    what then() returned)``. A non-finite loss fails, unless ``skips`` and
    the guard skipped that step (then the step line says so)."""
    import torch
    _reset_launches()
    records = _steps(trainer)
    extra = then() if then is not None else None
    torch.cuda.synchronize()
    launches = _launches()
    if not all(math.isfinite(rec["loss"]) or (skips and rec["skipped"])
               for rec in records):
        raise AssertionError(f"{what}: non-finite loss: {records}")
    for rec in records:
        print(f"phase {what} step {rec['step']} {rec['kind']}: loss "
              f"{rec['loss']:.4f} num_selected {rec['num_selected']:.0f} "
              f"k {rec['k']} {rec['step_ms']:.2f} ms"
              + (" (skipped by the guard)" if rec["skipped"] else ""))
    return records, launches, extra


def _within_5pct_of_k(records, what: str) -> list:
    """The reference's count contract on every sparse step."""
    ratios = [rec["num_selected"] / rec["k"] for rec in records
              if rec["kind"] == "sparse"]
    if not ratios or any(abs(r - 1.0) > 0.05 for r in ratios):
        raise AssertionError(f"{what}: num_selected / k = {ratios}, not "
                             f"within 5% on every sparse step")
    return ratios


def _cloned(x):
    """``x`` with every tensor in it (through tuples and NamedTuples)
    cloned."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [_cloned(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _equal_bits(*pairs) -> bool:
    """Every ``(a, b)`` pair equal bit for bit, compared on the CPU."""
    import torch
    return all(torch.equal(_bits(a.cpu()), _bits(b.cpu())) for a, b in pairs)


@contextlib.contextmanager
def _recorded(fn, install, keep):
    """Install, through ``install``, a wrapper of ``fn`` that keeps
    ``keep(args, out)`` of each call for a CPU replay: the arguments as
    they were before the call and its result, cloned on the card. Yields
    the list of kept calls; ``install(fn)`` puts ``fn`` back on exit."""
    calls = []

    def wrapper(*args):
        before = _cloned(args)
        out = fn(*args)
        calls.append(keep(before, _cloned(out)))
        return out

    install(wrapper)
    try:
        yield calls
    finally:
        install(fn)


def _spec_recorded(trainer, field: str, keep):
    """``_recorded`` on the trainer's compressor function ``field``."""
    ts, spec = trainer.ts, trainer.ts.spec

    def install(fn):
        ts.spec = spec._replace(**{field: fn})

    return _recorded(getattr(spec, field), install, keep)


def _recorded_calls(trainer):
    """Each call of the trainer's compressor as ``(acc, k, the carried
    threshold or None, indices, values, num_selected)`` for
    ``_replay_on_cpu``."""
    stateful = trainer.ts.spec.stateful

    def keep(args, out):
        r = out[0] if stateful else out
        return (args[0], args[1], args[2] if stateful else None,
                r.compressed.indices, r.compressed.values, r.num_selected)

    return _spec_recorded(trainer, "fn", keep)


def _traced_bisection(abs_acc, k: int, t0, band):
    """``bisect_threshold``'s passes one at a time: ``(t, each pass's
    count, the last bracket (lo, hi))``."""
    import torch
    hi = abs_acc.amax(dim=-1)
    lo = torch.zeros_like(hi)
    t = torch.minimum(torch.maximum(t0, lo), hi)
    counts = []
    for _ in range(10):
        cnt = int((abs_acc > t).sum())
        counts.append(cnt)
        if band[0] <= cnt <= band[1]:
            break
        if cnt > k:
            lo = t
        else:
            hi = t
        t = 0.5 * (lo + hi)
    return t, counts, (float(lo), float(hi))


def _replay_on_cpu(calls, density: float, what: str,
                   sigma_scale=None) -> list:
    """Each recorded call of ``gaussian`` or ``gaussian_warm`` replayed on
    the CPU from the card's Gaussian estimate t0 (the CPU's own t0 must
    agree within 1e-5: the reductions sum in another order). From there the
    CPU's bisection, count and pack must give the card's num_selected,
    indices and values exactly. The bisection is traced pass by pass, the
    trace held bit for bit against ``bisect_threshold`` (which
    ``tests/test_torch_gaussian.py`` holds bit for bit against the
    reference's). A count outside the 5% band comes with each pass's count
    and the last bracket: the witness that the ten passes ran out. Returns
    one description a call."""
    import torch
    from gaussiank_sgd_torch.compressors.base import (
        _tolerance_band, bisect_threshold, finish_pack, select_by_mask)
    from gaussiank_sgd_torch.compressors.gaussian import (
        _usable, gaussian_threshold_estimate)
    out = []
    for i, (acc, k, st, idx, val, nsel) in enumerate(calls):
        t0 = gaussian_threshold_estimate(acc, density, sigma_scale).cpu()
        a = acc.cpu()
        abs_a = a.abs()
        t0_cpu = gaussian_threshold_estimate(a, density, sigma_scale)
        if abs(float(t0) - float(t0_cpu)) > 1e-5 * float(t0_cpu):
            raise AssertionError(f"{what} call {i}: t0 {float(t0)} on the "
                                 f"card, {float(t0_cpu)} on the CPU")
        band = _tolerance_band(k, 0.05)
        st = st.cpu() if st is not None else None
        if st is not None and bool(_usable(
                (abs_a > st).sum(dtype=torch.int32), st, k)):
            t, priority, counts = st, "magnitude", None
        else:
            t, counts, (lo, hi) = _traced_bisection(abs_a, k, t0, band)
            if not torch.equal(t, bisect_threshold(abs_a, k, t0)):
                raise AssertionError(f"{what} call {i}: the traced "
                                     f"bisection differs")
            priority = "index"
        sent, v, n_sel = select_by_mask(a, abs_a > t, k, priority)
        comp, _ = finish_pack(a.clone(), sent, v)
        if int(n_sel) != int(nsel) or not _equal_bits(
                (comp.indices, idx), (comp.values, val)):
            raise AssertionError(f"{what} call {i}: the card selected "
                                 f"{int(nsel)}, the CPU {int(n_sel)} from "
                                 f"the card's t0, or the packs differ")
        desc = f"{int(nsel) / k:.4f}"
        if counts is None:
            desc += " warm"
        elif not band[0] <= int(nsel) <= band[1]:
            if len(counts) != 10 or any(band[0] <= c <= band[1]
                                        for c in counts):
                raise AssertionError(f"{what} call {i}: out of the band "
                                     f"with passes {counts}")
            desc += (f" cold, outside the band {list(band)}: passes' "
                     f"counts {counts}, last bracket [{lo:.6g}, {hi:.6g}] "
                     f"= {(hi - lo) / float(abs_a.max()):.2e} of max|acc|")
        else:
            desc += " cold"
        out.append(desc)
    return out


def _ef_invariant(trainer, what: str) -> int:
    """``decompress(sent) + residual == acc`` of one more sparse step, bit
    for bit, without committing it, with ``acc = residual + scale * g``
    (the scale is 1, or lr(step) under ``--fold-lr``); returns
    num_selected."""
    import torch
    from gaussiank_sgd_torch.compressors import decompress
    ts, state = trainer.ts, trainer.state
    grads = ts.local_grads(state, trainer.next_batch())
    state.model_state["stats"].copy_(grads.model_state_before["stats"])
    acc = ts.accumulate(state, grads.flat_g)
    comp, residual, nsel, _ = ts.compress_phase(state, grads.flat_g)
    if not torch.equal(decompress(comp, ts.ef_numel) + residual, acc):
        raise AssertionError(f"{what}: decompress(sent) + residual != acc")
    return int(nsel.sum())


def _profile(trainer, what: str, named=()) -> dict:
    """Three more sparse steps under ``torch.profiler``: wall time, device
    time (and a step's) and its busy share, the host reads of device values
    inside the steps and the host time they take, the ten operators with
    the most device time, the device time of the operators ``named`` and
    its share, and the peak device memory of the steps. Returns the device
    ms a step and the ``named`` operators' device ms a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.ts.sparse_step(trainer.state, trainer.next_batch())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows carry the device time; operator rows carry the device
    # time of the kernels they launched (the top list names operators)
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in events if e.device_type == DeviceType.CPU),
                 reverse=True)
    # a device-to-host read inside the step (the warm compressor's branch)
    # blocks the host in _local_scalar_dense until the queue drains
    reads = [e for e in events if e.key == "aten::_local_scalar_dense"]
    n_reads = sum(e.count for e in reads)
    read_ms = sum(e.cpu_time_total for e in reads) / 1e3
    named_ms = sum(ms for ms, _, name in ops if name in named)
    peak = torch.cuda.max_memory_allocated()
    if device_ms > 0:
        share = (f"; {' + '.join(named)} {named_ms / 3:.3f} ms a step, "
                 f"{named_ms / device_ms:.1%} of the device time"
                 if named else "")
        print(f"phase {what}: 3 sparse steps {wall_ms:.2f} ms wall, "
              f"{device_ms:.2f} ms device time ({device_ms / 3:.2f} ms a "
              f"step, {device_ms / wall_ms:.0%} busy){share}; peak memory "
              f"{peak / 2 ** 30:.2f} GiB; {n_reads} host reads of device "
              f"values in them, {read_ms:.3f} ms of host time; operators by "
              f"device time: "
              + "; ".join(f"{name} x{cnt} {ms:.3f} ms"
                          for ms, cnt, name in ops[:10]))
    else:
        print(f"phase {what}: torch.profiler saw no device time; device "
              f"breakdown not measured")
    return {"device_ms_a_step": device_ms / 3,
            "named_ms_a_step": named_ms / 3}


def _small_run(device: str, compressor: str, **kw) -> list:
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    small = TrainConfig(
        dnn="vgg16", batch_size=32, compressor=compressor, density=0.01,
        compress_warmup_steps=1, max_steps=3, lr=0.02,
        compute_dtype="float32", device=device,
        model_kwargs={"cfg": NARROW, "dropout": 0.0},
        output_dir=RUN_DIR, run_id=f"small_{compressor}_{device}", **kw)
    return [rec["loss"] for rec in _steps(Trainer(small))]


def _run_id(plan: str, how: str) -> str:
    return f"exchange_{plan.replace(' ', '_')}_{how}"


def _state_copy(trainer) -> dict:
    st = trainer.state
    return {"params": st.params.detach().clone(),
            "momentum": st.opt_state["m"].clone(),
            "EF row": st.ef_residual.clone(),
            "thresholds": st.comp_state.clone()}


def _config1_phase() -> None:
    """Phase 8a: BASELINE config 1 as shipped (resnet20, dense, bf16, batch
    128) for 5 steps; its first loss again from the same seed, bit for bit;
    and resnet20 in f32 at batch 8 for 2 steps on the card and on the CPU,
    whose losses must agree."""
    trainer = _config(CONFIG1, ["--max-steps", "5"], "config1")
    if (trainer.cfg.dnn, trainer.comp.name, trainer.cfg.compute_dtype,
            trainer.cfg.batch_size) != ("resnet20", "none", "bfloat16", 128):
        raise AssertionError(f"config 1 runs {trainer.cfg}")
    records, _, _ = _drive(trainer, "config1")
    if [rec["kind"] for rec in records] != ["dense"] * 5:
        raise AssertionError(f"config 1 step kinds {records}")
    del trainer
    again = _steps(_config(CONFIG1, ["--max-steps", "1"], "config1_repeat"))
    if again[0]["loss"] != records[0]["loss"]:
        raise AssertionError(f"config 1 from the same seed: first loss "
                             f"{again[0]['loss']} vs {records[0]['loss']}")
    small = ["--compute-dtype", "float32", "--batch-size", "8",
             "--max-steps", "2"]
    losses = {d: [rec["loss"] for rec in _steps(_config(
        CONFIG1, small + ["--device", d], f"config1_small_{d}"))]
        for d in ("cuda", "cpu")}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                 losses["cpu"])]
    if max(gaps) > 1e-3:
        raise AssertionError(f"resnet20 f32: card and CPU disagree: "
                             f"{losses}")
    print(f"phase config1: resnet20 dense bf16 batch 128, 5 steps, "
          f"{_step_ms(records)}; first loss repeated bit for bit from the "
          f"same seed; resnet20 f32 batch 8 losses on the card "
          f"{losses['cuda']} vs CPU {losses['cpu']} (max rel gap "
          f"{max(gaps):.2e} <= 1e-3)")


def _step_ms(records) -> str:
    return "step ms " + str([round(rec["step_ms"], 2) for rec in records])


def _config3_phases(mem_rate: float) -> dict:
    """Phases 8c-8e: BASELINE config 3 (ResNet-50, synthetic ImageNet-shaped
    uint8 data at 224^2, batch 64, bf16, density 0.001) at one worker, with
    ``gaussian_fused``, as shipped (``gaussian``) and with
    ``gaussian_pallas``; then B3 and B4 on the pallas run's EF row. Returns
    the launches and kernel times for the kernels line."""
    import torch
    from gaussiank_sgd_torch.compressors import decompress
    from gaussiank_sgd_torch.ops import fused_select as fs
    steps = ["--compress-warmup-steps", "2", "--max-steps"]
    out = {}
    # c. gaussian_fused, then the registry's flat compressor on the EF row
    torch.cuda.reset_peak_memory_stats()
    trainer = _config(CONFIG3, ["--compressor", "gaussian_fused", *steps,
                                "6"], "config3_fused")
    n, k = trainer.plan.total_numel, trainer.plan.total_k
    if ((n, k), trainer.ts.fused_ef, trainer.ts.wire_format) != (
            RESNET50[:2], (1, n, RESNET50[2]), "i32f32"):
        raise AssertionError(f"config 3: n, k {n, k}, layout "
                             f"{trainer.ts.fused_ef}, wire "
                             f"{trainer.ts.wire_format}")
    records, launches, (r, _) = _drive(
        trainer, "config3 fused", lambda: trainer.comp.fn(
            trainer.state.ef_residual[:n].contiguous(), k,
            trainer.state.comp_state[0, 0]))
    peak = torch.cuda.max_memory_allocated()
    sparse = [rec for rec in records if rec["kind"] == "sparse"]
    if [rec["kind"] for rec in records] != ["dense"] * 2 + ["sparse"] * 4:
        raise AssertionError(f"config 3 step kinds {records}")
    if launches["fused_ef_select"] != 4 or launches["fused_select"] < 1:
        raise AssertionError(f"config 3 fused: launches {launches}")
    out["bn"] = {"fused": _bn_launches(trainer, records, BNS["resnet50"],
                                       "config3 fused")}
    ratios = [rec["num_selected"] / rec["k"] for rec in sparse]
    if ratios[0] != 1.0:
        raise AssertionError(f"config 3: cold num_selected / k {ratios}")
    if any(rec["bytes_sent"] != k * 8 for rec in sparse):
        raise AssertionError(f"config 3 bytes_sent "
                             f"{[rec['bytes_sent'] for rec in sparse]}")
    acc = trainer.state.ef_residual[:n]
    if not torch.equal(decompress(r.compressed, n) + r.residual, acc):
        raise AssertionError("config 3 flat compressor: decompress + "
                             "residual != acc")
    del acc, r
    nsel = _ef_invariant(trainer, "config 3 fused sparse step")
    print(f"phase config3 fused: ResNet-50 n={n} k={k}, layout "
          f"{trainer.ts.fused_ef}, wire {trainer.ts.wire_format}, launches "
          f"{launches} (B1 in 4 sparse steps, B2 in the flat call), B5 "
          f"{out['bn']['fused']} in 6 steps and the MFU probe; "
          f"num_selected / k {[round(v, 4) for v in ratios]} (cold step = "
          f"k); bytes_sent {sparse[0]['bytes_sent']:.0f} ({k} x 8 B); EF "
          f"invariant exact on one more sparse step (num_selected {nsel}) "
          f"and on the flat call; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"{_step_ms(records)}")
    # B2 at the flat call's shape [1, n], on the run's EF row and warm
    # threshold
    x = trainer.state.ef_residual[:n].contiguous().view(1, n)
    t = trainer.state.comp_state[0, :1].contiguous()
    density = trainer.cfg.density
    out["b2_err"] = _same(fs.fused_select_candidates_chunked(x, t, density),
                          fs.fused_select_plain(x, t, density),
                          f"B2 [1, {n}]")
    print(f"phase B2 [1, {n}] on config 3's EF row: t={float(t[0]):.6g}, "
          f"bit-identical (vals, idx, counts)")
    nc = fs._chunk_geometry(n, density)[3]
    out["b2"] = _time_kernel(
        f"B2 [1, {n}]",
        lambda: fs.fused_select_candidates_chunked(x, t, density),
        lambda: fs.fused_select_plain(x, t, density),
        _bound_ms(n * 4 + nc * 8 + 8, _OPS_SELECT * n, mem_rate))
    del x, t
    out["profile"] = _profile(trainer, "config3 profile")
    out["fused"], out["peak"] = launches, peak
    del trainer
    torch.cuda.empty_cache()

    # d. config 3 as shipped: compressor gaussian, no kernel
    trainer = _config(CONFIG3, [*steps, "4"], "config3_shipped")
    if trainer.comp.name != "gaussian":
        raise AssertionError(f"config 3 runs {trainer.comp.name!r}")
    with _recorded_calls(trainer) as calls:
        records, _, _ = _drive(trainer, "config3 shipped")
        out["bn"]["shipped"] = _bn_launches(trainer, records,
                                            BNS["resnet50"],
                                            "config3 shipped")
        nsel = _ef_invariant(trainer, "config 3 gaussian")
    ratios = _within_5pct_of_k(records, "config 3 gaussian")
    replay = _replay_on_cpu(calls, trainer.cfg.density, "config 3 gaussian")
    print(f"phase config3 shipped: compressor gaussian, B5 "
          f"{out['bn']['shipped']} in 4 steps and the MFU probe, "
          f"num_selected / k "
          f"{[round(v, 4) for v in ratios]} (within 5%); EF invariant exact "
          f"on one more step (num_selected {nsel}); each call (2 sparse "
          f"steps and that one) equal to the CPU's from the card's t0: "
          + "; ".join(replay) + f"; {_step_ms(records)}")
    del trainer, calls
    torch.cuda.empty_cache()

    # e. gaussian_pallas: B3 once and B4 twice a sparse step
    trainer = _config(CONFIG3, ["--compressor", "gaussian_pallas", *steps,
                                "6"], "config3_pallas")
    records, launches, _ = _drive(trainer, "config3 pallas")
    want = {"fused_stats": 4, "multi_threshold_counts": 8,
            "fused_ef_select": 0, "fused_select": 0}
    if launches != want:
        raise AssertionError(f"config 3 gaussian_pallas launches "
                             f"{launches}, want {want} in 4 sparse steps")
    out["bn"]["pallas"] = _bn_launches(trainer, records,
                                       BNS["resnet50"], "config3 pallas")
    ratios = _within_5pct_of_k(records, "config 3 gaussian_pallas")
    nsel = _ef_invariant(trainer, "config 3 unfused sparse step")
    print(f"phase config3 pallas: launches {launches} in 4 sparse steps, "
          f"B5 {out['bn']['pallas']} in 6 and the MFU probe; "
          f"num_selected / k {[round(v, 4) for v in ratios]}; EF invariant "
          f"exact on one more sparse step (num_selected {nsel}); "
          f"{_step_ms(records)}")
    out["pallas"] = launches
    out["b3"], out["b4"], out["b3_err"], out["b4_err"] = _b3_b4_phase(
        trainer.state.ef_residual.contiguous(), k, mem_rate)
    del trainer
    torch.cuda.empty_cache()
    return out


def _events(trainer) -> list:
    """The ``{"event": ...}`` lines of a run's metrics file."""
    with open(trainer.metrics_path) as f:
        return [rec for rec in map(json.loads, f) if "event" in rec]


def _fit_phase(tmp: str) -> dict:
    """Phase 9a-b: config 3 through ``Trainer.fit()`` for 20 steps (16 an
    epoch), with an eval pass and a checkpoint every epoch, then a fresh
    trainer resumed from step 16 for steps 17-20, which must repeat the
    uninterrupted run bit for bit. Returns B1's launches on each run."""
    import torch
    from gaussiank_sgd_torch.training import checkpoint as ck
    argv = ["--compressor", "gaussian_fused", "--compress-warmup-steps", "2",
            "--max-steps", "20", "--eval-every-epochs", "1",
            "--save-every-epochs", "1"]
    trainer = _config(CONFIG3, argv, "fit", tmp)
    if (trainer.steps_per_epoch, trainer.eval_batch_size,
            trainer.ts.fused_ef) != (16, 64, (1, *RESNET50[::2])):
        raise AssertionError(f"config 3 fit: {trainer.steps_per_epoch} "
                             f"steps an epoch, eval batch "
                             f"{trainer.eval_batch_size}, layout "
                             f"{trainer.ts.fused_ef}")
    _reset_launches()
    trainer.fit()
    records = trainer.records
    torch.cuda.synchronize()
    launches = _launches()
    kinds = [rec["kind"] for rec in records]
    if kinds != ["dense"] * 2 + ["sparse"] * 18:
        raise AssertionError(f"config 3 fit: step kinds {kinds}")
    if launches["fused_ef_select"] != 18:
        raise AssertionError(f"config 3 fit: launches {launches} in 18 "
                             f"sparse steps")
    if not all(math.isfinite(rec["loss"]) for rec in records):
        raise AssertionError(f"config 3 fit: losses {records}")
    events = _events(trainer)
    evals = [e for e in events if e["event"] == "eval"]
    saves = [e for e in events if e["event"] == "checkpoint"]
    if ([(e["step"], e["epoch"], e["n"]) for e in evals]
            != [(16, 1, 1024.0), (20, 1, 1024.0)]
            or not all(math.isfinite(e["val_loss"])
                       and 0 <= e["top1"] <= e["top5"] <= 1 for e in evals)):
        raise AssertionError(f"config 3 fit: eval lines {evals}")
    sealed = [step for step, _ in ck.list_checkpoints(trainer.ckpt_dir)]
    if sealed != [16, 20] or [e["step"] for e in saves] != [16, 20]:
        raise AssertionError(f"config 3 fit: sealed {sealed}, saves {saves}")
    want = _state_copy(trainer)
    want["stats"] = trainer.model.stats.clone()
    del trainer
    torch.cuda.empty_cache()
    for e in evals:
        print(f"phase fit eval step {e['step']} epoch {e['epoch']}: "
              f"val_loss {e['val_loss']:.4f} top1 {e['top1']:.4f} top5 "
              f"{e['top5']:.4f} over {e['n']:.0f} images, "
              f"{e['eval_ms']:.1f} ms wall, "
              f"{e['n'] / e['eval_ms'] * 1e3:.0f} images/s")
    for e in saves:
        print(f"phase fit checkpoint step {e['step']}: {e['bytes']} bytes, "
              f"save {e['save_ms']:.1f} ms wall")
    print(f"phase fit: config 3 (ResNet-50, gaussian_fused) through "
          f"Trainer.fit(), 2 dense + 18 sparse steps, B1 "
          f"{launches['fused_ef_select']} launches; eval lines at steps 16 "
          f"and 20 (both epoch 1, as the reference's loop counts an epoch "
          f"cut by max_steps); sealed checkpoints {sealed}; "
          f"{_step_ms(records)}")

    resume = os.path.join(tmp, "fit", "ckpt", "step_00000016")
    _reset_launches()
    again = _config(CONFIG3, argv + ["--resume", resume], "resumed", tmp)
    if again.state.step != 16:
        raise AssertionError(f"resumed at step {again.state.step}")
    again.fit()
    later = again.records
    torch.cuda.synchronize()
    launches_resumed = _launches()
    if ([(rec["step"], rec["loss"]) for rec in later]
            != [(rec["step"], rec["loss"]) for rec in records[16:]]):
        raise AssertionError(f"resumed losses {later} vs {records[16:]}")
    got = _state_copy(again)
    got["stats"] = again.model.stats.clone()
    for key, t in got.items():
        if not torch.equal(_bits(t), _bits(want[key])):
            raise AssertionError(f"resumed run: {key} differs at step 20")
    n = again.plan.total_numel
    if again.state.ef_residual[n:].any():
        raise AssertionError("resumed run: the EF row's pad is not zero")
    if launches_resumed["fused_ef_select"] != 4:
        raise AssertionError(f"resumed run: launches {launches_resumed}")
    (restore,) = [e for e in _events(again) if e["event"] == "restore"]
    print(f"phase resume: a fresh trainer from {os.path.basename(resume)} "
          f"({restore['restore_ms']:.1f} ms wall to restore) ran steps "
          f"17-20: losses {[round(rec['loss'], 6) for rec in later]} equal "
          f"to the uninterrupted run's, and at step 20 params, momentum, "
          f"EF row (pad zero), thresholds and BatchNorm statistics "
          f"bit-identical; B1 {launches_resumed['fused_ef_select']} "
          f"launches")
    del again, want, got
    torch.cuda.empty_cache()
    return {"fit": launches["fused_ef_select"],
            "resume": launches_resumed["fused_ef_select"]}


def _microbatch_phase(peak_one: int) -> int:
    """Phase 9c: config 3 with ``--nsteps-update 2 --clip-norm 1.0``, 2
    dense + 2 sparse steps of 128 rows (two microbatches of 64): every
    step's post-clip gradient norm within 1.0 x (1 + 1e-6), the EF
    invariant exact on one more sparse step, and the peak memory beside
    the one-microbatch run's. Returns B1's launches."""
    import torch
    from gaussiank_sgd_torch.parallel import trainstep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = _config(CONFIG3, ["--compressor", "gaussian_fused",
                                "--compress-warmup-steps", "2",
                                "--max-steps", "4", "--nsteps-update", "2",
                                "--clip-norm", "1.0"], "config3_micro")
    ts = trainer.ts
    if (trainer.train_ds.batch_size, ts.num_microbatches,
            ts.clip_norm) != (128, 2, 1.0):
        raise AssertionError(f"microbatch run: batch "
                             f"{trainer.train_ds.batch_size}, "
                             f"{ts.num_microbatches} microbatches, clip "
                             f"{ts.clip_norm}")
    clip, norms = trainstep._clip_by_global_norm, []

    def recorded(flat_g, c):
        out = clip(flat_g, c)
        norms.append(tuple(float(torch.linalg.vector_norm(
            v, dtype=torch.float64)) for v in (flat_g, out)))
        return out

    trainstep._clip_by_global_norm = recorded
    try:
        records, launches, _ = _drive(trainer, "config3 microbatch")
        peak = torch.cuda.max_memory_allocated()
        nsel = _ef_invariant(trainer, "config 3 microbatched sparse step")
    finally:
        trainstep._clip_by_global_norm = clip
    if [rec["kind"] for rec in records] != ["dense"] * 2 + ["sparse"] * 2:
        raise AssertionError(f"microbatch run: step kinds {records}")
    if launches["fused_ef_select"] != 2:
        raise AssertionError(f"microbatch run: launches {launches}")
    # 4 steps and the invariant's, and on a card whose peak MFU knows, the
    # trainer's one MFU probe (a forward and backward, clipped too)
    from gaussiank_sgd_torch.benchlib import device_peak_flops
    want_norms = 5 + (device_peak_flops() is not None)
    if len(norms) != want_norms or any(after > 1.0 * (1 + 1e-6)
                                       for _, after in norms):
        raise AssertionError(f"microbatch run: (pre, post)-clip norms "
                             f"{norms}")
    print(f"phase microbatch: config 3 with --nsteps-update 2 --clip-norm "
          f"1.0, 128 rows a step in two microbatches of 64, 2 dense + 2 "
          f"sparse steps and one more for the EF invariant (exact, "
          f"num_selected {nsel}); gradient norms before and after the clip "
          f"{[(round(a, 4), round(b, 7)) for a, b in norms]} (after <= 1.0 "
          f"x (1 + 1e-6)); B1 {launches['fused_ef_select']} launches; peak "
          f"memory {peak / 2 ** 30:.2f} GiB against "
          f"{peak_one / 2 ** 30:.2f} GiB at one microbatch of 64 (phase 8c) "
          f"({peak / peak_one - 1:+.1%}); {_step_ms(records)}")
    del trainer, ts
    torch.cuda.empty_cache()
    return launches["fused_ef_select"]


def _eval_card_vs_cpu_phase() -> None:
    """Phase 9d: config 1 (resnet20) in f32 after 2 dense steps on the
    card; the same state evaluated on the card and on the CPU over 4 test
    batches (512 images): top1 and top5 equal, val_loss within 1e-4."""
    import torch
    flags = ["--compute-dtype", "float32", "--max-steps", "2",
             "--eval-max-batches", "4"]
    card = _config(CONFIG1, flags, "eval_card")
    _steps(card)
    cpu = _config(CONFIG1, flags + ["--device", "cpu"], "eval_cpu")
    with torch.no_grad():
        cpu.model.flat.copy_(card.model.flat.cpu())
        cpu.model.stats.copy_(card.model.stats.cpu())
    outs = {"card": card.test(), "cpu": cpu.test()}
    (n,) = {[e for e in _events(t) if e["event"] == "eval"][-1]["n"]
            for t in (card, cpu)}
    if n != 512 or any(outs["card"][key] != outs["cpu"][key]
                       for key in ("top1", "top5")):
        raise AssertionError(f"eval card vs CPU over {n} images: {outs}")
    gap = abs(outs["card"]["val_loss"] / outs["cpu"]["val_loss"] - 1)
    if gap > 1e-4:
        raise AssertionError(f"eval card vs CPU: val_loss {outs}")
    print(f"phase eval card vs CPU: resnet20 f32 after 2 steps, {n:.0f} "
          f"test images: top1 {outs['card']['top1']:.4f} top5 "
          f"{outs['card']['top5']:.4f} on both; val_loss "
          f"{outs['card']['val_loss']:.6f} vs {outs['cpu']['val_loss']:.6f}"
          f" (rel gap {gap:.2e} <= 1e-4)")


def _recorded_fused(trainer):
    """Each call of the trainer's fused EF compressor as its inputs (EF
    row, gradient, scale, k, thresholds) and outputs (indices, values,
    num_selected, residual, next thresholds) for
    ``_replay_fused_on_cpu``."""
    return _spec_recorded(trainer, "fused_ef_fn", lambda args, out: args + (
        out[0].compressed.indices, out[0].compressed.values,
        out[0].num_selected, out[0].residual, out[1]))


def _replay_fused_on_cpu(calls, density: float, what: str) -> list:
    """Each recorded call of the fused EF compressor replayed on the CPU
    from the card's inputs (B1's plain version, then the same host tail):
    num_selected, indices, values and the new EF row must equal the card's
    bit for bit, the next threshold within 1e-6 (its power is taken in f64
    on each device). Returns num_selected / k of each call."""
    import torch
    from gaussiank_sgd_torch.ops import fused_select as fs
    out = []
    for i, (res, g, scale, k, st, idx, val, nsel, resid, st_new) in (
            enumerate(calls)):
        r, t = fs.gaussian_fused_ef_compress_batched(
            res.cpu(), g.cpu(), scale, k, st.cpu(), density=density)
        if not _equal_bits(
                (r.num_selected, nsel), (r.compressed.indices, idx),
                (r.compressed.values, val), (r.residual, resid)) or not (
                torch.allclose(t, st_new.cpu(), rtol=1e-6, atol=0)):
            raise AssertionError(f"{what} call {i}: the CPU's replay "
                                 f"differs from the card")
        out.append(round(int(nsel.sum()) / k, 4))
    return out


def _recorded_counts():
    """Each launch of kernel B4's wrapper as ``(input, thresholds,
    counts)`` for ``_replay_pallas_on_cpu``."""
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops
    return _recorded(ts_ops.multi_threshold_counts,
                     lambda fn: setattr(ts_ops, "multi_threshold_counts", fn),
                     lambda args, out: args + (out,))


def _replay_pallas_on_cpu(count_calls, calls, what: str) -> list:
    """``gaussian_pallas`` on the CPU from the card's inputs: every B4
    count of the run equal to the plain version's on the same input and
    thresholds, and each compressor call's threshold (the linear candidate
    whose count is nearest k, from the card's thresholds and counts) giving
    the card's num_selected, indices and values on the CPU. Returns
    num_selected / k of each call."""
    import torch
    from gaussiank_sgd_torch.compressors.base import pack_by_threshold
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops
    if len(count_calls) != 2 * len(calls):
        raise AssertionError(f"{what}: {len(count_calls)} B4 launches for "
                             f"{len(calls)} compressor calls")
    for j, (flat, thr, counts) in enumerate(count_calls):
        cpu = ts_ops.multi_threshold_counts_plain(flat.cpu(), thr.cpu())
        if not _equal_bits((cpu, counts)):
            raise AssertionError(f"{what}: B4 launch {j} counts "
                                 f"{counts.tolist()}, the CPU's "
                                 f"{cpu.tolist()}")
    out = []
    for i, (acc, k, _, idx, val, nsel) in enumerate(calls):
        _, lin, c2 = count_calls[2 * i + 1]
        t = lin.cpu()[torch.argmin((c2.cpu() - float(k)).abs())]
        r = pack_by_threshold(acc.cpu(), t, k)
        if int(r.num_selected) != int(nsel) or not _equal_bits(
                (r.compressed.indices, idx), (r.compressed.values, val)):
            raise AssertionError(f"{what} call {i}: the card selected "
                                 f"{int(nsel)}, the CPU {int(r.num_selected)}"
                                 f" at the card's threshold, or the packs "
                                 f"differ")
        out.append(round(int(nsel) / k, 4))
    return out


def _grad_rows(trainer):
    """The run's EF row and one more step's flat gradient (not committed)
    as the fused kernel's ``[1, chunk_pad]`` rows."""
    ts, state = trainer.ts, trainer.state
    grads = ts.local_grads(state, trainer.next_batch())
    state.model_state["stats"].copy_(grads.model_state_before["stats"])
    return (state.ef_residual.view(1, -1).clone(),
            grads.flat_g.view(1, -1).clone())


def _b2_rows(x, t, density: float, mem_rate: float, what: str):
    """B2 at ``x`` ``[1, n]`` with threshold ``t``, bit for bit against its
    plain version, then timed beside its bound: ``(times, error)``."""
    from gaussiank_sgd_torch.ops import fused_select as fs
    n = x.shape[1]
    err = _same(fs.fused_select_candidates_chunked(x, t, density),
                fs.fused_select_plain(x, t, density), f"B2 [1, {n}]")
    print(f"phase B2 [1, {n}] {what}: t={float(t[0]):.6g}, bit-identical "
          f"(vals, idx, counts)")
    nc = fs._chunk_geometry(n, density)[3]
    return _time_kernel(
        f"B2 [1, {n}] {what}",
        lambda: fs.fused_select_candidates_chunked(x, t, density),
        lambda: fs.fused_select_plain(x, t, density),
        _bound_ms(n * 4 + nc * 8 + 8, _OPS_SELECT * n, mem_rate)), err


def _check_widths(trainer, want: dict, what: str) -> None:
    """The run's configuration and model at the config's full width."""
    got = {key: fn(trainer) for key, fn in _WIDTHS.items() if key in want}
    if got != want:
        raise AssertionError(f"{what}: {got}, want {want}")


# what each width key reads off a trainer (only the keys a check names)
_WIDTHS = {
    "dnn": lambda t: t.cfg.dnn, "vocab": lambda t: t.spec.num_classes,
    "embed": lambda t: t.model.leaves()["Embed_0/embedding"].shape[1],
    "hidden": lambda t: t.model.hidden_dim,
    "layers": lambda t: t.model.num_layers,
    "bptt": lambda t: t.train_ds.bptt,
    "dim": lambda t: t.model.dim,
    "enc_dec": lambda t: (t.model.enc_layers, t.model.dec_layers),
    "heads": lambda t: t.model.heads,
    "ffn": lambda t: t.model.leaves()[
        "enc_0/MLP_0/Dense_0/kernel"].shape[-1],
    "seq": lambda t: t.spec.input_shape[0],
    "batch": lambda t: t.cfg.batch_size,
    "dtype": lambda t: t.cfg.compute_dtype,
    "density": lambda t: t.cfg.density,
    "compressor": lambda t: t.comp.name,
    "clip": lambda t: t.cfg.clip_norm,
    "smoothing": lambda t: t.cfg.label_smoothing,
    "recurrent": lambda t: t.recurrent,
    "n_k": lambda t: (t.plan.total_numel, t.plan.total_k),
}


def _config4_phases(mem_rate: float) -> dict:
    """Phase 10: BASELINE config 4 (2-layer LSTM / PTB-shaped synthetic
    tokens, GaussianK at density 0.01, the carry on) at one worker.
    Returns the launches and kernel times for the kernels line."""
    import torch
    from gaussiank_sgd_torch.ops import fused_select as fs
    from gaussiank_sgd_torch.training.losses import _ce
    width = {"dnn": "lstm", "vocab": 10_000, "embed": 650, "hidden": 650,
             "layers": 2, "bptt": 35, "batch": 20, "dtype": "float32",
             "density": 0.01, "clip": 0.25, "recurrent": True,
             "n_k": LSTM[:2]}
    out = {}
    # a. gaussian_fused: B1 once a sparse step, every call replayed on the
    # CPU; then the registry's flat call on the EF row (B2)
    trainer = _config(CONFIG4, ["--compressor", "gaussian_fused",
                                *WARMUP_2, "6"], "config4_fused")
    _check_widths(trainer, {**width, "compressor": "gaussian_fused"},
                  "config 4")
    n, k = LSTM[:2]
    if (trainer.ts.fused_ef != (1, n, LSTM[2])
            or fs.segment_span(trainer.cfg.density) != 32
            or trainer.steps_per_epoch != 285):
        raise AssertionError(f"config 4: layout {trainer.ts.fused_ef}, "
                             f"{trainer.steps_per_epoch} steps an epoch")
    with _recorded_fused(trainer) as calls:
        records, launches, (r, _) = _drive(
            trainer, "config4 fused", lambda: trainer.comp.fn(
                trainer.state.ef_residual[:n].contiguous(), k,
                trainer.state.comp_state[0, 0]))
    if [rec["kind"] for rec in records] != ["dense"] * 2 + ["sparse"] * 4:
        raise AssertionError(f"config 4 step kinds {records}")
    if (launches["fused_ef_select"] != 4 or launches["fused_select"] < 1
            or launches["fused_stats"] or launches["multi_threshold_counts"]):
        raise AssertionError(f"config 4 fused: launches {launches}")
    ratios = [round(rec["num_selected"] / rec["k"], 4) for rec in records
              if rec["kind"] == "sparse"]
    replay = _replay_fused_on_cpu(calls, trainer.cfg.density,
                                  "config 4 fused")
    del calls, r
    nsel = _ef_invariant(trainer, "config 4 fused sparse step")
    # the carry: the next window in eval mode from the carried state and
    # from zeros
    x, y = trainer.next_batch()
    carry = trainer.state.carry
    m = trainer.model
    if tuple(carry.shape) != (m.num_layers, 2, 20, m.hidden_dim) or not bool(
            carry.isfinite().all()) or not bool(carry.any()):
        raise AssertionError(f"config 4 carry {tuple(carry.shape)}")
    with torch.no_grad():
        fed = [float(_ce(trainer.model(x, train=False, carry=c)[0],
                         y).mean()) for c in (carry, torch.zeros_like(carry))]
    if fed[0] == fed[1]:
        raise AssertionError(f"config 4: the carry changes nothing: {fed}")
    flat_g = trainer.ts.local_grads(trainer.state, (x, y)).flat_g
    off = dict(_offsets(m))["Embed_0/embedding"]
    size = m.leaves()["Embed_0/embedding"].numel()
    zero_share = float((flat_g[off:off + size] == 0).float().mean())
    del flat_g
    print(f"phase config4 fused: LSTM n={n} k={k} (density 0.01, SEG 32), "
          f"layout {trainer.ts.fused_ef}, launches {launches} (B1 in 4 "
          f"sparse steps, B2 in the flat call); num_selected / k a sparse "
          f"step {ratios}; each call equal to the CPU's replay from the "
          f"card's inputs ({replay}); EF invariant exact on one more sparse "
          f"step (num_selected {nsel}); carry {list(carry.shape)}, the next "
          f"window's eval loss {fed[0]:.6f} from the carried state vs "
          f"{fed[1]:.6f} from zeros; the embedding's gradient "
          f"{zero_share:.2%} exact zeros; {_step_ms(records)}")
    out["fused"] = launches
    out["profile"] = _profile(trainer, "config4 profile")
    # b. B1 at config 4's padded EF row, on the run's row and a real
    # gradient; then B2 on the accumulator at the flat call's shape
    res, g = _grad_rows(trainer)
    out["b1"], out["b1_err"], _, _, warm = _b1_rows(
        res, g, n, trainer.cfg.density, mem_rate, " config 4")
    x = (res + g)[:, :n].contiguous()
    del res, g
    out["b2"], out["b2_err"] = _b2_rows(x, warm, trainer.cfg.density,
                                        mem_rate, "config 4 acc")
    del x
    # e. an eval pass over the validation stream, from a zero carry
    ev = trainer.test()
    if not math.isfinite(ev["perplexity"]) or ev["perplexity"] <= 1.0:
        raise AssertionError(f"config 4 eval: {ev}")
    print(f"phase config4 eval: {trainer.eval_batch_size} rows x 35 "
          f"tokens a window, val_loss {ev['val_loss']:.4f}, perplexity "
          f"{ev['perplexity']:.2f} (finite; exp(min(val_loss, 30)))")
    del trainer
    torch.cuda.empty_cache()

    # c. gaussian_pallas: B3 once and B4 twice a sparse step, every count
    # replayed on the CPU; then B3 and B4 timed on the run's EF row
    trainer = _config(CONFIG4, ["--compressor", "gaussian_pallas",
                                *WARMUP_2, "6"], "config4_pallas")
    with _recorded_calls(trainer) as calls, _recorded_counts() as counts:
        records, launches, _ = _drive(trainer, "config4 pallas")
    want = {"fused_stats": 4, "multi_threshold_counts": 8,
            "fused_ef_select": 0, "fused_select": 0}
    if launches != want:
        raise AssertionError(f"config 4 gaussian_pallas launches "
                             f"{launches}, want {want} in 4 sparse steps")
    replay = _replay_pallas_on_cpu(counts, calls, "config 4 pallas")
    del calls, counts
    nsel = _ef_invariant(trainer, "config 4 unfused sparse step")
    print(f"phase config4 pallas: launches {launches} in 4 sparse steps; "
          f"num_selected / k {replay}, each B4 count and each selection "
          f"equal to the CPU's from the card's inputs; EF invariant exact "
          f"on one more step (num_selected {nsel}); {_step_ms(records)}")
    out["pallas"] = launches
    out["b3"], out["b4"], out["b3_err"], out["b4_err"] = _b3_b4_phase(
        trainer.state.ef_residual.contiguous(), k, mem_rate)
    del trainer
    torch.cuda.empty_cache()

    # d. config 4 as shipped: compressor gaussian, no kernel
    trainer = _config(CONFIG4, [*WARMUP_2, "4"], "config4_shipped")
    _check_widths(trainer, {"compressor": "gaussian"}, "config 4 shipped")
    with _recorded_calls(trainer) as calls:
        records, _, _ = _drive(trainer, "config4 shipped")
    replay = _replay_on_cpu(calls, trainer.cfg.density, "config 4 gaussian")
    print(f"phase config4 shipped: compressor gaussian, 2 sparse steps, "
          f"num_selected / k of each call equal to the CPU's from the "
          f"card's t0: " + "; ".join(replay) + f"; {_step_ms(records)}")
    del trainer, calls
    torch.cuda.empty_cache()

    # f. a narrow LSTM in f32 (dropout off), the same 3 steps on the card
    # and on the CPU
    narrow = ["--model-kwargs", json.dumps({"embed_dim": 32,
                                            "hidden_dim": 32,
                                            "dropout": 0.0}),
              "--compressor", "gaussian_fused", "--lr", "1.0",
              "--compress-warmup-steps", "1", "--max-steps", "3"]
    losses = {name: [rec["loss"] for rec in _steps(_config(
        CONFIG4, narrow + ["--device", d], f"config4_small_{name}"))]
        for name, d in DEVICES.items()}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                 losses["cpu"])]
    if max(gaps) > 1e-5:
        raise AssertionError(f"narrow LSTM: card and CPU disagree: "
                             f"{losses}")
    print(f"phase config4 small: narrow LSTM (32 wide) f32 losses on the "
          f"card {losses['card']} vs CPU {losses['cpu']} (max rel gap "
          f"{max(gaps):.2e} <= 1e-5)")
    return out


def _offsets(model):
    """``(path, offset)`` of every leaf in the flat parameter."""
    off = 0
    for path, shape in model.param_layout:
        yield path, off
        off += math.prod(shape)


def _config5_phases(mem_rate: float) -> dict:
    """Phase 11: BASELINE config 5 (Transformer-base / WMT-shaped
    synthetic copy-reverse pairs, RandomKEC at density 0.001, label
    smoothing 0.1) at one worker, and its GaussianK comparison arm. Returns
    the launches and kernel times for the kernels line."""
    import torch
    from gaussiank_sgd_torch.compressors import decompress
    from gaussiank_sgd_torch.compressors.randomk import (comp_generator,
                                                         random_indices)
    from gaussiank_sgd_torch.models import get_model
    width = {"dnn": "transformer", "vocab": 32_000, "dim": 512,
             "enc_dec": (6, 6), "heads": 8, "ffn": 2048, "seq": 64,
             "batch": 32, "dtype": "bfloat16", "density": 0.001,
             "clip": 1.0, "smoothing": 0.1, "n_k": TRANSFORMER[:2]}
    n, k = TRANSFORMER[:2]
    out = {}
    # a. randomkec as shipped
    trainer = _config(CONFIG5, WARMUP_2 + ["6"], "config5_randomkec")
    _check_widths(trainer, {**width, "compressor": "randomkec"}, "config 5")
    if trainer.train_ds.x.shape[1:] != (64,) or trainer.ts.wire_format != (
            "i32f32"):
        raise AssertionError(f"config 5: src {trainer.train_ds.x.shape}, "
                             f"wire {trainer.ts.wire_format}")
    with _recorded_calls(trainer) as calls:
        records, launches, _ = _drive(trainer, "config5 randomkec")
    sparse = [rec for rec in records if rec["kind"] == "sparse"]
    if [rec["kind"] for rec in records] != ["dense"] * 2 + ["sparse"] * 4:
        raise AssertionError(f"config 5 step kinds {records}")
    if any(rec["num_selected"] != k or rec["bytes_sent"] != k * 8
           for rec in sparse) or any(launches.values()):
        raise AssertionError(f"config 5 randomkec: {sparse}, {launches}")
    sets = [set(c[3].tolist()) for c in calls]
    if len(sets) != 4 or any(len(st) != k for st in sets) or any(
            a == b for a, b in zip(sets, sets[1:])):
        raise AssertionError("config 5: the steps' index sets are not k "
                             "distinct indices, or two steps drew the same")
    overlap = len(sets[0] & sets[1])
    for acc, _, _, idx, val, _ in calls:
        if not torch.equal(_bits(val), _bits(acc[idx.long()])):
            raise AssertionError("config 5: sent values are not acc[idx]")
    del calls
    nsel = _ef_invariant(trainer, "config 5 randomkec sparse step")
    dev = trainer.state.params.device
    seed, step = trainer.cfg.seed, trainer.state.step
    draws = {name: random_indices(n, k, comp_generator(seed, step, 0, dev,
                                                       r))
             for name, r in (("shared a", None), ("shared b", None),
                             ("rank 0", 0), ("rank 1", 1))}
    if not torch.equal(draws["shared a"], draws["shared b"]) or any(
            torch.equal(draws[a], draws[b]) for a, b in (
                ("shared a", "rank 0"), ("rank 0", "rank 1"))):
        raise AssertionError("config 5: the compressor stream's draws")
    print(f"phase config5 randomkec: Transformer-base n={n} k={k}, wire "
          f"{trainer.ts.wire_format}, no kernel launched ({launches}); "
          f"num_selected = k and bytes_sent = {k} x 8 B on every sparse "
          f"step; the 4 steps' index sets distinct ({overlap} indices "
          f"shared by steps 3 and 4); EF invariant exact on one more step "
          f"(num_selected {nsel}); two generators seeded alike drew the "
          f"same {k} indices on the card, ranks 0 and 1 under "
          f"decorrelate_comp_rng drew others; {_step_ms(records)}")
    out["randomkec_profile"] = _profile(trainer, "config5 profile",
                                        ("aten::random_", "aten::topk"))
    # c. an eval pass: masked token top1 and the loss
    ev = trainer.test()
    if not (math.isfinite(ev["val_loss"]) and 0.0 <= ev["top1"] <= 1.0):
        raise AssertionError(f"config 5 eval: {ev}")
    print(f"phase config5 eval: {trainer.eval_batch_size} pairs a batch, "
          f"val_loss {ev['val_loss']:.4f}, masked token top1 "
          f"{ev['top1']:.4f} (in [0, 1])")
    del trainer
    torch.cuda.empty_cache()

    # b. the comparison arm: gaussian, through gaussian_fused (B1)
    trainer = _config(CONFIG5, ["--compressor", "gaussian_fused",
                                *WARMUP_2, "6"], "config5_fused")
    if trainer.ts.fused_ef != (1, n, TRANSFORMER[2]):
        raise AssertionError(f"config 5 fused: {trainer.ts.fused_ef}")
    records, launches, (r, _) = _drive(
        trainer, "config5 fused", lambda: trainer.comp.fn(
            trainer.state.ef_residual[:n].contiguous(), k,
            trainer.state.comp_state[0, 0]))
    if (launches["fused_ef_select"] != 4 or launches["fused_select"] < 1
            or launches["fused_stats"] or launches["multi_threshold_counts"]):
        raise AssertionError(f"config 5 fused: launches {launches}")
    acc = trainer.state.ef_residual[:n]
    if not torch.equal(decompress(r.compressed, n) + r.residual, acc):
        raise AssertionError("config 5 flat compressor: decompress + "
                             "residual != acc")
    del acc, r
    ratios = [round(rec["num_selected"] / rec["k"], 4) for rec in records
              if rec["kind"] == "sparse"]
    nsel = _ef_invariant(trainer, "config 5 fused sparse step")
    print(f"phase config5 fused: layout {trainer.ts.fused_ef}, launches "
          f"{launches} (B1 in 4 sparse steps, B2 in the flat call); "
          f"num_selected / k {ratios}; EF invariant exact on one more step "
          f"(num_selected {nsel}); {_step_ms(records)}")
    out["fused"] = launches
    out["fused_profile"] = _profile(trainer, "config5 fused profile")
    res, g = _grad_rows(trainer)
    out["b1"], out["b1_err"], _, _, warm = _b1_rows(
        res, g, n, trainer.cfg.density, mem_rate, " config 5")
    x = (res + g)[:, :n].contiguous()
    del res, g
    out["b2"], out["b2_err"] = _b2_rows(x, warm, trainer.cfg.density,
                                        mem_rate, "config 5 acc")
    del x, trainer
    torch.cuda.empty_cache()

    # d. a narrow transformer in f32: logits on the card and on the CPU
    kw = dict(dim=64, heads=4, enc_layers=2, dec_layers=2, ffn=128,
              vocab_size=1000, dtype=torch.float32, seed=3)
    rng = torch.Generator().manual_seed(4)
    src = torch.randint(1, 1000, (4, 64), generator=rng)
    tgt = torch.randint(1, 1000, (4, 64), generator=rng)
    src[:, 50:] = 0                                  # padded tails
    tgt[:, 40:] = 0
    logits = {}
    for name, d in DEVICES.items():
        m = get_model("transformer", device=d, **kw).module
        with torch.no_grad():
            logits[name] = m(src.to(d), tgt.to(d), train=False).cpu()
    gap = float((logits["card"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    if not gap <= 1e-4 * scale:
        raise AssertionError(f"narrow transformer: logits gap {gap}")
    print(f"phase config5 small: narrow transformer (64 wide, 2 + 2 "
          f"layers) f32 eval logits [4, 64, 1000] on the card vs the CPU: "
          f"max gap {gap:.3g} <= 1e-4 x max|logit| ({scale:.4g})")
    return out


# ------------------------------------------------- phase 12: the arms

# the comparison arms phase 12b runs on config 2
ARMS = ("approxtopk", "approxtopk16", "dgcsampling", "redsync",
        "redsynctrim")


@contextlib.contextmanager
def _noting_samples(trainer):
    """Install a wrapper of a drawing compressor (DGC) that first draws,
    from a copy of its generator's state, the sample the call is about to
    draw, so a replay starts from the card's own sample indices. Yields
    the list of samples, one a call."""
    import torch
    from gaussiank_sgd_torch.compressors.sampling import dgc_sample
    ts, spec = trainer.ts, trainer.ts.spec
    samples = []

    def fn(acc, k, gen):
        twin = torch.Generator(device=gen.device)
        twin.set_state(gen.get_state())
        samples.append(dgc_sample(acc.shape[0], k, twin))
        return spec.fn(acc, k, gen)

    ts.spec = spec._replace(fn=fn)
    try:
        yield samples
    finally:
        ts.spec = spec


def _replay_arm_on_cpu(calls, samples, spec, density: float,
                       what: str) -> None:
    """Each recorded call of a comparison arm replayed on the CPU from the
    card's accumulator (DGC from the card's own sample): indices, values
    and num_selected must equal the card's."""
    from gaussiank_sgd_torch.compressors.sampling import dgc_compress_at
    for i, (acc, k, _, idx, val, nsel) in enumerate(calls):
        a = acc.cpu()
        r = (dgc_compress_at(a, samples[i].cpu(), k, density)
             if spec.requires_rng else spec.fn(a, k))
        if not _equal_bits((r.compressed.indices, idx),
                           (r.compressed.values, val),
                           (r.num_selected, nsel)):
            raise AssertionError(f"{what} call {i}: the CPU's replay "
                                 f"differs from the card's selection")


def _topk_arm_phase(gaussian: dict) -> dict:
    """Phase 12a: config 3's TopK arm (``--compressor topk``) for 2 dense +
    4 sparse steps: no kernel, num_selected = k and bytes_sent = k x 8 B on
    every sparse step, the EF invariant of one more step, every call equal
    to the CPU's replay from the card's accumulator; then 3 sparse steps
    under ``torch.profiler`` beside phase 8c's ``gaussian_fused`` step.
    Returns the launches, the profile, and the run's EF row for the
    timings of 12d."""
    import torch
    n, k = RESNET50[:2]
    torch.cuda.reset_peak_memory_stats()
    trainer = _config(CONFIG3, ["--compressor", "topk", *WARMUP_2, "6"],
                      "config3_topk")
    ts = trainer.ts
    got = (trainer.comp.name, trainer.plan.total_numel, trainer.plan.total_k,
           ts.fused_ef, ts.wire_format, ts.ef_numel)
    if got != ("topk", n, k, None, "i32f32", n):
        raise AssertionError(f"config 3 topk: {got}")
    with _recorded_calls(trainer) as calls:
        records, launches, _ = _drive(trainer, "config3 topk")
        nsel = _ef_invariant(trainer, "config 3 topk")
    peak = torch.cuda.max_memory_allocated()
    sparse = [rec for rec in records if rec["kind"] == "sparse"]
    if [rec["kind"] for rec in records] != ["dense"] * 2 + ["sparse"] * 4:
        raise AssertionError(f"config 3 topk step kinds {records}")
    if any(launches.values()):
        raise AssertionError(f"config 3 topk launched {launches}")
    if nsel != k or any(rec["num_selected"] != k or rec["bytes_sent"] != k * 8
                        for rec in sparse):
        raise AssertionError(f"config 3 topk: {sparse}, {nsel}")
    _replay_arm_on_cpu(calls, None, trainer.comp, trainer.cfg.density,
                       "config 3 topk")
    del calls
    print(f"phase config3 topk: ResNet-50 n={n} k={k}, unfused, wire "
          f"{ts.wire_format}, no kernel launched ({launches}); "
          f"num_selected = k and bytes_sent = {k} x 8 B on every sparse "
          f"step; EF invariant exact on one more step; each call (4 sparse "
          f"steps and that one) equal to the CPU's replay bit for bit; peak "
          f"memory {peak / 2 ** 30:.2f} GiB ({gaussian['peak'] / 2 ** 30:.2f}"
          f" GiB with gaussian_fused, phase 8c); {_step_ms(records)}")
    prof = _profile(trainer, "config3 topk profile", ("aten::topk",))
    fused = gaussian["profile"]["device_ms_a_step"]
    print(f"phase config3 topk vs gaussian_fused: aten::topk "
          f"{prof['named_ms_a_step']:.3f} ms a step, "
          f"{prof['named_ms_a_step'] / prof['device_ms_a_step']:.1%} of the "
          f"TopK step's {prof['device_ms_a_step']:.2f} ms of device time; "
          f"the GaussianK step (gaussian_fused, phase 8c) "
          f"{fused:.2f} ms, its B1 {gaussian['b1_ms']:.4f} ms a call; "
          f"TopK - GaussianK {prof['device_ms_a_step'] - fused:.2f} ms a "
          f"step")
    acc = trainer.state.ef_residual.clone()
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "profile": prof, "peak": peak, "acc": acc}


def _arms_phase() -> dict:
    """Phase 12b: config 2 at full width with each arm of ``ARMS`` for 2
    dense + 2 sparse steps: no kernel; num_selected (k on the top-k arms;
    RedSync's count in [k, 2k] or its miss) and bytes_sent (the spec's
    slots x 8 B); the EF invariant of one more step; every call equal to
    the CPU's replay. Returns each arm's launches."""
    import torch
    out = {}
    for name in ARMS:
        trainer = _config(CONFIG2, ["--compressor", name, *WARMUP_2, "4"],
                          f"config2_{name}")
        ts, spec = trainer.ts, trainer.comp
        n, k = trainer.plan.total_numel, trainer.plan.total_k
        slots = spec.out_k(k)
        if (ts.fused_ef, ts.wire_format, ts.ef_numel) != (None, "i32f32", n):
            raise AssertionError(f"{name}: {ts.fused_ef}, {ts.wire_format}")
        noting = (_noting_samples(trainer) if spec.requires_rng
                  else contextlib.nullcontext())
        with noting as samples, _recorded_calls(trainer) as calls:
            records, launches, _ = _drive(trainer, f"arm {name}")
            _ef_invariant(trainer, f"config 2 {name}")
        sparse = [rec for rec in records if rec["kind"] == "sparse"]
        if any(launches.values()) or len(sparse) != 2:
            raise AssertionError(f"{name}: launches {launches}, {records}")
        if any(rec["bytes_sent"] != slots * 8 for rec in sparse):
            raise AssertionError(f"{name}: bytes_sent {sparse}")
        counts = [int(c[5]) for c in calls]
        if name.startswith("approxtopk") and counts != [k] * 3:
            raise AssertionError(f"{name}: num_selected {counts}")
        _replay_arm_on_cpu(calls, samples, spec, trainer.cfg.density,
                           f"config 2 {name}")
        if name.startswith("redsync"):
            desc = [f"{c} in [k, 2k]" if k <= c <= 2 * k else
                    f"{c}, outside [k, 2k] after the 20 passes"
                    for c in counts]
        else:
            desc = [f"{c / k:.4f} of k" for c in counts]
        print(f"phase arm {name}: spec {spec.name}, {slots} slots (k={k}), "
              f"no kernel launched; num_selected of each call (2 sparse "
              f"steps and one more) {desc}; bytes_sent {slots} x 8 B; EF "
              f"invariant exact; each call equal to the CPU's replay "
              f"bit for bit" + (" from the card's own sample of "
                                f"{samples[0].numel()} indices"
                                if spec.requires_rng else "")
              + f"; {_step_ms(records)}")
        out[name] = launches
        del trainer, calls, samples
        torch.cuda.empty_cache()
    return out


def _butterfly_on_one_card(sets, wire):
    """The butterfly over len(sets) workers simulated in one process: in
    round r each worker merges its set with the payload of worker
    ``w ^ (1 << r)``, through the step's own ``round_payload`` and
    ``merge_payload``."""
    from gaussiank_sgd_torch.parallel.gtopk import (merge_payload,
                                                    round_payload)
    k = sets[0][0].shape[0]
    for r in range(int(math.log2(len(sets)))):
        sent = [round_payload(i, v, wire) for i, v in sets]
        sets = [merge_payload(sets[w][0], sent[w][0],
                              sent[w ^ (1 << r)][1], wire, k)
                for w in range(len(sets))]
    return sets


def _gtopk_phase(dev) -> dict:
    """Phase 12c: config 2 with ``--exchange gtopk`` and ``gaussian_fused``
    in an NCCL group of one for 2 dense + 2 sparse steps (0 rounds, B2
    once a sparse step, B1 never, bytes_sent 0, the EF invariant against
    ``global_residual``); then the butterfly of 4 workers simulated on the
    card from 4 batches' accumulators, on both wires: every worker's
    global pairs equal, and equal to the same on the CPU. Returns B2's
    launches."""
    import torch
    import torch.distributed as dist
    from gaussiank_sgd_torch.compressors import decompress
    from gaussiank_sgd_torch.parallel import collectives, mesh
    from gaussiank_sgd_torch.parallel.gtopk import (global_residual,
                                                    gtopk_allreduce)
    from gaussiank_sgd_torch.parallel.wire import WIRE_PACKED, WireFormat
    store = os.path.join(RUN_DIR, "gtopk_store")
    if os.path.exists(store):
        os.remove(store)
    mesh.init_distributed(dev, 0, 1, "file://" + store)
    try:
        trainer = _config(CONFIG2, ["--compressor", "gaussian_fused",
                                    "--exchange", "gtopk", *WARMUP_2, "4"],
                          "config2_gtopk")
        ts, state = trainer.ts, trainer.state
        n, k = trainer.plan.total_numel, trainer.plan.total_k
        if ((ts.exchange, ts.fused_ef, ts.ef_numel, collectives.world_size())
                != ("gtopk", None, n, 1)):
            raise AssertionError(f"gtopk: {ts.exchange}, {ts.fused_ef}, "
                                 f"{ts.ef_numel}")
        records, launches, _ = _drive(trainer, "gtopk")
        want = {"fused_select": 2, "fused_ef_select": 0, "fused_stats": 0,
                "multi_threshold_counts": 0}
        sparse = [rec for rec in records if rec["kind"] == "sparse"]
        if launches != want or any(rec["bytes_sent"] != 0 for rec in sparse):
            raise AssertionError(f"gtopk: launches {launches}, {sparse}")
        g = ts.local_grads(state, trainer.next_batch())
        state.model_state["stats"].copy_(g.model_state_before["stats"])
        acc = state.ef_residual + g.flat_g
        comp = ts.compress_phase(state, g.flat_g)[0]
        gcomp, stats = gtopk_allreduce(comp, ts.wire_fmt)
        residual = global_residual(acc.clone(), gcomp)
        if stats.rounds or not torch.equal(decompress(gcomp, n) + residual,
                                           acc):
            raise AssertionError("gtopk: decompress(global pairs) + "
                                 "global_residual != acc")
        print(f"phase gtopk: config 2, gaussian_fused unfused (EF row "
              f"unpadded, {ts.ef_numel}), NCCL group of one: {stats.rounds}"
              f" rounds, bytes_sent 0, launches {launches} (B2 once a "
              f"sparse step, B1 never); EF invariant exact against "
              f"global_residual; {_step_ms(records)}")
    finally:
        dist.destroy_process_group()
    # four workers' sets from four batches, simulated on this card
    sets = []
    for _ in range(4):
        g = ts.local_grads(state, trainer.next_batch())
        state.model_state["stats"].copy_(g.model_state_before["stats"])
        comp = ts.compress_phase(state, g.flat_g)[0]
        sets.append((comp.indices, comp.values))
    chunk = 65_536
    packed = WireFormat(WIRE_PACKED, chunk, -(-n // chunk))
    for wname, wire in (("legacy", None), ("packed", packed)):
        card = _butterfly_on_one_card(sets, wire)
        cpu = _butterfly_on_one_card([(i.cpu(), v.cpu()) for i, v in sets],
                                     wire)
        if not all(_equal_bits((i, card[0][0]), (v, card[0][1]),
                               (i, ci), (v, cv))
                   for (i, v), (ci, cv) in zip(card, cpu)):
            raise AssertionError(f"gtopk simulated {wname}: the workers' "
                                 f"global pairs differ, or card != CPU")
        live = int((card[0][1] != 0).sum())
        print(f"phase gtopk simulated {wname}: 4 workers' sets of k={k} "
              f"(4 batches' accumulators) through 2 butterfly rounds on "
              f"this card: every worker's global pairs bit-identical, and "
              f"equal to the same rounds on the CPU; {live} of k non-zero")
    del trainer, state, sets
    torch.cuda.empty_cache()
    return {"gtopk": launches}


def _comparison_timings(acc, mem_rate: float) -> dict:
    """Phase 12d: ``merge_sparse`` at k = 14,987 and 25,558 on random sets
    that share a quarter of their indices, and ``topk_compress`` on config
    3's EF row beside ``torch.topk(acc.abs(), k)``; device time from a
    CUDA graph of 20 calls and the eager call."""
    import torch
    from gaussiank_sgd_torch.compressors.exact import topk_compress
    from gaussiank_sgd_torch.parallel.gtopk import merge_sparse
    gen = torch.Generator(device=acc.device).manual_seed(8)
    out = {}
    for k in (14_987, 25_558):
        ia, ib = (torch.randperm(4 * k, generator=gen, device=acc.device)[
            :k].to(torch.int32) for _ in range(2))
        va, vb = (torch.randn(k, generator=gen, device=acc.device)
                  for _ in range(2))
        out[f"merge_{k}"] = {
            "ms": _device_ms(lambda: merge_sparse(ia, va, ib, vb, k)),
            "call_ms": _median_ms(lambda: merge_sparse(ia, va, ib, vb, k),
                                  20)}
        print(f"phase merge_sparse k={k}: {out[f'merge_{k}']['ms']:.4f} ms "
              f"device time per call, {out[f'merge_{k}']['call_ms']:.4f} ms "
              f"per eager call")
    n, k = acc.numel(), RESNET50[1]
    # bytes: the f32 row read once, the k pairs and the residual written
    bound = _bound_ms(n * 4 * 2 + k * 8, 0, mem_rate)
    out["topk"] = {"ms": _device_ms(lambda: topk_compress(acc, k)),
                   "call_ms": _median_ms(lambda: topk_compress(acc, k), 20),
                   "library_ms": _device_ms(lambda: torch.topk(acc.abs(), k)),
                   "bound_ms": bound[0]}
    t = out["topk"]
    print(f"phase topk_compress [{n}] k={k}: {t['ms']:.4f} ms device time "
          f"per call ({t['call_ms']:.4f} ms eager), torch.topk(acc.abs(), "
          f"k) {t['library_ms']:.4f} ms; bound {bound[0]:.4f} ms by "
          f"{bound[1]} (the row read, the pairs and the residual written)")
    return out


def _exchange_runs(dev) -> dict:
    """Phase 7b: config 2 on both plans without a process group, then in
    an NCCL group of one; returns each plan's B1 launches."""
    import torch
    import torch.distributed as dist
    from gaussiank_sgd_torch.compressors import decompress
    from gaussiank_sgd_torch.parallel import collectives, mesh
    alone = {}
    for name, flags in PLANS.items():
        trainer = _config(CONFIG2, EXCHANGE_ARGV + flags, _run_id(name, "alone"))
        records, _, _ = _drive(trainer, f"exchange {name} alone")
        alone[name] = ([(rec["loss"], rec["num_selected"])
                        for rec in records], _state_copy(trainer))
        del trainer
    store = os.path.join(RUN_DIR, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    mesh.init_distributed(dev, 0, 1, "file://" + store)
    if ((dist.get_backend(), collectives.world_size())
            != (mesh.backend_for(dev), 1)):
        raise AssertionError(f"group {dist.get_backend()} of "
                             f"{collectives.world_size()}")
    b1_launches, payload_ms = {}, {}
    for name, flags in PLANS.items():
        trainer = _config(CONFIG2, EXCHANGE_ARGV + flags, _run_id(name, "nccl"))
        records, launches, _ = _drive(trainer, f"exchange {name} NCCL")
        ts = trainer.ts
        wire, per_entry, layout = EXCHANGE_WANT[name]
        k_total = trainer.plan.total_k
        if (ts.wire_format, ts.fused_ef) != (wire, layout):
            raise AssertionError(f"{name}: wire {ts.wire_format}, layout "
                                 f"{ts.fused_ef}; want {wire}, {layout}")
        sparse = [rec for rec in records if rec["kind"] == "sparse"]
        if any(rec["bytes_sent"] != k_total * per_entry for rec in sparse):
            raise AssertionError(f"{name}: bytes_sent "
                                 f"{[rec['bytes_sent'] for rec in sparse]}")
        # the default schedule: pipelined on the uniform plan, one B1 call
        # a chunk; sequential on the whole bucket, one a step
        n_chunks = layout[0]
        if ts.overlap != ("pipelined" if n_chunks > 1 else "off"):
            raise AssertionError(f"{name}: schedule {ts.overlap}")
        if launches["fused_ef_select"] != len(sparse) * n_chunks:
            raise AssertionError(f"{name}: B1 launched "
                                 f"{launches['fused_ef_select']} times in "
                                 f"{len(sparse)} sparse steps of "
                                 f"{n_chunks} chunk(s)")
        # the cold step counts exactly k, as on the main path; the warm
        # controller's later counts trail the loss and are only printed
        ratios = [rec["num_selected"] / rec["k"] for rec in sparse]
        if ratios[0] != 1.0:
            raise AssertionError(f"{name}: num_selected / k {ratios}")
        seen, before = alone[name]
        if [(rec["loss"], rec["num_selected"]) for rec in records] != seen:
            raise AssertionError(f"{name}: losses and counts with NCCL "
                                 f"{records} vs alone {seen}")
        for key, t in _state_copy(trainer).items():
            if not torch.equal(_bits(t), _bits(before[key])):
                raise AssertionError(f"{name}: {key} differs with NCCL")
        # the EF invariant of one more step against the decoded values
        state = trainer.state
        g = ts.local_grads(state, trainer.next_batch())
        state.model_state["stats"].copy_(g.model_state_before["stats"])
        acc = state.ef_residual + g.flat_g
        payload, residual, _, _ = ts.pack_phase(state, g.flat_g)
        sent = ts.unpack(payload, workers=1)
        if not torch.equal(decompress(sent, ts.ef_numel) + residual, acc):
            raise AssertionError(f"{name}: decompress(decoded) + residual "
                                 f"!= acc")
        payload_ms[name] = [
            (str(t.dtype).replace("torch.", ""), t.numel(),
             _median_ms(lambda t=t: collectives.all_gather(t), 20))
            for t in payload]
        b1_launches[name] = launches["fused_ef_select"]
        print(f"phase exchange {name}: NCCL group of one, schedule "
              f"{ts.overlap}, wire {ts.wire_format}, layout {ts.fused_ef}, "
              f"bytes_sent "
              f"{sparse[0]['bytes_sent']:.0f} ({k_total} x {per_entry} B), "
              f"B1 {launches['fused_ef_select']} launches in {len(sparse)} "
              f"sparse steps, num_selected / k "
              f"{[round(r, 4) for r in ratios]}; losses, counts, params, "
              f"momentum, EF row and thresholds bit-identical to the run "
              f"without a group; EF invariant exact against the decoded "
              f"values")
        del trainer, state, g, acc, payload, residual, sent
    flat = torch.randn(14_986_698, device=dev)
    dense_ms = _median_ms(lambda: dist.all_reduce(flat), 20)
    mean_ms = _median_ms(lambda: collectives.dense_allreduce(flat), 20)
    for name, rows in payload_ms.items():
        print(f"phase exchange all-gather {name}: " + "; ".join(
            f"{dtype}[{numel}] {ms:.4f} ms" for dtype, numel, ms in rows)
            + " (NCCL, world of one, CUDA events, median of 20)")
    print(f"phase exchange dense all-reduce: f32[14986698] (59.9 MB) "
          f"{dense_ms:.4f} ms in place; dense_allreduce (copy, all-reduce, "
          f"/ P) {mean_ms:.4f} ms (NCCL, world of one, median of 20)")
    dist.destroy_process_group()
    return b1_launches


def _scatter_phase(n: int, dev) -> None:
    """Phase 7c: the ordered scatter of 8 gathered payloads, card twice
    and CPU once, bit for bit."""
    import numpy as np
    import torch
    from gaussiank_sgd_torch.compressors.base import scatter_add_ordered
    world, k, chunk = 8, 15_114, 65_536
    rng = np.random.default_rng(0)
    pool = rng.choice(n, size=2 * k, replace=False)
    idx, val = [], []
    for _ in range(world):
        i = rng.choice(pool, size=k, replace=False)
        v = rng.normal(size=k).astype(np.float32) * np.float32(1e-3)
        pad = rng.random(k) < 0.05
        i[pad], v[pad] = (i[pad] // chunk) * chunk, 0.0
        idx.append(i)
        val.append(v)
    idx = torch.from_numpy(np.concatenate(idx).astype(np.int32))
    val = torch.from_numpy(np.concatenate(val) / np.float32(world))
    m = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    real = idx[val != 0].numpy()
    hits = np.bincount(real, minlength=n)
    outs = []
    for d in (dev, dev, "cpu"):
        out = scatter_add_ordered(m.to(d, copy=True), idx.to(d),
                                  val.to(d), rounds=world)
        outs.append(out.cpu())
    for i, out in enumerate(outs[1:], 1):
        if not torch.equal(outs[0].view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"ordered scatter: run {i} differs")
    m_d, idx_d, val_d = m.to(dev), idx.to(dev), val.to(dev)
    idx64 = idx_d.to(torch.int64)
    plain = [m_d.clone().index_add_(0, idx64, val_d).cpu() for _ in range(2)]
    ms = _median_ms(lambda: scatter_add_ordered(m_d, idx_d, val_d,
                                                rounds=world), 20)
    plain_ms = _median_ms(lambda: m_d.index_add_(0, idx64, val_d), 20)
    print(f"phase ordered scatter: {world} x {k} pairs into [{n}], "
          f"{int((hits >= 2).sum())} coordinates sent by 2 or more payloads "
          f"({int(hits[hits >= 2].sum())} pairs, at most {int(hits.max())} "
          f"a coordinate), {int((val == 0).sum())} padding slots; card "
          f"twice and CPU once bit-identical; {ms:.4f} ms on the card "
          f"(CUDA events, median of 20) against one index_add_ {plain_ms:.4f}"
          f" ms, whose two card runs are "
          f"{'bit-identical' if torch.equal(plain[0].view(torch.int32), plain[1].view(torch.int32)) else 'different'}"
          f" and {'equal' if torch.equal(plain[0].view(torch.int32), outs[0].view(torch.int32)) else 'not equal'}"
          f" to the ordered sum")


def _two_workers_phase() -> None:
    """Phase 7d: two ranks on this card in a gloo group; their parameters
    must be bit-identical after every step."""
    d = os.path.join(RUN_DIR, "two_workers")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--worker", str(r), "2", d],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"two workers: rank {r} exited "
                                 f"{p.returncode}: {err[-3000:]}")
    res = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    if res[0]["hashes"] != res[1]["hashes"]:
        raise AssertionError(f"two workers: parameters differ: {res}")
    if res[0]["losses"] != res[1]["losses"]:
        raise AssertionError(f"two workers: losses differ: {res}")
    n_chunks = EXCHANGE_WANT["uniform 65536"][2][0]
    for rr in res:
        # the default schedule on the uniform plan: one B1 call a chunk
        if (rr["launches"]["fused_ef_select"] != 2 * n_chunks
                or rr["wire"] != "u16bf16" or rr["overlap"] != "pipelined"):
            raise AssertionError(f"two workers: {rr}")
    print(f"phase two workers: gloo group of 2 on this card (CUDA tensors), "
          f"config 2 on the uniform plan, schedule {res[0]['overlap']}, wire "
          f"{res[0]['wire']}, 1 dense + 2 "
          f"sparse steps, losses {res[0]['losses']}, parameters "
          f"bit-identical on both ranks after every step (sha256 "
          f"{[h[:12] for h in res[0]['hashes']]}), B1 "
          f"{res[0]['launches']['fused_ef_select']} launches a rank (one a "
          f"chunk), "
          f"bytes_sent {res[0]['bytes_sent']}; {time.perf_counter() - t0:.1f}"
          f" s with the processes' start")


def _worker(rank: int, world: int, d: str) -> int:
    """One rank of phase 7d."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.parallel import mesh
    mesh.init_distributed("cuda:0", rank, world,
                          "file://" + os.path.join(d, "store"),
                          backend="gloo")
    trainer = _config(CONFIG2, ["--compressor", "gaussian_fused", "--nworkers",
                        str(world), "--max-steps", "3",
                        "--compress-warmup-steps", "1",
                        *PLANS["uniform 65536"]], f"two_workers_{rank}")
    _reset_launches()
    hashes, losses, sent = [], [], []
    for _ in range(3):
        trainer.train(1)
        rec = trainer.records[-1]
        params = trainer.state.params.detach().cpu().numpy()
        hashes.append(hashlib.sha256(params.tobytes()).hexdigest())
        losses.append(rec["loss"])
        sent.append(rec["bytes_sent"])
    torch.cuda.synchronize()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump({"hashes": hashes, "losses": losses, "bytes_sent": sent,
                   "launches": _launches(), "overlap": trainer.ts.overlap,
                   "wire": trainer.ts.wire_format}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------ phase 13: the options

# config 2 with the reference's optimizer and threshold options (13a-b)
OPTIONS_ARGV = ["--compressor", "gaussian_fused", "--nesterov", "--fold-lr",
                "--sigma-scale", "2.5", "--max-steps", "6",
                "--compress-warmup-steps", "2", "--save-every-steps", "4"]
# the two-level layout of 13c: 2 workers a node on 2 nodes, one card
TWO_LEVEL = (2, 2)


def _optax_state(trainer) -> dict:
    st = trainer.state
    return {"params": st.params.detach().clone(),
            "trace": st.opt_state["trace"].clone(),
            "count": st.opt_state["count"].clone(),
            "EF row": st.ef_residual.clone(),
            "thresholds": st.comp_state.clone()}


def _sigma_scale_t0(density: float) -> str:
    """13a's threshold scale: config 2 as shipped (``gaussian``, whose
    estimate reads it) under the same flags, 2 dense + 1 sparse steps. The
    first sparse step's t0 on the card against ``|mu| + 2.5 sigma`` on the
    CPU from the card's accumulator (f64 moments), and the call replayed
    on the CPU as in 6c. (``gaussian_fused``'s kernel path bootstraps its
    threshold from its candidates and never estimates, as in the
    reference.)"""
    import torch
    from gaussiank_sgd_torch.compressors.gaussian import \
        gaussian_threshold_estimate
    trainer = _config(CONFIG2, ["--nesterov", "--fold-lr", "--sigma-scale",
                                "2.5", "--max-steps", "3",
                                "--compress-warmup-steps", "2"],
                      "options_gaussian")
    if (trainer.comp.name, trainer.cfg.sigma_scale) != ("gaussian", 2.5):
        raise AssertionError(f"{trainer.comp.name}, {trainer.cfg}")
    with _recorded_calls(trainer) as calls:
        _drive(trainer, "options gaussian")
    acc = calls[0][0]
    t0 = float(gaussian_threshold_estimate(acc, density, 2.5))
    a = acc.cpu().double()
    t0_cpu = float(a.mean().abs() + 2.5 * a.std(correction=0))
    if abs(t0 - t0_cpu) > 1e-5 * t0_cpu:
        raise AssertionError(f"t0 {t0} on the card, |mu| + 2.5 sigma = "
                             f"{t0_cpu} on the CPU")
    quantile = float(gaussian_threshold_estimate(acc, density))
    replay = _replay_on_cpu(calls, density, "options gaussian", 2.5)
    del trainer, calls, acc
    torch.cuda.empty_cache()
    return (f"t0 {t0:.6g} on the card = |mu| + 2.5 sigma {t0_cpu:.6g} on "
            f"the CPU (f64 moments of the card's accumulator, within 1e-5; "
            f"the density's quantile would give {quantile:.6g}); "
            f"num_selected / k {replay[0]}, equal to the CPU's replay")


def _options_phase(mem_rate: float, main_profile: dict) -> dict:
    """Phase 13a-b: config 2 with ``gaussian_fused --nesterov --fold-lr
    --sigma-scale 2.5`` for 2 dense + 4 sparse steps, a checkpoint at step
    4 (in a temporary directory: ~180 MB), and the run resumed from it."""
    import torch
    from gaussiank_sgd_torch.parallel.flat_opt import OptaxSGD
    density = 0.001
    tmp = tempfile.mkdtemp(prefix="chip_smoke_options_")
    try:
        trainer = _config(CONFIG2, OPTIONS_ARGV, "options", out_dir=tmp)
        ts = trainer.ts
        n, k = trainer.plan.total_numel, trainer.plan.total_k
        if (not isinstance(ts.optimizer, OptaxSGD) or not ts.optimizer.nesterov
                or ts.fold_lr is None or ts.optimizer.lr_at(0) != 1.0
                or trainer.comp.name != "gaussian_fused"
                or ts.fused_ef != EXCHANGE_WANT["whole bucket"][2]):
            raise AssertionError(f"options run: optimizer {ts.optimizer}, "
                                 f"fold_lr {ts.fold_lr}, layout "
                                 f"{ts.fused_ef}, {trainer.comp.name}")
        with _recorded_fused(trainer) as calls:
            records, launches, _ = _drive(trainer, "options")
        sparse = [rec for rec in records if rec["kind"] == "sparse"]
        if launches["fused_ef_select"] != 4 or len(sparse) != 4:
            raise AssertionError(f"options: B1 launched "
                                 f"{launches['fused_ef_select']} times in "
                                 f"{len(sparse)} sparse steps")
        scales = [c[2] for c in calls]
        want = [ts.scale(rec["step"] - 1) for rec in sparse]
        if scales != want or any(s == 1.0 for s in scales):
            raise AssertionError(f"options: B1's scales {scales}, the "
                                 f"schedule's {want}")
        ratios = [rec["num_selected"] / rec["k"] for rec in sparse]
        if ratios[0] != 1.0:
            raise AssertionError(f"options: num_selected / k {ratios}")
        replay = _replay_fused_on_cpu(calls, density, "options")
        res, g, scale = calls[-1][0], calls[-1][1], calls[-1][2]
        del calls
        want_state = _optax_state(trainer)
        b1, b1_err, _, _, _ = _b1_rows(res, g, n, density, mem_rate,
                                       " options", scale)
        del res, g
        # 13b: the same run resumed from its step-4 checkpoint
        resume = os.path.join(trainer.ckpt_dir, "step_00000004")
        again = _config(CONFIG2, OPTIONS_ARGV + ["--resume", resume],
                        "options_resumed", out_dir=tmp)
        if int(again.state.opt_state["count"]) != 4:
            raise AssertionError(f"resumed count "
                                 f"{again.state.opt_state['count']}")
        resumed, launches_r, _ = _drive(again, "options resumed")
        if [r["loss"] for r in resumed] != [r["loss"] for r in records[4:]]:
            raise AssertionError(f"resumed losses {resumed} vs "
                                 f"{records[4:]}")
        for key, t in _optax_state(again).items():
            if not torch.equal(_bits(t), _bits(want_state[key])):
                raise AssertionError(f"resumed {key} differs at step 6")
        del again, want_state
        torch.cuda.empty_cache()
        nsel = _ef_invariant(trainer, "options")
        print(f"phase options: config 2 gaussian_fused --nesterov --fold-lr "
              f"--sigma-scale 2.5 (optimizer OptaxSGD at lr 1, EF row "
              f"accumulating lr(step) * g), n={n} k={k}; B1 "
              f"{launches['fused_ef_select']} launches in {len(sparse)} "
              f"sparse steps at scales {scales}; num_selected / k "
              f"{[round(r, 4) for r in ratios]}; every call equal to the "
              f"CPU's replay ({replay}); EF invariant exact on one more step "
              f"with acc = res + lr * g (num_selected {nsel})")
        print(f"phase options resume: a fresh trainer from step_00000004 "
              f"repeated steps 5-6 bit for bit (losses "
              f"{[r['loss'] for r in resumed]}; params, trace, count, EF row "
              f"and thresholds at step 6); B1 "
              f"{launches_r['fused_ef_select']} launches")
        print(f"phase options sigma-scale: {_sigma_scale_t0(density)}")
        prof = _profile(trainer, "options profile")
        ms, ms_main = (prof["device_ms_a_step"],
                       main_profile["device_ms_a_step"])
        print(f"phase options vs main path: {ms:.3f} ms of device time a "
              f"sparse step on the optax path (nesterov, fold_lr) against "
              f"{ms_main:.3f} ms for phase 6a's gaussian_fused step "
              f"(FlatSGDM): {ms - ms_main:+.3f} ms, the dense scatter and "
              f"the chain's passes")
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches_options": launches["fused_ef_select"],
            "launches_resumed": launches_r["fused_ef_select"],
            "scales": scales, "max_abs_err": b1_err,
            **{key: b1[key] for key in ("ms", "call_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
            "scale": scale, "device_ms_a_step": prof["device_ms_a_step"]}


def _small_two_level(device: str) -> dict:
    """A narrow VGG (f32, dropout 0) in the 2 x 2 layout on ``device``:
    3 steps of ``gaussian_fused``; each step's loss and the last params."""
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    ici, dcn = TWO_LEVEL
    cfg = TrainConfig(
        dnn="vgg16", batch_size=16, compressor="gaussian_fused",
        density=0.01, ici_size=ici, dcn_size=dcn, nworkers=ici * dcn,
        compress_warmup_steps=1, max_steps=3, lr=0.02,
        compute_dtype="float32", device=device,
        model_kwargs={"cfg": NARROW, "dropout": 0.0}, output_dir=RUN_DIR,
        run_id=f"two_level_small_{device}")
    trainer = Trainer(cfg)
    losses = [rec["loss"] for rec in _steps(trainer)]
    return {"losses": losses,
            "params": trainer.state.params.detach().cpu().numpy()}


def _two_level_worker(rank: int, world: int, d: str) -> int:
    """One rank of phase 13c: config 2 in the 2 x 2 layout on cuda:0 over
    gloo, then the narrow VGG on the card and on the CPU."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.parallel import mesh
    mesh.init_distributed("cuda:0", rank, world,
                          "file://" + os.path.join(d, "store"),
                          backend="gloo")
    ici, dcn = TWO_LEVEL
    trainer = _config(CONFIG2, ["--compressor", "gaussian_fused",
                                "--ici-size", str(ici), "--dcn-size",
                                str(dcn), "--max-steps", "3",
                                "--compress-warmup-steps", "1"],
                      f"two_level_{rank}")
    _reset_launches()
    hashes, losses, sent, step_ms = [], [], [], []
    for _ in range(3):
        trainer.train(1)
        rec = trainer.records[-1]
        params = trainer.state.params.detach().cpu().numpy()
        hashes.append(hashlib.sha256(params.tobytes()).hexdigest())
        losses.append(rec["loss"])
        sent.append(rec["bytes_sent"])
        step_ms.append(rec["step_ms"])
    torch.cuda.synchronize()
    launches = _launches()
    out = {"hashes": hashes, "losses": losses, "bytes_sent": sent,
           "step_ms": step_ms, "launches": launches,
           "k": trainer.plan.total_k, "wire": trainer.ts.wire_format,
           "mesh": list(trainer.ts.mesh.sizes),
           "optimizer": type(trainer.ts.optimizer).__name__,
           "nworkers": trainer.cfg.nworkers}
    del trainer
    torch.cuda.empty_cache()
    small = {dev: _small_two_level(dev) for dev in ("cuda", "cpu")}
    card, cpu = small["cuda"], small["cpu"]
    out["small"] = {"card": card["losses"], "cpu": cpu["losses"],
                    "loss_gap": max(abs(a - b) / abs(b) for a, b in
                                    zip(card["losses"], cpu["losses"])),
                    "params_ok": bool(np.allclose(card["params"],
                                                  cpu["params"], rtol=1e-3,
                                                  atol=1e-4)),
                    "params_gap": float(np.abs(card["params"]
                                               - cpu["params"]).max())}
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _two_level_phase() -> dict:
    """Phase 13c: four ranks on this card, gloo, ``--ici-size 2 --dcn-size
    2``; their parameters bit-identical after every step, B1 once a sparse
    step a rank, bytes_sent k x 8 B; then the narrow VGG card vs CPU."""
    ici, dcn = TWO_LEVEL
    world = ici * dcn
    d = os.path.join(RUN_DIR, "two_level")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--two-level-worker", str(r), str(world), d],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=500) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"two-level: rank {r} exited "
                                 f"{p.returncode}: {err[-3000:]}")
    res = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    first = res[0]
    k = first["k"]
    wire, per_entry, _ = EXCHANGE_WANT["whole bucket"]
    for r, rr in enumerate(res):
        if rr["hashes"] != first["hashes"] or rr["losses"] != first["losses"]:
            raise AssertionError(f"two-level: rank {r} differs: {res}")
        if (rr["launches"]["fused_ef_select"] != 2 or rr["wire"] != wire
                or rr["bytes_sent"][1:] != [k * per_entry] * 2
                or rr["mesh"] != [dcn, ici] or rr["nworkers"] != world
                or rr["optimizer"] != "OptaxSGD"):
            raise AssertionError(f"two-level: rank {r}: {rr}")
        small = rr["small"]
        if small["loss_gap"] > 1e-4 or not small["params_ok"]:
            raise AssertionError(f"two-level narrow VGG: card and CPU "
                                 f"disagree on rank {r}: {small}")
    small = first["small"]
    print(f"phase two-level: config 2 gaussian_fused on 4 ranks of a gloo "
          f"group on this card (CUDA tensors), --ici-size {ici} --dcn-size "
          f"{dcn} (mesh dcn x ici {first['mesh']}, optimizer "
          f"{first['optimizer']}, wire {first['wire']}), 1 dense + 2 sparse "
          f"steps, losses {first['losses']}, parameters bit-identical on "
          f"all four ranks after every step (sha256 "
          f"{[h[:12] for h in first['hashes']]}), B1 "
          f"{[rr['launches']['fused_ef_select'] for rr in res]} launches a "
          f"rank, bytes_sent {first['bytes_sent']} (k = {k} x {per_entry} "
          f"B on the sparse steps; the dcn dense all-reduce is not in it), "
          f"rank 0's "
          f"step ms {[round(v, 1) for v in first['step_ms']]}; {wall:.1f} s "
          f"of wall time with the processes' start")
    print(f"phase two-level narrow VGG: f32 2 x 2 losses on the card "
          f"{small['card']} vs CPU {small['cpu']} (max rel gap "
          f"{small['loss_gap']:.2e} <= 1e-4), params within rtol 1e-3 / "
          f"atol 1e-4 (max gap {small['params_gap']:.2e}) on every rank")
    return {"launches": [rr["launches"]["fused_ef_select"] for rr in res],
            "wall_s": wall}


# ---------------------------------------------- phase 14: the model zoo

# n, k at density 0.001 and the padded EF row of each model of phase 14
ZOO = {"lstman4": (16_138_045, 16_139, 16_252_928),
       "alexnet": (23_272_266, 23_273, 23_330_816),
       "mnistnet": (1_663_370, 1_664, 1_703_936)}
ZOO_ARGV = {"lstman4": ["--dnn", "lstman4", "--dataset", "an4"],
            "alexnet": ["--dnn", "alexnet", "--dataset", "cifar10",
                        "--batch-size", "128"],
            "mnistnet": ["--dnn", "mnistnet", "--dataset", "mnist",
                         "--batch-size", "128"]}
ZOO_FUSED = ["--compressor", "gaussian_fused", "--density", "0.001",
             "--compress-warmup-steps", "2", "--max-steps"]
# 14a's narrow lstman4, run on the card and on the CPU
AN4_NARROW = ["--dnn", "lstman4", "--dataset", "an4", "--compute-dtype",
              "float32", "--batch-size", "8", "--compressor",
              "gaussian_fused", "--density", "0.01",
              "--compress-warmup-steps", "1", "--max-steps", "3",
              "--model-kwargs", json.dumps({"hidden": 32, "num_layers": 2,
                                            "freq": 41}),
              "--dataset-kwargs", json.dumps({"freq": 41, "time": 24,
                                              "synthetic_examples": 64})]


def _zoo_run(name: str, steps: int, then=None):
    """``name`` at full width through the CLI's flags (their defaults but
    ``gaussian_fused`` at 0.001, 2 dense steps, batch 128 for the image
    models) for ``steps`` steps, every fused call recorded: ``(trainer,
    records, launches, calls, what then() returned)``. Each call's B1
    inputs run again through the kernel and its plain version on the card,
    bit for bit (those launches are not counted), and the whole call is
    replayed on the CPU. ``then(trainer)`` runs inside the counted
    window, after the steps."""
    from gaussiank_sgd_torch.ops import fused_select as fs
    trainer = _config(None, ZOO_ARGV[name] + ZOO_FUSED + [str(steps)],
                      f"zoo_{name}")
    n, k, pad = ZOO[name]
    if ((trainer.plan.total_numel, trainer.plan.total_k) != (n, k)
            or trainer.ts.fused_ef != (1, n, pad)):
        raise AssertionError(f"{name}: n, k {trainer.plan.total_numel}, "
                             f"{trainer.plan.total_k}, layout "
                             f"{trainer.ts.fused_ef}")
    with _recorded_fused(trainer) as calls:
        records, launches, extra = _drive(
            trainer, f"zoo {name}", then and (lambda: then(trainer)),
            skips=True)
    sparse = sum(rec["kind"] == "sparse" for rec in records)
    if (launches["fused_ef_select"] != sparse or launches["fused_stats"]
            or launches["multi_threshold_counts"]):
        raise AssertionError(f"{name}: launches {launches} in {sparse} "
                             f"sparse steps")
    err = 0.0
    for i, (res, g, scale, _, st, *_) in enumerate(calls):
        err = max(err, _same(
            fs.fused_ef_select_candidates_chunked(res, g, scale, st, 0.001),
            fs.fused_ef_select_plain(res, g, scale, st, 0.001),
            f"{name} B1 call {i}"))
    replay = _replay_fused_on_cpu(calls, 0.001, f"zoo {name}")
    print(f"phase zoo {name}: n={n} k={k}, layout {trainer.ts.fused_ef}, "
          f"{trainer.cfg.compute_dtype}, batch {trainer.cfg.batch_size}; "
          f"launches {launches}; every B1 call bit-identical to its plain "
          f"version on the card, every compressor call equal to the CPU's "
          f"replay; num_selected / k {replay}; {_step_ms(records)}")
    return trainer, records, launches, err, extra


def _ctc_determinism(trainer) -> str:
    """The CTC loss's backward twice on one batch's logits, and the whole
    backward (``local_grads``) twice on that batch: loss, the logits'
    gradient and the flat gradient bit for bit."""
    import torch
    from gaussiank_sgd_torch.training.losses import ctc_loss
    ts, state = trainer.ts, trainer.state
    x, y = trainer.next_batch()
    with torch.no_grad():
        logits = trainer.model(x, train=False)
    runs, flats = [], []
    for _ in range(2):
        t = logits.clone().requires_grad_()
        loss = ctc_loss(t, y).mean()
        runs.append((loss.detach(), torch.autograd.grad(loss, t)[0]))
        grads = ts.local_grads(state, (x, y))
        state.model_state["stats"].copy_(grads.model_state_before["stats"])
        flats.append(grads.flat_g.clone())
    if not _equal_bits(*zip(*runs)):
        raise AssertionError("CTC backward: two runs on the same logits "
                             "differ")
    if not _equal_bits((flats[0], flats[1])):
        raise AssertionError("lstman4: two backward passes on one batch "
                             "differ")
    return (f"F.ctc_loss forward and backward on logits "
            f"{list(logits.shape)} twice, loss {float(runs[0][0]):.6f} "
            f"and d loss / d logits bit for bit; the flat gradient "
            f"[{flats[0].numel()}] of two backward passes bit for bit")


def _an4_eval_card_vs_cpu(trainer) -> str:
    """The trained weights in f32 on the card and on the CPU, on the first
    test batch: the CTC losses within 1e-4, the edit and reference sums
    equal, or else every frame whose arg-max differs is listed (a tie
    within f32 noise), and the sums over the utterances without such a
    frame must still be equal."""
    import torch
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.training.losses import (char_error_counts,
                                                     ctc_loss)
    x, y = next(trainer.test_ds.epoch())
    out = {}
    for name, dev in DEVICES.items():
        m = get_model("lstman4", device=dev,
                      **trainer.cfg.model_kwargs).module
        with torch.no_grad():
            m.flat.copy_(trainer.model.flat[:m.n_params])
            m.stats.copy_(trainer.model.stats)
            xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            logits = m(xs, train=False)
            out[name] = (logits, ys, float(ctc_loss(logits, ys).sum()),
                         [float(v) for v in char_error_counts(logits, ys)])
    (lc, yc, loss_c, cer_c), (lp, yp, loss_p, cer_p) = (out["card"],
                                                        out["cpu"])
    lc = lc.cpu()
    flips = (lc.argmax(-1) != lp.argmax(-1)).nonzero().tolist()
    if abs(loss_c / loss_p - 1) > 1e-4 or (cer_c != cer_p and not flips):
        raise AssertionError(f"an4 eval card vs CPU: loss {loss_c} vs "
                             f"{loss_p}, edits/refs {cer_c} vs {cer_p}")
    # a flip may move its own utterance's edits, and no other's
    rows = [b for b in range(len(x)) if b not in {f[0] for f in flips}]
    if flips and rows:
        rest_c = [float(v) for v in char_error_counts(out["card"][0][rows],
                                                      yc[rows])]
        rest_p = [float(v) for v in char_error_counts(lp[rows], yp[rows])]
        if rest_c != rest_p:
            raise AssertionError(
                f"an4 eval card vs CPU: on the {len(rows)} utterances "
                f"without a flipped frame, edits/refs {rest_c} vs {rest_p}")
    gaps = [float(lp[b, t].topk(2).values.diff().abs()) for b, t in flips]
    return (f"{len(x)} utterances x {lc.shape[1]} frames, f32: loss sum "
            f"{loss_c:.4f} on the card vs {loss_p:.4f} on the CPU; edit / "
            f"reference sums {cer_c} vs {cer_p}; frames whose arg-max "
            f"differs: {len(flips)}"
            + (f" {flips[:8]} (CPU top-2 gaps {gaps[:8]})" if flips else ""))


def _an4_real_data(tmp: str) -> str:
    """The real-data path: 16 kHz tone wavs (0.6 s and 1.5 s: frame widths
    59 and 149, the 100 and 200 buckets) with transcripts and both splits'
    manifests written to ``tmp``, then 2 steps of ``lstman4`` at full
    width through ``Trainer`` on them (batch 4, 1 dense + 1 sparse)."""
    import numpy as np
    from gaussiank_sgd_torch.data import BucketedDataset
    from gaussiank_sgd_torch.data.audio import SAMPLE_RATE, write_wav
    words = ("yes", "no", "enter", "hello", "seven", "two", "rubout", "go")
    for split, n in (("train", 8), ("val", 4)):
        rows = []
        for i in range(n):
            secs = 0.6 if i % 2 == 0 else 1.5
            t = np.arange(int(secs * SAMPLE_RATE)) / SAMPLE_RATE
            wav = os.path.join(tmp, f"{split}{i}.wav")
            write_wav(wav, (0.5 * np.sin(2 * np.pi * (300 + 40 * i) * t))
                      .astype(np.float32))
            with open(os.path.join(tmp, f"{split}{i}.txt"), "w") as f:
                f.write(words[i])
            rows.append(f"{split}{i}.wav,{split}{i}.txt")
        with open(os.path.join(tmp, f"an4_{split}_manifest.csv"), "w") as f:
            f.write("\n".join(rows))
    trainer = _config(None, ["--dnn", "lstman4", "--dataset", "an4",
                             "--data-dir", tmp, "--batch-size", "4",
                             "--compressor", "gaussian_fused",
                             "--compress-warmup-steps", "1",
                             "--max-steps", "2"], "an4_real")
    ds = trainer.train_ds
    if not isinstance(ds, BucketedDataset) or sorted(
            p.x.shape[2] for p in ds.pools) != [100, 200]:
        raise AssertionError(f"an4 real data: {ds}")
    widths = []
    draw = trainer.next_batch

    def noted():
        batch = draw()
        widths.append(int(batch[0].shape[2]))
        return batch

    trainer.next_batch = noted
    records, launches, _ = _drive(trainer, "zoo an4 real data")
    if launches["fused_ef_select"] != 1:
        raise AssertionError(f"an4 real data: launches {launches}")
    return (f"8 + 4 tone wavs in {tmp} (pools of widths "
            f"{[p.x.shape[2] for p in ds.pools]}, labels padded to "
            f"{ds.pools[0].y.shape[1]}): 2 steps at widths {widths}, losses "
            f"{[round(r['loss'], 4) for r in records]}, B1 "
            f"{launches['fused_ef_select']} launch")


def _zoo_phase(mem_rate: float) -> dict:
    """Phase 14: lstman4 / an4 (a), alexnet / cifar10 (b) and mnistnet /
    mnist (c) at full width, one worker, on the synthetic fallbacks;
    returns B1's and B2's launches and times for the kernels line."""
    import torch
    from gaussiank_sgd_torch.compressors import decompress
    t0 = time.perf_counter()
    out = {"launches": {}}
    # a. lstman4: 2 dense + 4 sparse steps, then the registry's flat call
    # on the EF row (B2)
    n, k, _ = ZOO["lstman4"]
    trainer, records, launches, err, r = _zoo_run(
        "lstman4", 6, lambda t: t.comp.fn(
            t.state.ef_residual[:n].contiguous(), k,
            t.state.comp_state[0, 0]))
    out["launches"]["lstman4"] = launches["fused_ef_select"]
    out["launches_b2"] = launches["fused_select"]
    if launches["fused_select"] < 1 or not torch.equal(
            decompress(r[0].compressed, n) + r[0].residual,
            trainer.state.ef_residual[:n]):
        raise AssertionError(f"lstman4 flat call: launches {launches}")
    out["err"] = err
    nsel = _ef_invariant(trainer, "lstman4 sparse step")
    print(f"phase zoo lstman4 EF invariant: exact on one more sparse step "
          f"(num_selected {nsel}); losses "
          f"{[round(rec['loss'], 4) for rec in records]}, skipped "
          f"{[int(rec['skipped']) for rec in records]}")
    print(f"phase zoo lstman4 ctc determinism: {_ctc_determinism(trainer)}")
    ev = trainer.test()
    if not math.isfinite(ev["val_loss"]) or not 0.0 <= ev["cer"]:
        raise AssertionError(f"lstman4 eval: {ev}")
    print(f"phase zoo lstman4 eval: {trainer.test_ds.num_examples} test "
          f"utterances, val_loss {ev['val_loss']:.4f}, cer {ev['cer']:.4f}")
    print(f"phase zoo lstman4 eval card vs CPU: "
          f"{_an4_eval_card_vs_cpu(trainer)}")
    out["profile"] = _profile(trainer, "zoo lstman4 profile")
    res, g = _grad_rows(trainer)
    out["b1_lstman4"], b1_err, _, _, warm = _b1_rows(
        res, g, n, 0.001, mem_rate, " lstman4")
    x = (res + g)[:, :n].contiguous()
    del res, g, r
    out["b2_lstman4"], b2_err = _b2_rows(x, warm, 0.001, mem_rate,
                                         "lstman4 acc")
    out["err"], out["b2_err"] = max(err, b1_err), b2_err
    del x, trainer
    torch.cuda.empty_cache()
    losses = {name: [rec["loss"] for rec in _steps(_config(
        None, AN4_NARROW + ["--device", d], f"zoo_an4_small_{name}"))]
        for name, d in DEVICES.items()}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                 losses["cpu"])]
    if max(gaps) > 1e-5:
        raise AssertionError(f"narrow lstman4: card and CPU disagree: "
                             f"{losses}")
    print(f"phase zoo lstman4 small: narrow lstman4 (hidden 32, 2 layers, "
          f"41 x 24 input) f32 losses on the card {losses['card']} vs CPU "
          f"{losses['cpu']} (max rel gap {max(gaps):.2e} <= 1e-5)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_an4_")
    try:
        print(f"phase zoo an4 real data: {_an4_real_data(tmp)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    # b. alexnet: 2 dense + 4 sparse steps; B1 timed at its row
    trainer, _, launches, err, _ = _zoo_run("alexnet", 6)
    out["launches"]["alexnet"] = launches["fused_ef_select"]
    res, g = _grad_rows(trainer)
    out["b1_alexnet"], b1_err, _, _, _ = _b1_rows(
        res, g, ZOO["alexnet"][0], 0.001, mem_rate, " alexnet")
    out["err"] = max(out["err"], err, b1_err)
    del res, g, trainer
    torch.cuda.empty_cache()
    # c. mnistnet: 2 dense + 2 sparse steps
    trainer, _, launches, err, _ = _zoo_run("mnistnet", 4)
    out["launches"]["mnistnet"] = launches["fused_ef_select"]
    out["err"] = max(out["err"], err)
    del trainer
    torch.cuda.empty_cache()
    print(f"phase zoo: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------- phase 15: the default-on runtime

# config 2 at full width on the CIFAR-10 files phase 15 writes
RUNTIME_ARGV = ["--compressor", "gaussian_fused", "--compress-warmup-steps",
                "2", "--eval-every-epochs", "0", "--save-every-epochs", "0"]


def _write_cifar10(root: str, n_train: int, n_test: int, seed: int) -> str:
    """CIFAR-10's binary files from a seed: ``data_batch_1..5.bin`` of
    ``n_train`` records and ``test_batch.bin`` of ``n_test`` (a label byte,
    then 3 x 32 x 32 channel-major pixels)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name, n in [(f"data_batch_{i}.bin", n_train) for i in range(1, 6)] + [
            ("test_batch.bin", n_test)]:
        recs = np.empty((n, 3073), np.uint8)
        recs[:, 0] = rng.integers(0, 10, n)
        recs[:, 1:] = rng.integers(0, 256, (n, 3072))
        recs.tofile(os.path.join(root, name))
    return root


@contextlib.contextmanager
def _b1_checked():
    """While active, every B1 call (the kernel's wrapper, as the compressor
    calls it) is held at once against the plain version on the same inputs,
    bit for bit; the plain version launches no kernel. Yields ``{"calls",
    "err", "shapes"}`` (the set of input shapes seen)."""
    import numpy as np
    from gaussiank_sgd_torch.ops import fused_select as fs
    real = fs.fused_ef_select_candidates_chunked
    seen = {"calls": 0, "err": 0.0, "shapes": set()}

    def checked(res2d, g2d, scale, thresholds, density):
        out = real(res2d, g2d, scale, thresholds, density)
        plain = fs.fused_ef_select_plain(res2d, g2d, float(np.float32(scale)),
                                         thresholds, density)
        seen["err"] = max(seen["err"], _same(out, plain,
                                             f"B1 call {seen['calls']}"))
        seen["calls"] += 1
        seen["shapes"].add(tuple(res2d.shape))
        return out

    fs.fused_ef_select_candidates_chunked = checked
    try:
        yield seen
    finally:
        fs.fused_ef_select_candidates_chunked = real


@contextlib.contextmanager
def _b2_checked():
    """``_b1_checked`` for B2: while active, every B2 call is held at once
    against the plain version on the same inputs, bit for bit. Yields
    ``{"calls", "err", "shapes"}``."""
    from gaussiank_sgd_torch.ops import fused_select as fs
    real = fs.fused_select_candidates_chunked
    seen = {"calls": 0, "err": 0.0, "shapes": set()}

    def checked(x2d, thresholds, density):
        out = real(x2d, thresholds, density)
        seen["err"] = max(seen["err"], _same(
            out, fs.fused_select_plain(x2d, thresholds, density),
            f"B2 call {seen['calls']}"))
        seen["calls"] += 1
        seen["shapes"].add(tuple(x2d.shape))
        return out

    fs.fused_select_candidates_chunked = checked
    try:
        yield seen
    finally:
        fs.fused_select_candidates_chunked = real


def _full_state(trainer) -> dict:
    """Every tensor of the training state, cloned: params, optimizer state,
    EF row, thresholds, BatchNorm statistics, dropout generator, step."""
    import torch
    st = trainer.state
    return {"params": st.params.detach().clone(),
            **{f"opt {k}": v.clone() for k, v in st.opt_state.items()},
            "EF row": st.ef_residual.clone(),
            "thresholds": st.comp_state.clone(),
            "stats": trainer.model.stats.clone(),
            "dropout generator": trainer.model.dropout_generator.get_state(),
            "step": torch.tensor(st.step)}


def _differing(a: dict, b: dict) -> list:
    return [key for key in a if not _equal_bits((a[key], b[key]))]


def _rollback_phase(tmp: str, data: str, fold_lr: bool) -> dict:
    """Phase 15a: config 2 (``gaussian_fused``) on the files with
    ``--save-every-steps 2 --max-consecutive-skips 2 --log-every 1``, NaN
    batches at steps 5 and 6 (``inject_nan_batches``, once): two guard
    skips, one rollback to the checkpoint of step 4, the restored state that
    step's bit for bit, the EF invariant of a sparse step from the restored
    row, ``lr_scale`` 0.5; steps 5-8 then equal a fresh trainer's resumed
    from that checkpoint at lr x 0.5, bit for bit. With ``fold_lr`` B1
    runs at ``scale = lr(step)`` (x 0.5 after the rollback)."""
    import torch
    from gaussiank_sgd_torch.data.cifar import CifarPipeline
    from gaussiank_sgd_torch.training import chaos
    tag = "fold-lr" if fold_lr else "flat"
    argv = [*RUNTIME_ARGV, "--data-dir", data, "--max-steps", "8",
            "--save-every-steps", "2", "--max-consecutive-skips", "2",
            "--log-every", "1", *(["--fold-lr"] if fold_lr else [])]
    trainer = _config(CONFIG2, argv, f"rollback_{tag}", tmp)
    if not isinstance(trainer.train_ds, CifarPipeline):
        raise AssertionError(f"15a: data {type(trainer.train_ds).__name__}")
    chaos.inject_nan_batches(trainer, {4, 5})
    at4, seen = {}, {}
    rollback = trainer._rollback

    def checked_rollback(reason):
        rollback(reason)
        seen["restored"] = _full_state(trainer)
        gen = trainer.model.dropout_generator.get_state()
        seen["nsel"] = _ef_invariant(trainer, f"15a {tag} restored row")
        # the check drew a batch and dropout masks: back to the step
        trainer.model.dropout_generator.set_state(gen)
        trainer._invalidate_data_iter()

    trainer._rollback = checked_rollback
    scales = []
    _reset_launches()
    with _b1_checked() as b1:
        while trainer.step < trainer.total_steps:
            scales.append(trainer.ts.scale(trainer.step))
            trainer.train(1)
            if trainer.step == 4 and not at4:
                at4.update(_full_state(trainer))
        torch.cuda.synchronize()
        launches = _launches()
    events = _events(trainer)
    skips = [e["step"] for e in events if e["event"] == "skip"]
    rbs = [e for e in events if e["event"] == "rollback"]
    if skips != [5, 6] or len(rbs) != 1 or (
            rbs[0]["reason"], rbs[0]["to_step"], rbs[0]["lr_scale"]) != (
            "skip_budget", 4, 0.5):
        raise AssertionError(f"15a {tag}: skips {skips}, rollbacks {rbs}")
    bad = _differing(seen["restored"], at4)
    if bad:
        raise AssertionError(f"15a {tag}: restored {bad} differ from step "
                             f"4's")
    sparse = 8        # steps 3-6, then 5-8 again
    if (launches["fused_ef_select"] != sparse + 1
            or b1["calls"] != sparse + 1):
        raise AssertionError(f"15a {tag}: launches {launches}, B1 checked "
                             f"{b1['calls']} times")
    after = trainer.records[-4:]
    want = _full_state(trainer)
    lr = trainer.cfg.lr
    del trainer
    fresh = _config(CONFIG2, [
        *argv, "--resume", os.path.join(tmp, f"rollback_{tag}", "ckpt",
                                        "step_00000004"),
        "--lr", repr(lr * 0.5)], f"fresh_{tag}", tmp)
    with _b1_checked() as b1_fresh:
        fresh.train(4)
    got = fresh.records
    if ([(r["step"], r["loss"]) for r in got]
            != [(r["step"], r["loss"]) for r in after]):
        raise AssertionError(f"15a {tag}: after the rollback {after}, the "
                             f"fresh trainer at lr/2 {got}")
    bad = _differing(_full_state(fresh), want)
    if bad:
        raise AssertionError(f"15a {tag}: at step 8 {bad} differ from the "
                             f"fresh trainer's")
    del fresh
    torch.cuda.empty_cache()
    print(f"phase runtime rollback {tag}: config 2 on CIFAR files "
          f"(CifarPipeline), NaN batches at steps 5-6: guard skips {skips}, "
          f"one rollback (skip_budget) to step 4, lr_scale 0.5; the restored "
          f"params, optimizer state, EF row, thresholds, statistics and "
          f"dropout generator equal step 4's bit for bit; EF invariant exact "
          f"on a sparse step from the restored row (num_selected "
          f"{seen['nsel']}); B1 {launches['fused_ef_select']} launches, "
          f"each bit-identical to its plain version, at scales "
          f"{[round(s, 6) for s in scales[2:]]}; steps 5-8 after it equal a "
          f"fresh trainer resumed from step 4 at lr {lr * 0.5} bit for bit "
          f"(losses {[round(r['loss'], 6) for r in after]}; its "
          f"{b1_fresh['calls']} B1 calls checked too)")
    return {"launches": launches["fused_ef_select"],
            "err": max(b1["err"], b1_fresh["err"])}


def _preempt_phase(tmp: str, data: str) -> dict:
    """Phase 15b: a child ``python -m gaussiank_sgd_torch.train`` at config
    2 on the files, sent SIGTERM once its metrics show a sparse step: it
    exits 0 with one ``preempt`` event and a checkpoint sealed at that step
    boundary; resumed here to step 40, its final state (params, momentum,
    EF row, thresholds, statistics, step) equals an uninterrupted run's bit
    for bit."""
    import torch
    from gaussiank_sgd_torch.training import checkpoint as ck
    argv = [*RUNTIME_ARGV, "--data-dir", data, "--max-steps", "40"]
    cli = ["--config", CONFIG2, "--nworkers", "1", *argv, "--output-dir",
           tmp, "--run-id", "preempt"]
    metrics = os.path.join(tmp, "preempt", "metrics.jsonl")
    steps = os.path.join(tmp, "preempt", "steps.jsonl")
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-m",
                              "gaussiank_sgd_torch.train", *cli], cwd=REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    sent = None
    try:
        while child.poll() is None and time.perf_counter() - t0 < 300:
            if (os.path.exists(steps)
                    and '"kind": "sparse"' in open(steps).read()):
                child.send_signal(signal.SIGTERM)
                sent = time.perf_counter() - t0
                break
            time.sleep(0.005)
        out, _ = child.communicate(timeout=300)
    finally:
        child.kill()
        child.wait()
    wall = time.perf_counter() - t0
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    pre = [e for e in events if e.get("event") == "preempt"]
    if child.returncode != 0 or sent is None or len(pre) != 1:
        raise AssertionError(f"15b: exit {child.returncode}, SIGTERM at "
                             f"{sent}, preempt events {pre}; "
                             f"{out[-3000:]}")
    stop = pre[0]["step"]
    with open(steps) as f:
        last = max(json.loads(line)["step"] for line in f)
    if (last != stop or not pre[0]["checkpoint"].endswith(
            f"step_{stop:08d}") or not ck.is_committed(pre[0]["checkpoint"])):
        raise AssertionError(f"15b: preempt {pre}, last step {last}")
    with _b1_checked() as b1:
        _reset_launches()
        resumed = _config(CONFIG2, [*argv, "--resume",
                                    os.path.join(tmp, "preempt", "ckpt")],
                          "preempt", tmp)
        if resumed.step != stop:
            raise AssertionError(f"15b: resumed at {resumed.step}, not {stop}")
        resumed.fit()
        resumed.close()
        got = _full_state(resumed)
        del resumed
        clean = _config(CONFIG2, argv, "clean", tmp)
        clean.fit()
        clean.close()
        want = _full_state(clean)
        del clean
        torch.cuda.synchronize()
        launches = _launches()
    # the dropout generator of a run that stopped differs (its saved state
    # is restored, then drawn 40 - stop more times): compare it too
    bad = _differing(got, want)
    if bad:
        raise AssertionError(f"15b: after the resume {bad} differ from the "
                             f"uninterrupted run at step 40")
    if launches["fused_ef_select"] != b1["calls"] or b1["calls"] != (
            40 - stop) + 38:
        raise AssertionError(f"15b: launches {launches}, B1 checked "
                             f"{b1['calls']}")
    torch.cuda.empty_cache()
    print(f"phase runtime preempt: child train.py at config 2 sent SIGTERM "
          f"{sent:.1f} s after its start, at its first sparse step line; "
          f"exit 0 after {wall:.1f} s with one preempt event at step {stop} "
          f"and a sealed checkpoint there; resumed to step 40 here, the "
          f"params, momentum, EF row, thresholds, statistics, dropout "
          f"generator and step equal the uninterrupted run's bit for bit; "
          f"B1 {launches['fused_ef_select']} launches in the two runs here, "
          f"each bit-identical to its plain version")
    return {"launches": launches["fused_ef_select"], "err": b1["err"]}


def _loader_phase(tmp: str, data: str) -> dict:
    """Phase 15c: config 2 on the files fed by ``FlakyEpochSource`` (one
    ``TransientIOError`` at batch 3) through the prefetch thread: one
    ``io_retry`` event and the clean stream's batches bit for bit; then
    config 3 (ResNet-50, batch 64, 224^2 uint8) for 2 dense + 4 sparse steps
    through the prefetching loader, each step's wall ms, then 3 more sparse
    steps traced by ``--profile-steps 6 9``: the trace's busy share."""
    import torch
    from torch.autograd import DeviceType
    from gaussiank_sgd_torch.data import EpochStream
    from gaussiank_sgd_torch.training import chaos
    trainer = _config(CONFIG2, [*RUNTIME_ARGV, "--data-dir", data,
                                "--max-steps", "8", "--io-backoff-s",
                                "0.01"], "flaky", tmp)
    clean = EpochStream(trainer.train_ds, trainer.cfg.seed, 0)
    trainer.train_ds = chaos.FlakyEpochSource(trainer.train_ds,
                                              fail_batches=[3])
    for i in range(6):
        x, y = trainer.next_batch()
        cx, cy = next(clean)
        if not (x.device.type == trainer.device.type
                and torch.equal(x.cpu(), torch.from_numpy(cx))
                and torch.equal(y.cpu(), torch.from_numpy(cy))):
            raise AssertionError(f"15c: flaky batch {i} differs from the "
                                 f"clean stream's")
    retries = [e for e in _events(trainer) if e["event"] == "io_retry"]
    if trainer.train_ds.raised != 1 or [r["attempt"] for r in retries] != [1]:
        raise AssertionError(f"15c: retries {retries}")
    trainer.close()
    del trainer
    print(f"phase runtime loader retry: config 2's stream with one "
          f"TransientIOError at batch 3: one io_retry event "
          f"({retries[0]['error']}), 6 batches on the card (pinned, "
          f"non-blocking copies) equal to the clean stream's bit for bit")

    torch.cuda.empty_cache()
    trainer = _config(CONFIG3, ["--compressor", "gaussian_fused",
                                "--compress-warmup-steps", "2",
                                "--max-steps", "9", "--profile-steps", "6",
                                "9", "--log-every", "100"],
                      "config3_loader", tmp)
    wall = []
    _reset_launches()
    with _b1_checked() as b1:
        for _ in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = trainer.train(1)
            wall.append((time.perf_counter() - t0) * 1e3)
        trainer.close()
        torch.cuda.synchronize()
        launches = _launches()
    prof = trainer.profiler
    events = [(e["action"], e["step"]) for e in _events(trainer)
              if e["event"] == "profile"]
    device_ms = sum(e.self_device_time_total for e in prof.last.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    if (events != [("start", 6), ("stop", 9)] or not os.path.exists(prof.path)
            or launches["fused_ef_select"] != 7 or b1["calls"] != 7):
        raise AssertionError(f"15c config 3: profile events {events}, trace "
                             f"{prof.path}, launches {launches}")
    busy = device_ms / (prof.wall_s * 1e3)
    sparse = wall[3:6]
    print(f"phase runtime loader config3: ResNet-50 through the prefetching "
          f"loader, wall ms a step {[round(v, 2) for v in wall]} (steps 1-2 "
          f"dense, 3 the cold sparse one, 7-9 traced); steps 4-6 "
          f"{statistics.mean(sparse):.2f} ms a step (median "
          f"{statistics.median(sparse):.2f}); the last step's io (the "
          f"wait for its batch and its copy to the card) "
          f"{rec['io_s'] * 1e3:.3f} ms and step {rec['step_s'] * 1e3:.2f} "
          f"ms; trace of steps 7-9 "
          f"({os.path.basename(prof.path)}, "
          f"{os.path.getsize(prof.path)} bytes): {prof.wall_s * 1e3:.2f} ms "
          f"wall, {device_ms:.2f} ms device time, {busy:.1%} busy; B1 "
          f"{launches['fused_ef_select']} launches, each bit-identical to "
          f"its plain version")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches["fused_ef_select"], "err": b1["err"]}


def _real_cifar_phase(tmp: str, data: str) -> dict:
    """Phase 15d: ``make_cifar`` serves ``CifarPipeline`` on the files (the
    native library built), and config 2 with ``label_noise`` 0.1 trains 2
    dense + 2 sparse steps on them: every batch it fed (after the pinned
    copy) equals the CPU replay of the same stream bit for bit, labels
    flipped where the replay flips them."""
    import numpy as np
    import torch
    from gaussiank_sgd_torch.data import EpochStream, make_dataset, native
    from gaussiank_sgd_torch.data.cifar import CifarPipeline
    if not native.available():
        raise AssertionError("15d: the native library is not available")
    trainer = _config(CONFIG2, [*RUNTIME_ARGV, "--data-dir", data,
                                "--max-steps", "4", "--dataset-kwargs",
                                json.dumps({"label_noise": 0.1})],
                      "real_cifar", tmp)
    if not isinstance(trainer.train_ds, CifarPipeline):
        raise AssertionError(f"15d: {type(trainer.train_ds).__name__}")
    fed = []
    ts = trainer.ts
    for name in ("dense_step", "sparse_step"):
        def noted(state, batch, real=getattr(ts, name)):
            fed.append(tuple(t.cpu() for t in batch))
            return real(state, batch)
        setattr(ts, name, noted)
    _reset_launches()
    with _b1_checked() as b1:
        records = _steps(trainer)
        torch.cuda.synchronize()
        launches = _launches()
    trainer.close()
    kw = dict(train=True, batch_size=128)
    replay = EpochStream(make_dataset("cifar10", data, label_noise=0.1,
                                      **kw)[0], trainer.cfg.seed, 0)
    plain = EpochStream(make_dataset("cifar10", data, **kw)[0],
                        trainer.cfg.seed, 0)
    flipped = 0
    for i, (x, y) in enumerate(fed):
        rx, ry = next(replay)
        _, py = next(plain)
        if not (torch.equal(x, torch.from_numpy(rx))
                and torch.equal(y, torch.from_numpy(ry))):
            raise AssertionError(f"15d: batch {i} differs from the CPU "
                                 f"replay")
        flipped += int(np.sum(ry != py))
    if (len(fed) != 4 or not flipped or launches["fused_ef_select"] != 2
            or b1["calls"] != 2):
        raise AssertionError(f"15d: {len(fed)} batches, {flipped} flipped "
                             f"labels, launches {launches}")
    del trainer
    torch.cuda.empty_cache()
    print(f"phase runtime real cifar: 5 x 256 + 256 records written; "
          f"native library loaded, make_cifar serves CifarPipeline; config 2 "
          f"(label_noise 0.1) 2 dense + 2 sparse steps, losses "
          f"{[round(r['loss'], 4) for r in records]}; its 4 batches equal "
          f"the CPU replay bit for bit, {flipped} of 512 labels flipped as "
          f"the replay flips them; B1 {launches['fused_ef_select']} "
          f"launches, each bit-identical to its plain version")
    return {"launches": launches["fused_ef_select"], "err": b1["err"]}


def _runtime_phase() -> dict:
    """Phase 15: the default-on runtime at config 2 and config 3's full
    width (15a-15d); returns B1's launches and error on each part."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    try:
        data = _write_cifar10(os.path.join(tmp, "data"), 256, 256, seed=15)
        out = {"rollback": _rollback_phase(tmp, data, fold_lr=False),
               "rollback_fold_lr": _rollback_phase(tmp, data, fold_lr=True),
               "preempt": _preempt_phase(tmp, data),
               "loader": _loader_phase(tmp, data),
               "real_cifar": _real_cifar_phase(tmp, data)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase runtime: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------- phase 16: the step's instruments and its schedule

# config 2's plan of 4,194,304-element chunks (16b, 16d): 4 chunks, the
# legacy wire, B1 at [4, chunk] on the sequential step, [1, chunk] a chunk
# on the pipelined one; k a chunk 4,195, total_k 16,780
# phase 16's rotated rounds a bench_model/bench_overlap call (8 before
# phase 21 took its share of the script's time)
BENCH_ROUNDS = 4
BIG_CHUNK = 1 << 22
BIG_PLAN = ["--bucket-size", str(BIG_CHUNK), "--bucket-policy", "uniform"]
BIG_WANT = {"n_buckets": 4, "total_k": 16_780, "bytes_sent": 134_240,
            "overlapped_bytes_sent": 100_680, "wire": "i32f32"}
# the uniform 65,536 plan (16c): 229 chunks, the packed wire
SMALL_WANT = {"n_buckets": 229, "bytes_sent": 60_456,
              "overlapped_bytes_sent": 60_192}
# a uniform plan the fused-EF gate refuses (chunks not block-aligned): the
# unfused step, gaussian_fused's batched call (B2) a chunk when pipelined
UNALIGNED_PLAN = ["--bucket-size", "4000000", "--bucket-policy", "uniform"]


def _bench_cell(out: dict, arms: list, name: str, peak_line: str) -> dict:
    """Print a ``bench_model`` cell: each program's min and median ms a
    step, each sparse arm's paired and noise-floored delta against dense
    (and ``gaussian_fused`` against ``ef_only``), sparse / dense (the
    paired median of the per-round ratio, and min over min), bytes_sent,
    and MFU; return the same numbers."""
    from gaussiank_sgd_torch import benchlib
    rounds = out["_rounds"]
    cell = {"programs": {}, "deltas": {}, "exchange": out["_exchange"],
            "dense_step_flops": out["_dense_step_flops"],
            "peak_flops": out["_peak_flops"]}
    for prog in ["dense"] + arms:
        ms = [1e3 * t for t in rounds[prog]]
        cell["programs"][prog] = {
            "min_ms": min(ms), "median_ms": statistics.median(ms),
            "mfu": benchlib.mfu(out["_dense_step_flops"], out[prog],
                                out["_peak_flops"])}
    pairs = [(a, "dense") for a in arms]
    if "ef_only" in arms and "gaussian_fused" in arms:
        pairs.append(("gaussian_fused", "ef_only"))
    for a, b in pairs:
        cell["deltas"][f"{a}-{b}"] = {
            "paired_ms": benchlib.paired_delta_ms(rounds, a, b),
            "floored_ms": benchlib.noise_floored_delta_ms(rounds, a, b)}
    for a in arms:
        ratios = [x / y for x, y in zip(rounds[a], rounds["dense"])]
        cell["programs"][a]["sparse_over_dense"] = statistics.median(ratios)
        cell["programs"][a]["min_over_min"] = out[a] / out["dense"]
    for prog, v in cell["programs"].items():
        extra = (f", sparse / dense {v['sparse_over_dense']:.4f} (paired "
                 f"median of {len(rounds[prog])} rounds; min / min "
                 f"{v['min_over_min']:.4f}), bytes_sent "
                 f"{out['_exchange'][prog]['bytes_sent']} B "
                 f"({out['_exchange'][prog]['wire_format']})"
                 if prog != "dense" else "")
        mfu = (f"{v['mfu']:.4f}" if v["mfu"] is not None else "not measured")
        print(f"phase bench {name} {prog}: min {v['min_ms']:.3f} ms, median "
              f"{v['median_ms']:.3f} ms a step; MFU {mfu}{extra}")
    for key, v in cell["deltas"].items():
        floored = ("< noise" if v["floored_ms"] is None
                   else f"{v['floored_ms']} ms")
        print(f"phase bench {name} {key}: paired delta {v['paired_ms']} ms, "
              f"noise-floored {floored}")
    print(f"phase bench {name}: dense step FLOPs {out['_dense_step_flops']}"
          f" (FlopCounterMode: matmuls and convolutions), peak "
          f"{out['_peak_flops']} FLOP/s (bf16 dense); {peak_line}")
    return cell


def _two_schedules(flags: list, steps: list, what: str, launches_want,
                   checked: bool = True):
    """Config 2 with ``flags`` through ``Trainer`` under ``--overlap off``
    then ``auto``, launch counts zeroed before each run and read after;
    with ``checked`` every B1 and B2 call is held against its plain
    version as it runs (which adds the plain version and host reads to each
    step's time): ``{overlap: (trainer, records, last log record,
    launches, B1 check, B2 check)}``. The states must be bit for bit equal;
    ``launches_want(overlap, n_sparse)`` gives the expected counts."""
    import torch
    out = {}
    for overlap in ("off", "auto"):
        trainer = _config(CONFIG2, ["--compressor", "gaussian_fused",
                                    *flags, "--overlap", overlap, *steps],
                          f"{what}_{overlap}")
        _reset_launches()
        with contextlib.ExitStack() as stack:
            b1, b2 = ((stack.enter_context(_b1_checked()),
                       stack.enter_context(_b2_checked())) if checked
                      else ({"calls": 0, "err": 0.0, "shapes": set()},
                            {"calls": 0, "err": 0.0, "shapes": set()}))
            rec = trainer.train(trainer.total_steps)
        torch.cuda.synchronize()
        launches = _launches()
        records = trainer.records
        n_sparse = sum(r["kind"] == "sparse" for r in records)
        want = launches_want(overlap, n_sparse)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{what} overlap={overlap}: launches {got},"
                                 f" want {want}")
        if not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"{what}: non-finite loss {records}")
        out[overlap] = (trainer, records, rec, launches, b1, b2)
    (t_off, r_off, *_), (t_on, r_on, *_) = out["off"], out["auto"]
    bad = _differing(_full_state(t_off), _full_state(t_on))
    if bad or [r["loss"] for r in r_off] != [r["loss"] for r in r_on]:
        raise AssertionError(f"{what}: the schedules differ in {bad} or the "
                             f"losses")
    return out


def _bench_worker(rank: int, world: int, d: str) -> int:
    """One rank of phase 16d: config 2 on the 4-chunk plan, both
    schedules, 1 dense + 2 sparse steps each; a hash of the parameters
    after every step."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.parallel import mesh
    mesh.init_distributed("cuda:0", rank, world,
                          "file://" + os.path.join(d, "store"),
                          backend="gloo")
    out = {}
    for overlap in ("off", "auto"):
        trainer = _config(CONFIG2, ["--compressor", "gaussian_fused",
                                    "--nworkers", str(world), "--overlap",
                                    overlap, "--max-steps", "3",
                                    "--compress-warmup-steps", "1",
                                    *BIG_PLAN], f"bench_workers_{rank}")
        _reset_launches()
        hashes, losses = [], []
        for _ in range(3):
            trainer.train(1)
            params = trainer.state.params.detach().cpu().numpy()
            hashes.append(hashlib.sha256(params.tobytes()).hexdigest())
            losses.append(trainer.records[-1]["loss"])
        torch.cuda.synchronize()
        out[overlap] = {"hashes": hashes, "losses": losses,
                        "overlap": trainer.ts.overlap,
                        "b1": _launches()["fused_ef_select"],
                        "step_ms": [r["step_ms"] for r in trainer.records],
                        "bytes_sent": trainer.records[-1]["bytes_sent"]}
        del trainer
        torch.cuda.empty_cache()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _bench_workers_phase() -> dict:
    """Phase 16d: two gloo ranks on this card, both schedules at the
    4-chunk plan; each rank bit for bit equal to the other and to its
    sequential run."""
    d = os.path.join(RUN_DIR, "bench_workers")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--bench-worker", str(r), "2", d],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"bench workers: rank {r} exited "
                                 f"{p.returncode}: {err[-3000:]}")
    res = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    for r, rr in enumerate(res):
        off, on = rr["off"], rr["auto"]
        if (off["hashes"] != on["hashes"] or off["losses"] != on["losses"]
                or on["hashes"] != res[0]["auto"]["hashes"]):
            raise AssertionError(f"bench workers: rank {r} differs: {res}")
        if ((off["overlap"], on["overlap"]) != ("off", "pipelined")
                or (off["b1"], on["b1"]) != (2, 2 * BIG_WANT["n_buckets"])
                or on["bytes_sent"] != BIG_WANT["bytes_sent"]):
            raise AssertionError(f"bench workers: rank {r}: {rr}")
    first = res[0]
    print(f"phase bench two workers: gloo group of 2 on this card (CUDA "
          f"tensors), config 2 on the {BIG_WANT['n_buckets']}-chunk plan, 1 "
          f"dense + 2 sparse steps a schedule: parameters bit-identical "
          f"pipelined vs sequential and across both ranks after every step "
          f"(sha256 {[h[:12] for h in first['auto']['hashes']]}), B1 "
          f"{first['off']['b1']} / {first['auto']['b1']} launches a rank, "
          f"rank 0's step ms sequential "
          f"{[round(v, 1) for v in first['off']['step_ms']]}, pipelined "
          f"{[round(v, 1) for v in first['auto']['step_ms']]}; "
          f"{time.perf_counter() - t0:.1f} s with the processes' start")
    return {"b1": [rr[o]["b1"] for rr in res for o in ("off", "auto")]}


def _bench_phase(mem_rate: float) -> dict:
    """Phase 16: the bench harness, the pipelined schedule and the
    instruments; returns each kernel's launches on the phase and B1's
    times at the two new shapes."""
    import torch
    import torch.distributed as dist
    from gaussiank_sgd_torch import benchlib
    from gaussiank_sgd_torch.ops import fused_select as fs
    from gaussiank_sgd_torch.parallel import collectives, mesh
    t_phase = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    launches, out = {}, {}

    def counted(key, fn):
        _reset_launches()
        result = fn()
        torch.cuda.synchronize()
        launches[key] = _launches()
        return result

    # 16a. dense and sparse programs in paired rotated rounds
    arms2 = ["gaussian_fused", "gaussian_pallas", "ef_only"]
    c2 = counted("16a config2", lambda: benchlib.bench_model(
        "vgg16", "cifar10", 128, 0.001, arms2, 10, rounds=BENCH_ROUNDS))
    out["config2"] = _bench_cell(c2, arms2, "config2", card)
    torch.cuda.empty_cache()
    c3 = counted("16a config3", lambda: benchlib.bench_model(
        "resnet50", "imagenet", 64, 0.001, ["gaussian_fused"], 10,
        rounds=BENCH_ROUNDS))
    out["config3"] = _bench_cell(c3, ["gaussian_fused"], "config3", card)
    torch.cuda.empty_cache()

    # 16b. both schedules and their twins in an NCCL group of one
    os.makedirs(RUN_DIR, exist_ok=True)
    store = os.path.join(RUN_DIR, "nccl_store_bench")
    if os.path.exists(store):
        os.remove(store)
    dev = torch.device("cuda")
    mesh.init_distributed(dev, 0, 1, "file://" + store)
    if ((dist.get_backend(), collectives.world_size())
            != (mesh.backend_for(dev), 1)):
        raise AssertionError(f"group {dist.get_backend()} of "
                             f"{collectives.world_size()}")
    ov = counted("16b bench_overlap", lambda: benchlib.bench_overlap(
        "vgg16", "cifar10", 128, 0.001, "gaussian_fused", 10,
        rounds=BENCH_ROUNDS,
        bucket_size=BIG_CHUNK))
    meta = ov["_meta"]
    want = {"pipe_overlap": "pipelined", "seq_overlap": "off",
            "n_buckets": BIG_WANT["n_buckets"],
            "total_k": BIG_WANT["total_k"],
            "wire_format": BIG_WANT["wire"],
            "seq_bytes_sent": BIG_WANT["bytes_sent"],
            "pipe_bytes_sent": BIG_WANT["bytes_sent"],
            "overlapped_bytes_sent": BIG_WANT["overlapped_bytes_sent"]}
    got = {key: meta[key] for key in want}
    if got != want:
        raise AssertionError(f"bench_overlap meta {got}, want {want}")
    exposed = ov["exposed_exchange_ms"]
    print(f"phase bench overlap: config 2, {meta['n_buckets']} chunks of "
          f"{BIG_CHUNK} (k {meta['total_k']}, wire {meta['wire_format']}), "
          f"NCCL group of one, 10 steps a run, {BENCH_ROUNDS} rounds: "
          + ", ".join(
              f"{p} min {1e3 * ov[p]:.3f} / median "
              f"{1e3 * statistics.median(ov['_rounds'][p]):.3f} ms"
              for p in ("seq", "seq_noexch", "pipe", "pipe_noexch"))
          + f"; bytes_sent {meta['seq_bytes_sent']} B on both, overlapped "
          f"{meta['overlapped_bytes_sent']} B; exposed_exchange_ms seq "
          f"{exposed['seq'] if exposed['seq'] is not None else '< noise'}, "
          f"pipe "
          f"{exposed['pipe'] if exposed['pipe'] is not None else '< noise'}"
          f" (a world of one has no link: < noise is the expected answer); "
          f"{card}")
    out["overlap"] = {p: 1e3 * ov[p] for p in ("seq", "seq_noexch", "pipe",
                                               "pipe_noexch")}
    out["overlap"]["exposed_exchange_ms"] = exposed

    def b1_per_step(chunks):
        return lambda overlap, n: {"fused_ef_select": n * (
            chunks if overlap == "auto" else 1)}

    big = _two_schedules(BIG_PLAN, ["--compress-warmup-steps", "0",
                                    "--max-steps", "3"], "bench_big",
                         b1_per_step(BIG_WANT["n_buckets"]))
    launches.update({f"16b {o}": v[3] for o, v in big.items()})
    shapes = {o: sorted(v[4]["shapes"]) for o, v in big.items()}
    if shapes != {"off": [(BIG_WANT["n_buckets"], BIG_CHUNK)],
                  "auto": [(1, BIG_CHUNK)]}:
        raise AssertionError(f"B1 shapes {shapes}")
    errs = {"b1": max(v[4]["err"] for v in big.values()),
            "b2": max(v[5]["err"] for v in big.values())}
    print(f"phase bench schedules 4 chunks: 3 sparse steps a schedule from "
          f"one seed, params, momentum, EF row, thresholds, statistics and "
          f"dropout generator bit for bit; B1 "
          f"{big['off'][3]['fused_ef_select']} launches at "
          f"[{BIG_WANT['n_buckets']}, {BIG_CHUNK}] "
          f"sequentially, {big['auto'][3]['fused_ef_select']} at [1, "
          f"{BIG_CHUNK}] pipelined, each bit-identical to its plain version; "
          f"sparse step ms sequential "
          f"{[round(r['step_ms'], 2) for r in big['off'][1]]}, pipelined "
          f"{[round(r['step_ms'], 2) for r in big['auto'][1]]} (with every "
          f"B1 call checked)")
    trainer = big["off"][0]
    res = trainer.state.ef_residual.view(BIG_WANT["n_buckets"], BIG_CHUNK)
    grads = trainer.ts.local_grads(trainer.state, trainer.next_batch())
    g = grads.flat_g.view(BIG_WANT["n_buckets"], BIG_CHUNK)
    t = trainer.state.comp_state[0].contiguous()
    nc = fs._chunk_geometry(BIG_CHUNK, 0.001)[3]
    b1_times = {}
    for rows in (BIG_WANT["n_buckets"], 1):
        r_, g_, t_ = res[:rows], g[:rows], t[:rows]
        errs["b1"] = max(errs["b1"], _same(
            fs.fused_ef_select_candidates_chunked(r_, g_, 1.0, t_, 0.001),
            fs.fused_ef_select_plain(r_, g_, 1.0, t_, 0.001),
            f"B1 [{rows}, {BIG_CHUNK}]"))
        b1_times[f"{rows}x{BIG_CHUNK}"] = _time_kernel(
            f"B1 [{rows}, {BIG_CHUNK}]",
            lambda r_=r_, g_=g_, t_=t_: fs.fused_ef_select_candidates_chunked(
                r_, g_, 1.0, t_, 0.001),
            lambda r_=r_, g_=g_, t_=t_: fs.fused_ef_select_plain(
                r_, g_, 1.0, t_, 0.001),
            _bound_ms(3 * rows * BIG_CHUNK * 4 + rows * nc * 8 + rows * 8,
                      _OPS_SELECT * rows * BIG_CHUNK, mem_rate))
    del big, trainer, res, grads, g, t
    torch.cuda.empty_cache()

    # 16c. the uniform 65,536 plan (229 chunks) on both schedules, and a
    # plan the fused-EF gate refuses (B2 a chunk). First one sparse step a
    # schedule with every B1 call held against its plain version, then
    # three unchecked, for their times.
    n_small = SMALL_WANT["n_buckets"]
    held = _two_schedules(PLANS["uniform 65536"], WARMUP_2 + ["3"],
                          "bench_229_checked", b1_per_step(n_small))
    launches.update({f"16c 229 chunks checked {o}": v[3]
                     for o, v in held.items()})
    shapes = {o: sorted(v[4]["shapes"]) for o, v in held.items()}
    if shapes != {"off": [(n_small, 65_536)], "auto": [(1, 65_536)]}:
        raise AssertionError(f"229 chunks: B1 shapes {shapes}")
    errs["b1"] = max([errs["b1"]] + [v[4]["err"] for v in held.values()])
    print(f"phase bench schedules 229 chunks checked: 1 sparse step a "
          f"schedule, states bit for bit; B1 {held['off'][4]['calls']} "
          f"call at [{n_small}, 65536] sequentially, "
          f"{held['auto'][4]['calls']} at [1, 65536] pipelined, each "
          f"bit-identical to its plain version")
    del held
    torch.cuda.empty_cache()
    small = _two_schedules(PLANS["uniform 65536"], WARMUP_2 + ["5"],
                           "bench_229", b1_per_step(n_small), checked=False)
    launches.update({f"16c 229 chunks {o}": v[3] for o, v in small.items()})
    for overlap, name in (("off", "off"), ("auto", "pipelined")):
        rec = small[overlap][2]
        if rec.get("overlap") != name or rec["bytes_sent"] != SMALL_WANT[
                "bytes_sent"] or rec.get("overlapped_bytes_sent") != (
                SMALL_WANT["overlapped_bytes_sent"] if name != "off"
                else None):
            raise AssertionError(f"229 chunks overlap={overlap}: {rec}")
    ms = {o: [r["step_ms"] for r in v[1] if r["kind"] == "sparse"]
          for o, v in small.items()}
    print(f"phase bench schedules 229 chunks: config 2 on the uniform "
          f"65,536 plan, 2 dense + 3 sparse steps a schedule, records "
          f"overlap \"off\" / \"pipelined\", bytes_sent "
          f"{SMALL_WANT['bytes_sent']}, overlapped_bytes_sent "
          f"{SMALL_WANT['overlapped_bytes_sent']}; states bit for bit; B1 "
          f"{small['off'][3]['fused_ef_select']} / "
          f"{small['auto'][3]['fused_ef_select']} launches; sparse step ms "
          f"sequential {[round(v, 2) for v in ms['off']]}, pipelined "
          f"{[round(v, 2) for v in ms['auto']]} (the pipelined step pays 229 "
          f"B1 launches and 229 all-gather calls where the sequential pays "
          f"one each; a world of one hides nothing; no call checked)")
    out["schedules_229"] = ms
    del small
    torch.cuda.empty_cache()
    b2 = _two_schedules(
        UNALIGNED_PLAN, WARMUP_2 + ["4"], "bench_unaligned",
        lambda overlap, n: {"fused_ef_select": 0,
                            "fused_select": n * (4 if overlap == "auto"
                                                 else 1)})
    launches.update({f"16c unaligned {o}": v[3] for o, v in b2.items()})
    shapes = {o: sorted(v[5]["shapes"]) for o, v in b2.items()}
    if shapes != {"off": [(4, 4_000_000)], "auto": [(1, 4_000_000)]}:
        raise AssertionError(f"unaligned: B2 shapes {shapes}")
    errs["b2"] = max([errs["b2"]] + [v[5]["err"] for v in b2.values()])
    print(f"phase bench schedules unaligned: config 2 on 4,000,000-element "
          f"chunks (the fused-EF gate refuses them: the unfused step), 2 "
          f"sparse steps a schedule, states bit for bit; B2 "
          f"{b2['off'][3]['fused_select']} / "
          f"{b2['auto'][3]['fused_select']} launches (one at [4, 4000000] "
          f"a step / one at [1, 4000000] a chunk), each bit-identical to "
          f"its plain version; B1 none")
    del b2
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # 16d. two gloo ranks on this card, both schedules
    out["two_workers"] = _bench_workers_phase()

    # 16e. --phase-timing and the tracker through Trainer
    trainer = _config(CONFIG2, ["--compressor", "gaussian_fused",
                                "--phase-timing", "--log-every", "2",
                                *WARMUP_2, "8"], "bench_phase_timing")
    _reset_launches()
    recs = [trainer.train(2) for _ in range(4)]
    torch.cuda.synchronize()
    launches["16e phase timing"] = _launches()
    keys = ("fwd_bwd_s", "select_s", "comm_update_s", "exposed_exchange_ms",
            "ex_per_s", "mfu")
    if [("phase_skipped" in r) for r in recs] != [True, True, False, False]:
        raise AssertionError(f"phase timing records {recs}")
    for rec in recs[2:]:
        if any(rec.get(key) is None or rec[key] < 0 for key in keys):
            raise AssertionError(f"phase timing record {rec}")
        print(f"phase bench phase timing step {rec['step']}: " + ", ".join(
            f"{key} {rec[key]}" for key in keys) + f" (step_s "
            f"{rec['step_s']:.6f}); {card}")
    out["phase_timing"] = {key: recs[-1][key] for key in keys}
    del trainer
    torch.cuda.empty_cache()

    for key in ("fused_ef_select", "fused_select", "fused_stats",
                "multi_threshold_counts"):
        if not any(run[key] for run in launches.values()):
            raise AssertionError(f"kernel {key} never launched in phase 16")
    print(f"phase bench: {time.perf_counter() - t_phase:.1f} s")
    return {"cells": out, "launches": launches, "b1_times": b1_times,
            "b1_err": errs["b1"], "b2_err": errs["b2"]}


# ------------------- phase 17: transformer_lm, the ring, the telemetry spine

# transformer_lm at the reference's default width with PTB's vocabulary:
# its n and k at density 0.001
LM = (24_035_328, 24_036)
LM_ARGV = ["--dnn", "transformer_lm", "--dataset", "ptb", "--compressor",
           "gaussian_fused", "--density", "0.001", "--dataset-kwargs",
           json.dumps({"bptt": 256})]
# the narrow transformer_lm held card against CPU, and its data
SMALL_LM = dict(dim=32, heads=2, num_layers=2, ffn=64, dropout=0.0,
                seq_len=32, max_len=64)
SMALL_LM_DATA = dict(vocab_size=128, bptt=32, synthetic_tokens_n=8192)
RING = (1, 8, 2048, 64)          # B, H, T, D of phase 17b
# dropout off: each rank draws its own masks, which one process cannot
SP_ARGV = [*LM_ARGV, "--compute-dtype", "float32", "--batch-size", "8",
           "--max-steps", "4", "--compress-warmup-steps", "2",
           "--model-kwargs", json.dumps({"dropout": 0.0})]
SP_BLOCK = [8, 128]              # a rank's batch at sp = 2: rows, positions


def _small_lm(device: str) -> list:
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    cfg = TrainConfig(
        dnn="transformer_lm", dataset="ptb", batch_size=4,
        compressor="gaussian_fused", density=0.01, compress_warmup_steps=2,
        max_steps=4, lr=0.02, compute_dtype="float32", device=device,
        model_kwargs=SMALL_LM, dataset_kwargs=SMALL_LM_DATA,
        output_dir=RUN_DIR, run_id=f"small_lm_{device}")
    trainer = Trainer(cfg)
    losses = [rec["loss"] for rec in _steps(trainer)]
    trainer.close()
    return losses


def _lm_phase(mem_rate: float) -> dict:
    """Phase 17a: transformer_lm at full width, one worker: 2 dense + 4
    sparse steps of ``gaussian_fused`` and the registry's flat call, every
    B1 and B2 call held bit for bit as it runs; an eval pass; the EF
    invariant of one more step; B1 timed at its padded row and B2 at [1,
    n]; 3 sparse steps under torch.profiler (unchecked: timing); a narrow
    run card vs CPU."""
    import torch
    from gaussiank_sgd_torch.compressors import decompress
    argv = [*LM_ARGV, "--max-steps", "6", "--compress-warmup-steps", "2",
            "--eval-max-batches", "4"]
    with _b1_checked() as b1c, _b2_checked() as b2c:
        trainer = _config(None, argv, "lm")
        n, k = trainer.plan.total_numel, trainer.plan.total_k
        _check_widths(trainer, {
            "dnn": "transformer_lm", "vocab": 10_000, "dim": 512,
            "heads": 8, "layers": 6, "bptt": 256, "seq": 256, "batch": 32,
            "dtype": "bfloat16", "density": 0.001,
            "compressor": "gaussian_fused", "n_k": LM}, "transformer_lm")
        records, launches, (r, _) = _drive(
            trainer, "lm", lambda: trainer.comp.fn(
                trainer.state.ef_residual[:n].contiguous(), k,
                trainer.state.comp_state[0, 0]))
        kinds = [rec["kind"] for rec in records]
        if kinds != ["dense"] * 2 + ["sparse"] * 4:
            raise AssertionError(f"transformer_lm: step kinds {kinds}")
        if (launches["fused_ef_select"], launches["fused_select"],
                launches["fused_stats"],
                launches["multi_threshold_counts"]) != (4, 1, 0, 0):
            raise AssertionError(f"transformer_lm: launches {launches} in 4 "
                                 f"sparse steps and one flat call")
        acc = trainer.state.ef_residual[:n]
        if not torch.equal(decompress(r.compressed, n) + r.residual, acc):
            raise AssertionError("transformer_lm flat compressor: "
                                 "decompress + residual != acc")
        del acc, r
        trainer.test()
        (ev,) = [e for e in _events(trainer) if e["event"] == "eval"]
        if not (math.isfinite(ev["val_loss"]) and ev["perplexity"] > 1):
            raise AssertionError(f"transformer_lm eval: {ev}")
        nsel = _ef_invariant(trainer, "transformer_lm sparse step")
        x = trainer.state.ef_residual.view(1, -1)[:, :n].contiguous()
        t = trainer.state.comp_state[0, :1].clone()
        checked = {"b1": b1c["calls"], "b2": b2c["calls"],
                   "err": max(b1c["err"], b2c["err"]),
                   "shapes": sorted(b1c["shapes"] | b2c["shapes"])}
    pad = trainer.ts.ef_numel
    print(f"phase transformer_lm: n={n} (24,035,328 expected) k={k}, EF row "
          f"[1, {pad}], launches {launches}; every B1 ({checked['b1']}) and "
          f"B2 ({checked['b2']}) call bit for bit against its plain version "
          f"as it ran (shapes {checked['shapes']}); losses "
          f"{[round(rec['loss'], 4) for rec in records]}; eval "
          f"val_loss {ev['val_loss']:.4f} perplexity {ev['perplexity']:.1f} "
          f"over {ev['n']:.0f} tokens in {ev['eval_ms']:.0f} ms; EF "
          f"invariant exact on one more sparse step (num_selected {nsel})")
    b2, b2_err = _b2_rows(x, t, 0.001, mem_rate, "transformer_lm")
    del x
    prof = _profile(trainer, "transformer_lm profile")
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICES["card"]).manual_seed(17)
    b1, b1_err, res, g, _ = _b1_phase(n, 0.001, gen, mem_rate)
    if res.shape[1] != pad:
        raise AssertionError(f"B1 row {res.shape[1]} != EF row {pad}")
    del res, g
    losses = {where: _small_lm(device) for where, device in DEVICES.items()}
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"]))
    if gap > 1e-5:
        raise AssertionError(f"narrow transformer_lm: card and CPU "
                             f"disagree: {losses}")
    print(f"phase transformer_lm small input: narrow f32 losses on the card "
          f"{losses['card']} vs CPU {losses['cpu']} (max rel gap "
          f"{gap:.2e} <= 1e-5)")
    return {"launches": launches, "b1": b1, "b2": b2, "shape": [1, pad],
            "n": n, "err": max(checked["err"], b1_err, b2_err),
            "checked": checked, "profile": prof}


def _plain_causal(q, k, v):
    """Causal softmax attention in f32, the whole ``[T, T]`` score
    matrix at once."""
    import torch
    t, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v.float()


def _ring_phase() -> dict:
    """Phase 17b: ``ring_attention_blocks`` (every rank of an sp ring in
    this one process, the hop a roll of the block lists; the same
    ``_block_attend`` the distributed ring runs) at T = 2048, 8 heads of
    64, sp = 2, 4 and 8, on f32 and bf16 inputs, against plain causal
    attention within rtol 3e-4 / atol 3e-5; a bf16 input's output is its
    f32-cast input's output rounded once to bf16, bit for bit."""
    import torch
    from gaussiank_sgd_torch.parallel.ring_attention import (
        ring_attention_blocks)
    card = DEVICES["card"]
    gen = torch.Generator(device=card).manual_seed(17)
    q, k, v = (torch.randn(*RING, device=card, generator=gen)
               for _ in range(3))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (a.to(dtype) for a in (q, k, v))
        want = _plain_causal(qd, kd, vd)
        plain_ms = _median_ms(lambda: _plain_causal(qd, kd, vd), 5)
        for sp in (2, 4, 8):
            def ring(*xs):
                return torch.cat(ring_attention_blocks(
                    *(x.chunk(sp, dim=2) for x in xs), causal=True), dim=2)
            got = ring(qd, kd, vd)
            if dtype == torch.bfloat16:
                f32 = ring(*(x.float() for x in (qd, kd, vd)))
                if got.dtype != dtype or not torch.equal(got, f32.to(dtype)):
                    raise AssertionError(f"ring sp={sp} bf16: not its f32 "
                                         f"result rounded once")
                got = f32
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=3e-4, atol=3e-5):
                raise AssertionError(f"ring sp={sp} {dtype}: max abs err "
                                     f"{err} against plain attention")
            ms = _median_ms(lambda: ring(qd, kd, vd), 5)
            name = f"sp{sp}_{str(dtype).split('.')[-1]}"
            out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            print(f"phase ring {RING} sp={sp} {dtype}: max abs err {err:.2e}"
                  f" against plain causal attention (rtol 3e-4 / atol 3e-5)"
                  f"; all {sp} ranks in one process {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms (eager, launches included)")
    return out


def _sp_worker(rank: int, world: int, d: str) -> int:
    """One rank of phase 17c: transformer_lm at full width, f32, in the (dp
    1, sp 2) layout on cuda:0 over gloo (the ring's hops staged through
    host memory), 2 dense + 2 sparse steps with every B1 call held, then an
    eval pass."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.parallel import mesh
    mesh.init_distributed("cuda:0", rank, world,
                          "file://" + os.path.join(d, "store"),
                          backend="gloo")
    with _b1_checked() as b1c:
        trainer = _config(None, [*SP_ARGV, "--sp-size", str(world),
                                 "--eval-max-batches", "2"], f"sp_{rank}")
        _reset_launches()
        hashes, losses, step_ms = [], [], []
        for _ in range(4):
            trainer.train(1)
            rec = trainer.records[-1]
            params = trainer.state.params.detach().cpu().numpy()
            hashes.append(hashlib.sha256(params.tobytes()).hexdigest())
            losses.append(rec["loss"])
            step_ms.append(rec["step_ms"])
        torch.cuda.synchronize()
        launches = _launches()
        ev = trainer.test()
    out = {"hashes": hashes, "losses": losses, "step_ms": step_ms,
           "launches": launches, "b1_calls": b1c["calls"],
           "b1_err": b1c["err"], "mesh": [list(trainer.mesh.names),
                                          list(trainer.mesh.sizes)],
           "batch": list(trainer.next_batch()[0].shape),
           "val_loss": ev["val_loss"],
           "n": trainer.plan.total_numel, "nan": bool(np.isnan(losses).any())}
    trainer.close()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _sp_phase() -> dict:
    """Phase 17c: two ranks at sp = 2 against the same run at sp = 1 in this
    process: the ranks' parameters bit-identical after every step, and the
    losses within rtol 1e-4 of the sp = 1 run's (f32: the ring sums the
    softmax in another order, ~1e-7 relative, which can move an entry
    across the sparse step's threshold and so send another one)."""
    import torch
    d = os.path.join(RUN_DIR, "sp")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sp-worker", str(r), "2", d],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=500) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"sp: rank {r} exited {p.returncode}: "
                                 f"{err[-3000:]}")
    res = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    first = res[0]
    for r, rr in enumerate(res):
        if (rr["hashes"] != first["hashes"] or rr["losses"] != first["losses"]
                or rr["launches"]["fused_ef_select"] != 2
                or rr["b1_calls"] != 2 or rr["nan"]
                or rr["mesh"] != [["dp", "sp"], [1, 2]]
                or rr["batch"] != SP_BLOCK or rr["n"] != LM[0]):
            raise AssertionError(f"sp: rank {r}: {rr}")
    with _b1_checked() as b1c:
        one = _config(None, [*SP_ARGV], "sp_one")
        losses = [rec["loss"] for rec in _steps(one)]
        one.close()
    del one
    torch.cuda.empty_cache()
    gap = max(abs(a - b) / abs(b) for a, b in zip(first["losses"], losses))
    if gap > 1e-4:
        raise AssertionError(f"sp: sp = 2 losses {first['losses']} vs sp = "
                             f"1 {losses} (max rel gap {gap:.2e} > 1e-4)")
    print(f"phase sp: transformer_lm full width f32 batch 8 on 2 ranks of a "
          f"gloo group on this card at (dp 1, sp 2), 128 positions a rank, "
          f"2 dense + 2 sparse steps: losses {first['losses']}, parameters "
          f"bit-identical on both ranks after every step (sha256 "
          f"{[h[:12] for h in first['hashes']]}), B1 "
          f"{[rr['b1_calls'] for rr in res]} calls a rank, each bit for bit;"
          f" sp = 1 in one process {losses} (max rel gap {gap:.2e} <= "
          f"1e-4); eval val_loss {first['val_loss']:.4f}; rank 0's step ms "
          f"{[round(v, 1) for v in first['step_ms']]}; {wall:.1f} s of wall "
          f"time with the processes' start")
    return {"launches": [rr["launches"]["fused_ef_select"] for rr in res]
            + [b1c["calls"]], "err": max([b1c["err"]]
                                         + [rr["b1_err"] for rr in res])}


def _spine_phase() -> dict:
    """Phase 17d: config 2 through ``Trainer`` with ``--trace on
    --prom-textfile`` and, beside it, without: 2 dense + 4 sparse steps
    each with every B1 and B2 call held, then 6 more sparse steps of each
    in turns, unchecked, for the step time with the trace on and off. The
    traced stream validates strictly with ``seq`` gap-free and a whole
    span tree, ``build_chrome_trace`` renders it, the textfile parses."""
    import torch
    from gaussiank_sgd_torch.telemetry import (build_chrome_trace,
                                               validate_stream)
    prom = os.path.join(RUN_DIR, "spine", "gksgd.prom")
    for run_id in ("spine_on", "spine_off", "spine"):
        shutil.rmtree(os.path.join(RUN_DIR, run_id), ignore_errors=True)
    argv = ["--compressor", "gaussian_fused", "--max-steps", "6",
            "--compress-warmup-steps", "2", "--log-every", "1"]
    with _b1_checked() as b1c, _b2_checked() as b2c:
        _reset_launches()
        on = _config(CONFIG2, [*argv, "--trace", "on", "--prom-textfile",
                               prom], "spine_on")
        off = _config(CONFIG2, argv, "spine_off")
        for trainer in (on, off):
            _steps(trainer)
        torch.cuda.synchronize()
        launches = _launches()
    if (b1c["calls"], launches["fused_ef_select"]) != (8, 8):
        raise AssertionError(f"spine: B1 {b1c['calls']} checked calls, "
                             f"launches {launches}")
    ms = {"on": [], "off": []}
    for _ in range(6):
        for name, trainer in (("on", on), ("off", off)):
            trainer.train(1)
            ms[name].append(trainer.records[-1]["step_ms"])
    on.close()
    off.close()
    with open(on.metrics_path) as f:
        lines = f.read().splitlines()
    rep = validate_stream(lines, strict=True)
    recs = [json.loads(line) for line in lines]
    if (not rep.ok or rep.seq_gaps or rep.seq_resets or rep.span_orphans
            or rep.span_unclosed
            or [r["seq"] for r in recs] != list(range(len(recs)))):
        raise AssertionError(f"spine: stream {vars(rep)}")
    trains = [r for r in recs if r["event"] == "train"]
    if (len(trains) != 12 or trains[-1]["pipeline_chunks"] != 0
            or trains[-1]["comm_rounds"] != 1):
        raise AssertionError(f"spine: train records {trains[-1:]}")
    trace = build_chrome_trace(recs)
    dispatch = [e for e in trace["traceEvents"]
                if e.get("name") == "step_dispatch"]
    if len(dispatch) != 12:
        raise AssertionError(f"spine: {len(dispatch)} step_dispatch spans")
    with open(prom) as f:
        gauges = dict(line.rsplit(" ", 1) for line in f.read().splitlines()
                      if line and not line.startswith("#"))
    if (float(gauges["gksgd_train_step"]) != 12
            or int(gauges['gksgd_events_total{event="train"}']) != 12):
        raise AssertionError(f"spine: textfile {gauges}")
    with open(off.metrics_path) as f:
        untraced = [json.loads(line) for line in f]
    if any(r["event"] == "span" or "trace_id" in r for r in untraced):
        raise AssertionError("spine: the untraced stream has trace records")
    med = {name: statistics.median(v) for name, v in ms.items()}
    print(f"phase spine: config 2 --trace on --prom-textfile: "
          f"{len(recs)} records ({rep.events}) validate strictly, seq 0.."
          f"{len(recs) - 1} gap-free, span tree whole; Chrome trace "
          f"{len(trace['traceEvents'])} events, {len(dispatch)} "
          f"step_dispatch spans; textfile {len(gauges)} series; every B1 "
          f"({b1c['calls']}) and B2 ({b2c['calls']}) call of the checked "
          f"steps bit for bit; sparse step ms trace on {ms['on']} vs off "
          f"{ms['off']} (medians {med['on']:.2f} / {med['off']:.2f}, "
          f"in turns, unchecked)")
    return {"launches": launches, "err": max(b1c["err"], b2c["err"]),
            "step_ms": med}


# ------------------------ phase 18: the pod rig and run health

# config 2 through the pod launcher: 2 ranks on this card over gloo (NCCL
# puts one rank on a card), 2 dense + 8 sparse steps, a checkpoint every 4;
# 4,096 synthetic images make an epoch 16 steps at 2 x 128, so the kill
# and the resume stay inside the first epoch, where a resumed run repeats
# the uninterrupted one bit for bit (CIFAR's augmentation restarts with
# the dataset)
POD_ARGV = ["--config", CONFIG2, "--compressor", "gaussian_fused",
            "--max-steps", "10", "--compress-warmup-steps", "2",
            "--save-every-steps", "4", "--save-every-epochs", "0",
            "--eval-every-epochs", "0", "--log-every", "2",
            "--dataset-kwargs", json.dumps({"synthetic_examples": 4096})]
# the prefetch thread pulls up to 3 batches ahead of the step, so a kill
# at the pull of step 7's batch comes after step 4's checkpoint is sealed
POD_KILL = (7, 1)
HEALTH_ARGV = ["--compressor", "gaussian_fused", "--max-steps", "10",
               "--compress-warmup-steps", "2", "--log-every", "2",
               "--eval-every-epochs", "0", "--save-every-epochs", "0"]
HEALTH_ON = ["--health", "on", "--health-port", "0"]


def _pod_config(out_dir: str, run_id: str, extra=()):
    """The pod's TrainConfig, through the trainer's own flag parsing."""
    import argparse
    from gaussiank_sgd_torch.training.config import add_args, from_args
    argv = [*POD_ARGV, *extra, "--output-dir", out_dir, "--run-id", run_id]
    p = argparse.ArgumentParser()
    add_args(p)
    return from_args(p.parse_args(argv), argv)


def _pod_worker(i: int) -> int:
    """One worker of a phase 18a or 19c pod (the supervisor starts
    ``chip_smoke.py --pod-worker I`` in place of ``launch.py --worker I``):
    the launcher's own ``worker_main``, with every B1 call held bit for bit
    against its plain version as it runs, and a note of the calls
    (rewritten after each, since a SIGKILLed worker writes nothing at its
    end), the epoch's steps, the restore held against the checkpoint's rank
    files (``_restored_ef_check``) and, after ``fit``, the sha256 of the
    final parameters."""
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.ops import fused_select as fs
    from gaussiank_sgd_torch.training import launch
    from gaussiank_sgd_torch.training import trainer as trainer_mod
    spec = json.loads(os.environ[launch.SPEC_ENV])
    path = os.path.join(spec["pod_dir"], f"check_gen{spec['generation']:02d}"
                                         f"_proc{i:03d}.json")
    note = {"generation": spec["generation"], "proc": i, "b1_calls": 0,
            "b1_err": 0.0, "launches": 0, "shapes": [], "sha": None,
            "step": None, "steps_per_epoch": None}

    def dump():
        with open(path + ".tmp", "w") as f:
            json.dump(note, f)
        os.replace(path + ".tmp", path)

    real_init, real_fit = trainer_mod.Trainer.__init__, trainer_mod.Trainer.fit
    real_restore = trainer_mod.restore_latest_good
    restored = []

    def restore(*args, **kw):
        path = real_restore(*args, **kw)
        restored.append(path)
        return path

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        note["steps_per_epoch"] = self.steps_per_epoch
        note["step"] = self.step
        if restored:
            note["ef"] = _restored_ef_check(self, restored[0], self.rank)
        dump()

    trainer_mod.restore_latest_good = restore

    def fit(self):
        out = real_fit(self)
        params = self.state.params.detach().cpu().numpy()
        note.update(sha=hashlib.sha256(params.tobytes()).hexdigest(),
                    step=self.step)
        dump()
        return out

    trainer_mod.Trainer.__init__ = init
    trainer_mod.Trainer.fit = fit
    _reset_launches()
    with _b1_checked() as seen:
        checked = fs.fused_ef_select_candidates_chunked

        def noted(*args):
            out = checked(*args)
            note.update(b1_calls=seen["calls"], b1_err=seen["err"],
                        launches=_launches()["fused_ef_select"],
                        shapes=sorted(seen["shapes"]))
            dump()
            return out

        fs.fused_ef_select_candidates_chunked = noted
        return launch.worker_main(spec, i)


def _pod_run(tmp: str, run_id: str, kill) -> dict:
    """One phase 18a pod of 2 ranks on this card over gloo, its workers
    ``chip_smoke.py --pod-worker I``; ``kill`` = (step, proc) or None.
    Returns the exit code, the supervisor's records, each generation's
    spawn time, when a loss was seen, the end, and the workers' notes."""
    from gaussiank_sgd_torch.training import launch

    class PodSupervisor(launch.Supervisor):
        def __init__(self, *args):
            super().__init__(*args)
            self.spawned, self.lost_at = [], []

        def _worker_command(self, i):
            return [sys.executable, os.path.abspath(__file__),
                    "--pod-worker", str(i)]

        def _spawn(self, spec):
            self.spawned.append(time.time())
            return super()._spawn(spec)

        def _lost_workers(self, procs, spec, now):
            lost = super()._lost_workers(procs, spec, now)
            if lost and len(self.lost_at) < len(self.spawned):
                self.lost_at.append(time.time())       # the loss seen
            return lost

    cfg = _pod_config(tmp, run_id)
    sup = PodSupervisor(cfg, launch.LaunchConfig(
        nprocs=2, dist_backend="gloo", grace_s=5.0, max_relaunches=1,
        kill_step=kill[0] if kill else None,
        kill_proc=kill[1] if kill else 0), os.path.join(tmp, run_id))
    t0 = time.time()
    rc = sup.run()
    end = time.time()
    pod = sup.pod_dir
    with open(os.path.join(pod, "supervisor.jsonl")) as f:
        records = [json.loads(line) for line in f]
    notes = {}
    for name in sorted(os.listdir(pod)):
        if name.startswith("check_gen") and name.endswith(".json"):
            with open(os.path.join(pod, name)) as f:
                notes[name[len("check_"):-len(".json")]] = json.load(f)
    return {"rc": rc, "records": records, "spawned": sup.spawned,
            "lost_at": sup.lost_at, "t0": t0, "end": end, "notes": notes,
            "pod": pod, "generations": sup.generation + 1}


def _keep_pod_files(pod: str, name: str) -> None:
    """Copy a pod's streams and logs (not its checkpoints) under RUN_DIR."""
    dest = os.path.join(RUN_DIR, "pod", name)
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    for root, _, files in os.walk(pod):
        if os.path.basename(root).startswith("step_"):
            continue
        for f in files:
            if f.endswith((".jsonl", ".log")) or f.startswith("check_"):
                rel = os.path.relpath(os.path.join(root, f), pod)
                os.makedirs(os.path.dirname(os.path.join(dest, rel)),
                            exist_ok=True)
                shutil.copy(os.path.join(root, f), os.path.join(dest, rel))


def _cli(argv) -> tuple:
    """The port's telemetry CLI in this process: (exit code, its output)."""
    import io
    from gaussiank_sgd_torch.telemetry.__main__ import main as tcli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli(argv)
    return rc, buf.getvalue()


def _pod_phase() -> dict:
    """Phase 18a: config 2 at full width in a pod of 2 ranks on this card
    (gloo), worker 1 SIGKILLed at the pull of step 7's batch: worker_lost
    (-9), a relaunch from the sealed step_00000004, exit 0, the merged
    stream strictly valid and critical; both ranks' final parameters equal,
    and equal to the same pod's without the kill; every B1 call of both
    pods held bit for bit. Then a clean pod through the real ``python -m
    gaussiank_sgd_torch.training.launch``. Returns B1's launches a run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pod_")
    try:
        killed = _pod_run(tmp, "killed", POD_KILL)
        clean = _pod_run(tmp, "clean", None)
        for name, run in (("killed", killed), ("clean", clean)):
            _keep_pod_files(run["pod"], name)
        out = _pod_checks(killed, clean)
        out["entry"] = _pod_entry_point(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _pod_checks(killed: dict, clean: dict) -> dict:
    if (killed["rc"], clean["rc"]) != (0, 0):
        raise AssertionError(f"pod: exit codes {killed['rc']} (killed), "
                             f"{clean['rc']} (clean)")
    recs = killed["records"]
    lost = [r for r in recs if r["event"] == "worker_lost"]
    rel = [r for r in recs if r["event"] == "worker_relaunch"]
    want_ckpt = os.path.join(killed["pod"], "ckpt", "step_00000004")
    if (not any(r["worker"] == POD_KILL[1] and r["exit_code"] == -9
                for r in lost)
            or [r["checkpoint"] for r in rel] != [want_ckpt]
            or killed["generations"] != 2 or clean["records"]
            or clean["generations"] != 1):
        raise AssertionError(f"pod: supervisor records {recs}, clean "
                             f"{clean['records']}")
    pod = killed["pod"]
    merged = os.path.join(pod, "merged.jsonl")
    streams = [os.path.join(pod, f"proc{i:03d}", "metrics.jsonl")
               for i in range(2)] + [os.path.join(pod, "supervisor.jsonl")]
    rc_merge, merge_out = _cli(["merge", *streams, "-o", merged,
                                "--strict"])
    rc_health, health_out = _cli(["health", merged])
    shutil.copy(merged, os.path.join(RUN_DIR, "pod", "killed"))
    if rc_merge != 0 or rc_health != 2 or "worker_lost" not in health_out:
        raise AssertionError(f"pod: merge {rc_merge} {merge_out}; health "
                             f"{rc_health} {health_out}")
    notes = {**{f"killed {k}": v for k, v in killed["notes"].items()},
             **{f"clean {k}": v for k, v in clean["notes"].items()}}
    final_k = [killed["notes"][f"gen01_proc{i:03d}"] for i in range(2)]
    final_c = [clean["notes"][f"gen00_proc{i:03d}"] for i in range(2)]
    if (len({n["sha"] for n in final_k + final_c}) != 1
            or final_k[0]["sha"] is None
            or any(n["step"] != 10 for n in final_k + final_c)):
        raise AssertionError(f"pod: final parameters (killed, then clean) "
                             f"{[(n['sha'], n['step']) for n in final_k + final_c]}")
    spe = {n["steps_per_epoch"] for n in notes.values()}
    for name, n in notes.items():
        if n["launches"] != n["b1_calls"] or n["shapes"] not in (
                [], [[1, EXCHANGE_WANT["whole bucket"][2][2]]]):
            raise AssertionError(f"pod: {name}: {n}")
    # the clean ranks and the relaunched ones run every sparse step
    if ([n["b1_calls"] for n in final_c] != [8, 8]
            or [n["b1_calls"] for n in final_k] != [6, 6]):
        raise AssertionError(f"pod: B1 calls {notes}")
    gen0_wall = killed["lost_at"][0] - killed["spawned"][0]
    respawn = killed["spawned"][1] - killed["lost_at"][0]
    gen1_wall = killed["end"] - killed["spawned"][1]
    b1 = {name: n["b1_calls"] for name, n in notes.items()}
    print(f"phase pod: config 2 full width, 2 ranks on this card over gloo, "
          f"{spe} steps an epoch (the run's 10 inside the first), a "
          f"checkpoint every 4, worker 1 SIGKILLed at the pull of step "
          f"{POD_KILL[0]}'s batch: worker_lost "
          f"{[(r['worker'], r['exit_code']) for r in lost]}, relaunch from "
          f"{os.path.basename(rel[0]['checkpoint'])}, exit 0; generation 0 "
          f"{gen0_wall:.1f} s spawn to the loss seen, loss seen to respawn "
          f"{respawn:.2f} s (teardown: SIGTERM, at most 5 s of grace, "
          f"SIGKILL), generation 1 {gen1_wall:.1f} s; clean pod "
          f"{clean['end'] - clean['t0']:.1f} s; merged stream strict: "
          f"{merge_out.strip().splitlines()[-1]}; health exit {rc_health} "
          f"({health_out.splitlines()[0]}); final parameters of both ranks "
          f"killed and clean sha256 {final_k[0]['sha'][:16]} (4 equal); B1 "
          f"calls held bit for bit (= launches) {b1}")
    return {"launches": sum(b1.values()), "runs": b1,
            "err": max(n["b1_err"] for n in notes.values()),
            "gen0_s": gen0_wall, "respawn_s": respawn, "gen1_s": gen1_wall,
            "clean_s": clean["end"] - clean["t0"]}


def _pod_entry_point(tmp: str) -> float:
    """A short clean pod through ``python -m
    gaussiank_sgd_torch.training.launch`` (2 gloo ranks on this card, 2
    dense + 2 sparse steps): exit 0, both workers' streams strictly
    valid. Returns its wall time."""
    from gaussiank_sgd_torch.telemetry.events import validate_file
    argv = [sys.executable, "-m", "gaussiank_sgd_torch.training.launch",
            "--nprocs", "2", "--dist-backend", "gloo", "--grace", "5",
            *POD_ARGV, "--max-steps", "4", "--output-dir", tmp,
            "--run-id", "entry"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    pod = os.path.join(tmp, "entry")
    _keep_pod_files(pod, "entry")
    reps = [validate_file(os.path.join(pod, f"proc{i:03d}", "metrics.jsonl"),
                          strict=True) for i in range(2)]
    if proc.returncode != 0 or not all(r.ok for r in reps):
        raise AssertionError(f"pod entry point: exit {proc.returncode}, "
                             f"{[r.errors for r in reps]}: "
                             f"{proc.stderr[-3000:]}")
    print(f"phase pod entry point: python -m gaussiank_sgd_torch.training."
          f"launch --nprocs 2 --dist-backend gloo, config 2, 4 steps: exit "
          f"0 in {wall:.1f} s, both streams strictly valid "
          f"({[r.n_records for r in reps]} records)")
    return wall


def _healthz(port: int) -> tuple:
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health_surfaces(trainer) -> tuple:
    """The stream's verdicts, the CLI's exit code and the report's health
    section."""
    from gaussiank_sgd_torch.telemetry import report
    events = report.load_events(trainer.metrics_path)
    rc, text = _cli(["health", trainer.metrics_path])
    summary = report.summarize(events)
    return ([e for e in events if e["event"] == "health_status"], rc, text,
            summary.get("health"), report.format_report(summary))


def _health_phase() -> dict:
    """Phase 18b-d: config 2 in one process with ``--health on
    --health-port 0`` (b: clean, 5 ok verdicts on every surface; c: a NaN
    batch at step 7 with ``--max-consecutive-skips 1``: instability,
    a rollback, 503 and exit 2), every B1 call held bit for bit; d: the
    wall ms of a step with health on and off, 6 steps each in turns."""
    import torch
    from gaussiank_sgd_torch.training import chaos
    tmp = tempfile.mkdtemp(prefix="chip_smoke_health_")
    try:
        with _b1_checked() as b1c:
            _reset_launches()
            on = _config(CONFIG2, [*HEALTH_ARGV, *HEALTH_ON], "health_on")
            port = on._health_server.port
            _steps(on)
            code, live = _healthz(port)
            verdicts, rc, text, hsec, _ = _health_surfaces(on)
            if (len(verdicts) != 5 or any(v["state"] != "ok"
                                          for v in verdicts)
                    or (code, live["worst_state"]) != (200, "ok") or rc != 0
                    or hsec["worst_state"] != "ok"):
                raise AssertionError(f"health clean: {verdicts}, /healthz "
                                     f"{code} {live}, CLI {rc} {text}, "
                                     f"report {hsec}")
            print(f"phase health clean: config 2 --health on --log-every "
                  f"2, 10 steps: verdicts "
                  f"{[(v['step'], v['state']) for v in verdicts]}, /healthz "
                  f"{code} worst {live['worst_state']}, CLI exit {rc}, "
                  f"report worst {hsec['worst_state']}")
            nan = _config(CONFIG2, [*HEALTH_ARGV, *HEALTH_ON,
                                    "--save-every-steps", "4",
                                    "--max-consecutive-skips", "1"],
                          "health_nan", out_dir=tmp)
            chaos.inject_nan_batches(nan, {6})         # poisons step 7
            while nan.step < nan.total_steps:
                nan.train(nan.total_steps - nan.step)
            code, live = _healthz(nan._health_server.port)
            nan.close()
            verdicts, rc, text, hsec, rep = _health_surfaces(nan)
            flagged = [v for v in verdicts if "instability" in v["causes"]]
            rollbacks = [e for e in _events(nan) if e["event"] == "rollback"]
            if (not flagged or flagged[0]["step"] > 7 + 2 * 2
                    or not rollbacks or code != 503
                    or live["worst_state"] != "critical" or rc != 2
                    or "instability" not in text
                    or "instability" not in rep):
                raise AssertionError(f"health nan: {verdicts}, rollbacks "
                                     f"{rollbacks}, /healthz {code} {live},"
                                     f" CLI {rc} {text}")
            torch.cuda.synchronize()
            launches = _launches()["fused_ef_select"]
        print(f"phase health nan: NaN batch at step 7, "
              f"--max-consecutive-skips 1: first instability verdict at "
              f"step {flagged[0]['step']} ({flagged[0]['state']}), rollback "
              f"to step {rollbacks[0]['to_step']}, /healthz {code} worst "
              f"{live['worst_state']}, CLI exit {rc}, report: instability; "
              f"every B1 call ({b1c['calls']}) bit for bit, launches "
              f"{launches}")
        if launches != b1c["calls"]:
            raise AssertionError(f"health: launches {launches} != B1 calls "
                                 f"{b1c['calls']}")
        off = _config(CONFIG2, HEALTH_ARGV, "health_off")
        _steps(off)
        ms = {"on": [], "off": []}
        ticks = []
        tick = on.health.tick

        def timed_tick(step):
            t0 = time.perf_counter()
            out = tick(step)
            ticks.append((time.perf_counter() - t0) * 1e6)
            return out

        on.health.tick = timed_tick
        for _ in range(6):
            for name, trainer in (("on", on), ("off", off)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train(1)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
        on.close()
        off.close()
        if any(e["event"] == "health_status" for e in _events(off)):
            raise AssertionError("health: the run with health off wrote a "
                                 "verdict")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    med = {name: statistics.median(v) for name, v in ms.items()}
    print(f"phase health cost: config 2 sparse step wall ms (train(1), "
          f"synchronised) health on {[round(v, 2) for v in ms['on']]} vs off "
          f"{[round(v, 2) for v in ms['off']]} (medians {med['on']:.2f} / "
          f"{med['off']:.2f}, in turns); {len(ticks)} ticks of "
          f"{statistics.mean(ticks):.1f} us each")
    return {"launches": launches, "err": b1c["err"], "step_ms": med,
            "tick_us": statistics.mean(ticks)}


def _pod_and_health_phase() -> dict:
    """Phase 18: the pod rig (a) and run health (b-d)."""
    t0 = time.perf_counter()
    out = {"pod": _pod_phase(), "health": _health_phase()}
    print(f"phase pod and health: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- phase 19

POLICY_ARGV = ["--compressor", "gaussian_fused", "--policy", "adaptive",
               "--log-every", "2", "--eval-every-epochs", "0",
               "--save-every-epochs", "0"]
ELASTIC_ARGV = ["--config", CONFIG2, "--compressor", "gaussian_fused",
                "--max-steps", "12", "--compress-warmup-steps", "2",
                "--save-every-steps", "2", "--save-every-epochs", "0",
                "--eval-every-epochs", "0", "--log-every", "2",
                "--dataset-kwargs", json.dumps({"synthetic_examples": 6144})]
POLICY_SCRIPT = [("compressor", "gaussian_pallas"), ("density", "0.002")]
ELASTIC_KILL = (3, 1)
ELASTIC_SCHEDULE = [(4, 3), (8, 2)]


@contextlib.contextmanager
def _b3_checked():
    """``_b1_checked`` for B3: while active, every B3 call is held at once
    against the plain version on the same input: the max bit for bit (or
    NaN in both), the sums within phase 5's summation-order tolerance
    (``|d sum| <= 1e-6 * sum|x|``, ``|d sumsq| <= 1e-5 * sumsq``; the
    kernel adds in an order of its own) or non-finite in both (a NaN
    batch's gradient). Yields ``{"calls", "err", "shapes", "nonfinite"}``."""
    import torch
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops
    real = ts_ops.fused_stats
    seen = {"calls": 0, "err": 0.0, "shapes": set(), "nonfinite": 0}

    def checked(flat):
        out = real(flat)
        plain = ts_ops.fused_stats_plain(flat)
        what = f"B3 call {seen['calls']}"
        a, b = out[2], plain[2]
        if not (torch.equal(_bits(a), _bits(b))
                or (bool(torch.isnan(a)) and bool(torch.isnan(b)))):
            raise AssertionError(f"{what}: max|x| {float(a)} vs plain "
                                 f"{float(b)}")
        if bool(torch.isfinite(plain[0])) and bool(torch.isfinite(plain[1])):
            d_sum = abs(float(out[0] - plain[0]))
            d_sumsq = abs(float(out[1] - plain[1]))
            if (d_sum > 1e-6 * float(flat.abs().sum())
                    or d_sumsq > 1e-5 * float(plain[1])):
                raise AssertionError(f"{what}: sums {out[:2]} vs plain "
                                     f"{plain[:2]}")
            seen["err"] = max(seen["err"], d_sum, d_sumsq)
        elif bool(torch.isfinite(out[0])) or bool(torch.isfinite(out[1])):
            raise AssertionError(f"{what}: finite sums {out[:2]} where the "
                                 f"plain version's are not {plain[:2]}")
        else:
            seen["nonfinite"] += 1
        seen["calls"] += 1
        seen["shapes"].add(tuple(flat.shape))
        return out

    ts_ops.fused_stats = checked
    try:
        yield seen
    finally:
        ts_ops.fused_stats = real


@contextlib.contextmanager
def _b4_checked():
    """``_b1_checked`` for B4: while active, every B4 call is held at once
    against the plain version on the same input and thresholds, bit for
    bit. Yields ``{"calls", "err", "shapes"}``."""
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops
    real = ts_ops.multi_threshold_counts
    seen = {"calls": 0, "err": 0.0, "shapes": set()}

    def checked(flat, thresholds):
        out = real(flat, thresholds)
        seen["err"] = max(seen["err"], _same(
            (out,), (ts_ops.multi_threshold_counts_plain(flat, thresholds),),
            f"B4 call {seen['calls']}"))
        seen["calls"] += 1
        seen["shapes"].add(tuple(flat.shape))
        return out

    ts_ops.multi_threshold_counts = checked
    try:
        yield seen
    finally:
        ts_ops.multi_threshold_counts = real


def _script_rule(script):
    """The reference tests' scripted rule: each (knob, value) of
    ``script`` in turn, proposed from the first boundary after a sparse
    interval on (an interval with a wire format) until the engine's knobs
    hold it; a quarantined one the engine filters out."""
    from gaussiank_sgd_torch.policy import PolicyDecision, Rule

    class ScriptRule(Rule):
        name = "script"

        def __init__(self):
            self.i = 0

        def propose(self, snap, ctx):
            while (self.i < len(script)
                   and ctx.knobs.get(script[self.i][0]) == script[self.i][1]):
                self.i += 1
            if self.i >= len(script) or snap.wire_format is None:
                return None
            knob, new = script[self.i]
            return PolicyDecision(step=snap.step, rule=self.name, knob=knob,
                                  old=ctx.knobs[knob], new=new,
                                  reason=f"scripted {knob} -> {new}")

    return ScriptRule()


def _noting_rebuilds(trainer, notes: list):
    """Wrap the trainer's policy rebuild: around each, the first n entries
    of the parameter, the momentum and the EF row must carry over bit for
    bit and the tail be zero; notes (step, compressor, numel before and
    after, wall ms of the rebuild)."""
    import torch
    rebuild = trainer._rebuild_for_policy

    def checked():
        old = trainer.state
        n = trainer.plan.total_numel
        before = [old.params.detach()[:n].clone(),
                  old.opt_state["m"][:n].clone(),
                  old.ef_residual[:n].clone()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuild()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        new = trainer.state
        after = [new.params.detach(), new.opt_state["m"], new.ef_residual]
        for name, b, a in zip(("parameter", "momentum", "EF row"), before,
                              after):
            if not torch.equal(_bits(a[:n]), _bits(b)) or a[n:].any():
                raise AssertionError(f"policy rebuild at step {old.step}: "
                                     f"the {name} did not carry over")
        if new.params is not trainer.model.flat:
            raise AssertionError("policy rebuild: the step's parameter is "
                                 "not the model's")
        notes.append({"step": old.step, "compressor": trainer.comp.name,
                      "density": trainer.cfg.density,
                      "numel": [old.params.numel(), new.params.numel()],
                      "ms": ms})

    trainer._rebuild_for_policy = checked


def _policy_script_phase(tmp: str) -> dict:
    """Phase 19a: config 2 at full width under ``--policy adaptive`` with
    a scripted rule (hysteresis 1): gaussian_fused -> gaussian_pallas at
    the first boundary after a sparse interval, density 0.001 -> 0.002
    once that decision's probation has passed, then NaN batches on the two
    steps after it: the engine reverts the density decision and
    quarantines it. Every B1, B3 and B4 call held against its plain
    version as it runs."""
    import torch
    from gaussiank_sgd_torch.telemetry.events import validate_file
    from gaussiank_sgd_torch.training import chaos
    notes = []
    with _b1_checked() as b1c, _b3_checked() as b3c, _b4_checked() as b4c:
        _reset_launches()
        t = _config(CONFIG2, [*POLICY_ARGV, "--max-steps", "16",
                              "--compress-warmup-steps", "2",
                              "--save-every-steps", "2", "--keep-checkpoints",
                              "2", "--trace", "on"],
                    "policy_script", out_dir=tmp)
        n, padded = t.plan.total_numel, t.ts.ef_numel
        eng = t.engine
        eng.rules = [_script_rule(POLICY_SCRIPT)]
        eng._hysteresis, eng._cooldown, eng._skip_burst = 1, 0, 2
        # the scripted lifecycle tests the skip-burst net: park the
        # loss-spike net (config 2's early loss moves by more than 1.5x)
        eng._loss_spike_factor = 1e9
        _noting_rebuilds(t, notes)
        # the switch at step 4, its probation over at step 10 and the
        # density decision there; two clean steps at the new density
        t.train(12)
        if [(d["knob"], d["new"]) for d in eng.decision_log] != \
                POLICY_SCRIPT:
            raise AssertionError(f"policy script: decisions "
                                 f"{eng.decision_log}")
        chaos.inject_nan_batches(t, {12, 13})       # steps 13 and 14
        t.train(t.total_steps - t.step)
        torch.cuda.synchronize()
        launches = _launches()
        records = list(t.records)
    t.close()
    events = _events(t)
    dec = [e for e in events if e["event"] == "policy_decision"]
    rev = [e for e in events if e["event"] == "policy_revert"]
    rep = validate_file(t.metrics_path, strict=True)
    if (len(dec), len(rev)) != (2, 1) or not rev[0]["quarantined"] \
            or rev[0]["knob"] != "density" or eng.recompiles != 3 \
            or not rep.ok or not math.isfinite(records[-1]["loss"]):
        raise AssertionError(f"policy script: {dec} {rev}, recompiles "
                             f"{eng.recompiles}, stream {rep.errors[:3]}, "
                             f"last loss {records[-1]['loss']}")
    switch = dec[0]["step"]                      # the first decision's step
    fused_steps = [r for r in records if r["kind"] == "sparse"
                   and r["step"] <= switch]
    pallas_steps = [r for r in records if r["kind"] == "sparse"
                    and r["step"] > switch]
    want = {"fused_ef_select": len(fused_steps),
            "fused_stats": len(pallas_steps),
            "multi_threshold_counts": 2 * len(pallas_steps)}
    got = {k: launches[k] for k in want}
    if (got != want or not fused_steps
            or (b1c["calls"], b3c["calls"], b4c["calls"]) != tuple(
                want.values())
            or b1c["shapes"] != {(1, padded)}
            or b3c["shapes"] != {(n,)} or b4c["shapes"] != {(n,)}):
        raise AssertionError(f"policy script: launches {launches}, want "
                             f"{want}; checked calls {b1c}, {b3c}, {b4c}")
    if [nt["numel"] for nt in notes] != [[padded, n], [n, n], [n, n]]:
        raise AssertionError(f"policy script: rebuilds {notes}")
    # the count contract on the pallas steps that trained, at each density
    bands = {}
    for r in pallas_steps:
        if r["skipped"]:
            continue
        ratio = r["num_selected"] / r["k"]
        bands.setdefault(r["k"], []).append(ratio)
        if abs(ratio - 1.0) > 0.05:
            raise AssertionError(f"policy script: step {r['step']} "
                                 f"num_selected / k = {ratio}")
    skipped = [r["step"] for r in records if r["skipped"]]
    spans = [e for e in events if e["event"] == "span"]
    rebuild_ms = [round(s["dur_ms"], 2) for s in spans
                  if s["name"] == "policy_rebuild"]
    apply_spans = [s for s in spans if s["name"] == "policy_apply"]
    saves = [s for s in spans if s["name"] == "checkpoint_save"]
    # the seal that follows each apply (the next save span after it)
    seal_ms = [round(next(s["dur_ms"] for s in saves
                          if s["t0"] >= a["t0"] + a["dur_ms"] / 1e3 - 1e-3),
                     2) for a in apply_spans[:2]]
    print(f"phase policy script: config 2 full width, --policy adaptive, "
          f"scripted rule: decisions "
          f"{[(d['step'], d['knob'], d['old'], d['new']) for d in dec]}, "
          f"revert {[(r['step'], r['knob'], r['new'], r['reason']) for r in rev]}"
          f" (quarantined), recompiles {eng.recompiles}; flat length "
          f"{[nt['numel'] for nt in notes]}, first n of parameter, momentum "
          f"and EF row bit for bit and the tail zero at each rebuild; "
          f"launches {got} (B1 on the {len(fused_steps)} fused sparse steps,"
          f" B3 once and B4 twice on each of the {len(pallas_steps)} pallas "
          f"steps, {skipped} skipped), every call held (B1, B4 bit for bit; "
          f"B3's max bit for bit, its sums within tolerance, "
          f"{b3c['nonfinite']} on a NaN gradient non-finite in both); "
          f"num_selected / k by k {{k: [min, max]}} "
          f"{ {k: [round(min(v), 4), round(max(v), 4)] for k, v in bands.items()} }"
          f"; policy_rebuild spans {rebuild_ms} ms (host clock around the "
          f"synchronised rebuild: {[round(nt['ms'], 2) for nt in notes]}); "
          f"the decisions' checkpoint seals {seal_ms} ms; stream strict "
          f"({rep.n_records} records); last loss "
          f"{records[-1]['loss']:.4f}")
    return {"launches": got, "err": b1c["err"], "b3_err": b3c["err"],
            "b4_err": b4c["err"], "rebuild_ms": rebuild_ms,
            "seal_ms": seal_ms}


def _copy_rate() -> float:
    """Bytes a second of one ``dst.copy_(src)`` of config 2's n floats (8n
    bytes moved), device time from a CUDA graph of 20 copies."""
    import torch
    n = 14_986_698
    src = torch.randn(n, device="cuda")
    dst = torch.empty_like(src)
    ms = _device_ms(lambda: dst.copy_(src))
    del src, dst
    return 8 * n / (ms / 1e3)


def _copy_floor() -> tuple:
    """Config 2's floor as phase 19b prices it: the reference's fused-path
    bytes (``12n + 16nc + 12k``) over ``_copy_rate()``. ``(floor_ms,
    bytes, nc, rate)``."""
    from gaussiank_sgd_torch.compressors import k_for
    from gaussiank_sgd_torch.ops import fused_select as fs
    rate = _copy_rate()
    n, density = 14_986_698, 0.001
    nc = fs._chunk_geometry(n, density)[3]
    floor_bytes = 12 * n + 16 * nc + 12 * k_for(n, density)
    return floor_bytes / rate * 1e3, floor_bytes, nc, rate


def _policy_rules_phase(tmp: str) -> dict:
    """Phase 19b: config 2 at full width under ``--policy adaptive`` with
    the shipped rules, 40 steps, ``--log-every 2``, the engine handed a
    floor priced from the reference's fused-path byte count (``12n + 16nc
    + 12k``, analysis/roofline.py) over the copy rate measured here, in
    place of the committed floor it loads (which must be there): the
    selector explores; each arm's steady step EMA, the decisions and the
    recompiles against the budget. B1 must launch exactly on the sparse
    steps run while ``gaussian_fused`` is on, each call bit for bit; the
    stream strictly valid."""
    import torch
    from gaussiank_sgd_torch.policy.rules import load_roofline_floor
    from gaussiank_sgd_torch.telemetry.events import validate_file
    floor_ms, floor_bytes, nc, rate = _copy_floor()
    notes = []
    with _b1_checked() as b1c:
        _reset_launches()
        t = _config(CONFIG2, [*POLICY_ARGV, "--max-steps", "40",
                              "--compress-warmup-steps", "4"],
                    "policy_rules", out_dir=tmp)
        # the trainer loads the committed floor priced on this card (phase
        # 20c holds it to a fresh pricing); 19b keeps its own
        loaded = t.engine._floor_ms
        if loaded is None or loaded != load_roofline_floor(
                "vgg16", "cuda", device_name=torch.cuda.get_device_name()):
            raise AssertionError(f"the trainer loaded the floor {loaded} on "
                                 f"the card")
        t.engine._floor_ms = floor_ms
        _noting_rebuilds(t, notes)
        t.train(t.total_steps)
        torch.cuda.synchronize()
        launches = _launches()
        records = list(t.records)
        snap = t.engine.signals.snapshot()
    t.close()
    rep = validate_file(t.metrics_path, strict=True)
    events = _events(t)
    dec = [(e["step"], e["knob"], e["old"], e["new"]) for e in events
           if e["event"] in ("policy_decision", "policy_revert")]

    def compressor(state_step: int) -> str:
        """The compressor a step starting at ``state_step`` ran: the last
        rebuild at or before it, else the configured one."""
        return next((nt["compressor"] for nt in reversed(notes)
                     if nt["step"] <= state_step), "gaussian_fused")

    fused = sum(1 for r in records if r["kind"] == "sparse"
                and compressor(r["step"] - 1) == "gaussian_fused")
    if (launches["fused_ef_select"] != fused or b1c["calls"] != fused
            or not rep.ok or not fused
            or t.engine.recompiles > t.engine._budget
            or not all(math.isfinite(r["loss"]) for r in records)):
        raise AssertionError(f"policy rules: B1 launches {launches}, "
                             f"{b1c['calls']} checked, {fused} fused sparse "
                             f"steps; stream {rep.errors[:3]}; decisions "
                             f"{dec}")
    arms = {arm: round(1e3 * v, 3) for arm, v in snap.arm_step_s.items()}
    print(f"phase policy rules: config 2 full width, --policy adaptive, 40 "
          f"steps (4 dense), log every 2; floor {floor_ms:.4f} ms = "
          f"{floor_bytes} B (12n + 16nc + 12k, nc {nc}) over the measured "
          f"copy rate {rate / 1e12:.3f} TB/s, beside the committed floor the "
          f"trainer loaded, {loaded} ms (its rate from the scale pass, "
          f"python -m gaussiank_sgd_torch.roofline); decisions and reverts "
          f"{dec}; "
          f"recompiles {t.engine.recompiles} of budget {t.engine._budget}; "
          f"steady step EMA by arm (ms) {arms} (intervals "
          f"{snap.arm_intervals}); rebuilds "
          f"{[(nt['step'], nt['compressor'], round(nt['ms'], 1)) for nt in notes]}; "
          f"B1 launches {launches['fused_ef_select']} = the {fused} sparse "
          f"steps under gaussian_fused, each bit for bit; stream strict "
          f"({rep.n_records} records)")
    return {"launches": launches["fused_ef_select"], "err": b1c["err"],
            "floor_ms": floor_ms, "loaded_floor_ms": loaded,
            "arms_ms": arms, "decisions": dec,
            "recompiles": t.engine.recompiles}


def _restored_ef_check(trainer, path: str, rank_: int) -> dict:
    """A pod worker's restore from ``path``, held against the checkpoint's
    rank files: at the writers' width the rank's own row, else
    ``sum_p(rows) / P'`` summed in row order (the order the CPU tests pin
    to the reference's ``jnp.sum``), bit for bit, with a zero pad."""
    import torch
    with open(os.path.join(path, "commit_manifest.json")) as f:
        old_p = int(json.load(f)["world"])
    new_p = trainer.world
    n = trainer.plan.total_numel
    rows = [torch.load(os.path.join(path, f"rank_{r:05d}.pt"),
                       weights_only=True)["ef_residual"]
            for r in (range(old_p) if old_p != new_p else [rank_])]
    want = rows[0].clone()
    for row in rows[1:]:
        want += row
    if old_p != new_p:
        want /= new_p
    ef = trainer.state.ef_residual.detach().cpu()
    equal = (torch.equal(_bits(ef[:n]), _bits(want))
             and not ef[n:].any())
    return {"path": os.path.basename(path), "old_p": old_p, "new_p": new_p,
            "equal": bool(equal), "nonzero": int((want != 0).sum())}


def _elastic_run(tmp: str, run_id: str) -> dict:
    """Phase 19c's pod: an ``ElasticSupervisor`` of 2 gloo ranks on this
    card, its workers ``chip_smoke.py --pod-worker I``, worker 1 SIGKILLed
    at the pull of step 3's batch in generation 0, then the schedule 2 ->
    3 at step 4 and 3 -> 2 at step 8."""
    from gaussiank_sgd_torch.service import ElasticSupervisor, ResizePolicy
    from gaussiank_sgd_torch.training import launch

    class ElasticPod(ElasticSupervisor):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.spawned = []

        def _worker_command(self, i):
            return [sys.executable, os.path.abspath(__file__),
                    "--pod-worker", str(i)]

        def _spawn(self, spec):
            self.spawned.append((time.time(), int(spec["nprocs"])))
            return super()._spawn(spec)

    import argparse
    from gaussiank_sgd_torch.training.config import add_args, from_args
    argv = [*ELASTIC_ARGV, "--output-dir", tmp, "--run-id", run_id]
    p = argparse.ArgumentParser()
    add_args(p)
    cfg = from_args(p.parse_args(argv), argv)
    sup = ElasticPod(cfg, launch.LaunchConfig(
        nprocs=2, dist_backend="gloo", grace_s=5.0, max_relaunches=2,
        kill_step=ELASTIC_KILL[0], kill_proc=ELASTIC_KILL[1]),
        os.path.join(tmp, run_id), job=run_id,
        policy=ResizePolicy(min_nprocs=1, max_nprocs=3, step_budget=10),
        resize_schedule=ELASTIC_SCHEDULE)
    t0 = time.time()
    rc = sup.run()
    end = time.time()
    pod = sup.pod_dir
    with open(os.path.join(pod, "supervisor.jsonl")) as f:
        records = [json.loads(line) for line in f]
    notes = {}
    for name in sorted(os.listdir(pod)):
        if name.startswith("check_gen") and name.endswith(".json"):
            with open(os.path.join(pod, name)) as f:
                notes[name[len("check_"):-len(".json")]] = json.load(f)
    return {"rc": rc, "records": records, "spawned": sup.spawned, "t0": t0,
            "end": end, "notes": notes, "pod": pod}


def _elastic_entry_point(tmp: str) -> float:
    """One short job through ``python -m gaussiank_sgd_torch.service``: 2
    gloo ranks on this card, 2 -> 1 at step 4, 6 steps: exit 0, one
    ``resize_commit``, every stream strictly valid. Returns its wall."""
    from gaussiank_sgd_torch.telemetry.events import validate_file
    argv = [sys.executable, "-m", "gaussiank_sgd_torch.service",
            "--nprocs", "2", "--dist-backend", "gloo", "--grace", "5",
            "--resize-step-budget", "10", "--resize-at", "4:1",
            *ELASTIC_ARGV, "--max-steps", "6", "--output-dir", tmp,
            "--run-id", "service_entry"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    pod = os.path.join(tmp, "service_entry")
    _keep_pod_files(pod, "service_entry")
    with open(os.path.join(pod, "supervisor.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    commits = [(r["from_nprocs"], r["to_nprocs"]) for r in recs
               if r["event"] == "resize_commit"]
    reps = [validate_file(os.path.join(pod, name), strict=True)
            for name in ["supervisor.jsonl"] + [
                f"proc{i:03d}/metrics.jsonl" for i in range(2)]]
    if proc.returncode != 0 or commits != [(2, 1)] or not all(
            r.ok for r in reps):
        raise AssertionError(f"service entry point: exit {proc.returncode},"
                             f" commits {commits}, "
                             f"{[r.errors[:3] for r in reps]}: "
                             f"{proc.stderr[-3000:]}")
    print(f"phase elastic entry point: python -m gaussiank_sgd_torch.service "
          f"--nprocs 2 --dist-backend gloo --resize-at 4:1, config 2, 6 "
          f"steps: exit 0 in {wall:.1f} s, resize_commit {commits}, "
          f"supervisor and both workers' streams strictly valid "
          f"({[r.n_records for r in reps]} records)")
    return wall


def _elastic_phase() -> dict:
    """Phase 19c: the elastic service, 2 -> 3 -> 2, on config 2 at full
    width (see ``_elastic_run``), then the real entry point."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        run = _elastic_run(tmp, "elastic")
        _keep_pod_files(run["pod"], "elastic")
        out = _elastic_checks(run)
        out["entry_s"] = _elastic_entry_point(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _elastic_checks(run: dict) -> dict:
    recs, pod = run["records"], run["pod"]
    lost = [r for r in recs if r["event"] == "worker_lost"]
    rel = [r for r in recs if r["event"] == "worker_relaunch"]
    commits = [r for r in recs if r["event"] == "resize_commit"]
    if (run["rc"] != 0
            or not any(r["worker"] == ELASTIC_KILL[1]
                       and r.get("exit_code") == -9 for r in lost)
            or [r["nprocs"] for r in rel] != [2, 3, 2]
            or [(r["from_nprocs"], r["to_nprocs"]) for r in commits]
            != [(2, 3), (3, 2)]
            or any(r["steps_lost"] > 10 for r in commits)):
        raise AssertionError(f"elastic: exit {run['rc']}, records {recs}")
    streams = sorted(os.path.join(pod, d, "metrics.jsonl")
                     for d in os.listdir(pod) if d.startswith("proc"))
    sup_path = os.path.join(pod, "supervisor.jsonl")
    rc_val, val_out = _cli(["validate", sup_path, "--strict"])
    merged = os.path.join(pod, "merged.jsonl")
    rc_merge, merge_out = _cli(["merge", *streams, sup_path, "-o", merged,
                                "--strict"])
    rc_health, health_out = _cli(["health", sup_path])
    shutil.copy(merged, os.path.join(RUN_DIR, "pod", "elastic"))
    if rc_val != 0 or rc_merge != 0 or rc_health not in (1, 2):
        raise AssertionError(f"elastic: validate {rc_val} {val_out}; merge "
                             f"{rc_merge} {merge_out}; health {rc_health} "
                             f"{health_out}")
    notes = run["notes"]
    gens = sorted({n["generation"] for n in notes.values()})
    last = [notes[f"gen{gens[-1]:02d}_proc{i:03d}"] for i in range(2)]
    if (len({n["sha"] for n in last}) != 1 or last[0]["sha"] is None
            or any(n["step"] != 12 for n in last)):
        raise AssertionError(f"elastic: final parameters "
                             f"{[(n['sha'], n['step']) for n in last]}")
    padded = EXCHANGE_WANT["whole bucket"][2][2]
    for name, n in notes.items():
        if n["launches"] != n["b1_calls"] or n["shapes"] not in (
                [], [[1, padded]]):
            raise AssertionError(f"elastic: {name}: {n}")
    # every restore held against the sealed checkpoint's rank files: the
    # resizes redistribute (P != P'), the relaunch after the kill at the
    # same width keeps each rank's row
    ef = {name: n["ef"] for name, n in notes.items() if n.get("ef")}
    resized = [v for v in ef.values() if v["old_p"] != v["new_p"]]
    if (not all(v["equal"] for v in ef.values())
            or sorted({(v["old_p"], v["new_p"]) for v in resized})
            != [(2, 3), (3, 2)]
            or sum(1 for v in resized) != 5):
        raise AssertionError(f"elastic: restored EF rows {ef}")
    spawned = run["spawned"]
    walls = [round(b[0] - a[0], 1) for a, b in
             zip(spawned, spawned[1:] + [(run["end"], 0)])]
    b1 = {name: n["b1_calls"] for name, n in notes.items()}
    print(f"phase elastic: config 2 full width, ElasticSupervisor, gloo on "
          f"this card, 6,144 synthetic images, worker 1 SIGKILLed at the "
          f"pull of step {ELASTIC_KILL[0]}'s batch in generation 0, "
          f"--resize-at 4:3 8:2: worker_lost "
          f"{[(r['worker'], r.get('exit_code')) for r in lost]}, relaunches "
          f"at {[r['nprocs'] for r in rel]}, commits "
          f"{[(r['from_nprocs'], r['to_nprocs'], r['steps_lost'], r['duration_s'], os.path.basename(r['checkpoint'])) for r in commits]}"
          f" (from, to, steps lost, duration_s, checkpoint), exit 0; "
          f"generations (width, wall s) "
          f"{[(w[1], s) for w, s in zip(spawned, walls)]}; supervisor.jsonl "
          f"strict, merged stream strict "
          f"({merge_out.strip().splitlines()[-1]}), health exit {rc_health}"
          f"; restored EF rows bit for bit against the rank files "
          f"{ {k: (v['path'], v['old_p'], v['new_p']) for k, v in ef.items()} }"
          f"; final parameters of both ranks sha256 {last[0]['sha'][:16]}; "
          f"B1 calls held bit for bit (= launches) by generation and rank "
          f"{b1}")
    return {"launches": sum(b1.values()), "runs": b1,
            "err": max(n["b1_err"] for n in notes.values()),
            "gen_s": walls,
            "resize_s": [r["duration_s"] for r in commits]}


def _policy_elastic_phase() -> dict:
    """Phase 19: the adaptive policy engine (a, b) and the elastic service
    (c)."""
    import torch
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_policy_")
    try:
        script = _policy_script_phase(tmp)
        torch.cuda.empty_cache()
        rules = _policy_rules_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    elastic = _elastic_phase()
    print(f"phase policy and elastic: {time.perf_counter() - t0:.1f} s")
    return {"script": script, "rules": rules, "elastic": elastic}


# ------------------------------------------ phase 20: the headline bench

# the bench's windows in 20a and 20b: 1 of its 2, so that the script with
# phase 21 stays inside its time (the launches are derived from it)
HEADLINE_WINDOWS = 1

def _headline_want(overlap_arm: bool = False) -> dict:
    """The kernel launches the bench driver's run must make, by config,
    derived from its tables: a program of the fixed selector runs one
    warm-up call and ``rounds x WINDOWS`` timed calls of ``n_steps``
    sparse steps, each one B1 launch on the whole-model bucket (B2 where
    the fused-EF gate refuses the plan); the overlap arm's four programs
    (both schedules and their exchange-less twins) on the uniform
    4,194,304-element plan launch one B1 a step sequentially and one a
    chunk pipelined. ``{key: {kernel: launches}}``."""
    from gaussiank_sgd_torch import bench
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.trainstep import fused_ef_layout
    spec = get_compressor(bench.FIXED, density=0.001)
    want = {}
    for key, model, dataset, _, n_steps, rounds in bench.CONFIGS:
        layout = get_model(model, dataset, device="meta").module.param_layout
        steps = n_steps * (1 + rounds * bench.WINDOWS)
        fused = fused_ef_layout(spec, plan_for_params(layout, 0.001))
        kernel = "fused_ef_select" if fused else "fused_select"
        want[key] = {kernel: steps}
        if overlap_arm:
            plan = plan_for_params(layout, 0.001, 1 << 22, policy="uniform")
            chunks = len(plan.buckets)
            if fused_ef_layout(spec, plan) is None:
                raise AssertionError(f"{key}: the overlap arm's plan is not "
                                     f"fused")
            want[f"{key} overlap"] = {"fused_ef_select":
                                      steps * 2 * (1 + chunks)}
    return want


def _b1_padded_check(key: str, n: int, chunk_pad: int, gen,
                     density: float = 0.001) -> float:
    """One B1 call at a model's padded EF row ``[1, chunk_pad]`` (``n``
    random live entries, a zero tail) at a warm threshold, bit for bit
    against its plain version; the max abs error (0.0)."""
    import torch
    from gaussiank_sgd_torch.compressors import k_for
    from gaussiank_sgd_torch.ops import fused_select as fs
    dev = gen.device
    res = torch.zeros(1, chunk_pad, device=dev)
    g = torch.zeros(1, chunk_pad, device=dev)
    res[:, :n] = torch.randn(1, n, device=dev, generator=gen) * 0.01
    g[:, :n] = torch.randn(1, n, device=dev, generator=gen) * 0.01
    _, warm = fs.gaussian_fused_ef_compress_batched(
        res, g, 1.0, k_for(n, density), torch.zeros(1, device=dev),
        density=density)
    out = fs.fused_ef_select_candidates_chunked(res, g, 1.0, warm, density)
    ref = fs.fused_ef_select_plain(res, g, 1.0, warm, density)
    torch.cuda.synchronize()
    err = _same(out, ref, f"B1 {key} [1, {chunk_pad}] density {density}")
    print(f"phase B1 {key} [1, {chunk_pad}] density {density} warm: t="
          f"{float(warm[0]):.6g}, count {int(out[3][0])}, bit-identical "
          f"(acc, vals, idx, counts)")
    return err


def _headline_worker(mode: str, d: str) -> int:
    """One fresh process of phase 20a (``full``: every config, as the
    reference runs them) or 20b (``vgg16``: vgg16 alone with the overlap
    arm): ``gaussiank_sgd_torch.bench.main`` with its history in ``d``,
    its B1 and B2 launches by config held to the derived counts, then one
    B1 call at each config's padded row bit for bit; a summary in
    ``d/summary.json``."""
    import torch
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch import bench, benchlib
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.trainstep import fused_ef_layout
    overlap = mode == "vgg16"
    argv = ["--history", os.path.join(d, "history.jsonl"), "--out-dir", d]
    if overlap:
        argv += ["--configs", "vgg16", "--overlap-arm"]
    runs = {}
    models = {model: key for key, model, *_ in bench.CONFIGS}

    def counted(fn, suffix):
        def run(model, *args, **kw):
            _reset_launches()
            out = fn(model, *args, **kw)
            torch.cuda.synchronize()
            runs[models[model] + suffix] = _launches()
            return out
        return run

    benchlib.bench_model = counted(benchlib.bench_model, "")
    benchlib.bench_overlap = counted(benchlib.bench_overlap, " overlap")
    bench.WINDOWS = HEADLINE_WINDOWS
    t0 = time.perf_counter()
    result = bench.main(argv)
    wall = time.perf_counter() - t0
    want = {k: v for k, v in _headline_want(overlap).items()
            if k.split()[0] in result["detail"]["configs"]}
    for key, w in want.items():
        got = runs.get(key, {})
        for kernel in ("fused_ef_select", "fused_select",
                       "fused_stats", "multi_threshold_counts"):
            if got.get(kernel, 0) != w.get(kernel, 0):
                raise AssertionError(f"headline {key}: launches {got}, want "
                                     f"{w}")
        if "fused_select" in w:
            print(f"phase headline {key}: the fused-EF gate refused the "
                  f"plan; B2 took the {w['fused_select']} launches")
    for key, cell in result["detail"]["configs"].items():
        print(f"phase headline {key}: ratio_window_min "
              f"{cell['ratio_window_min']} (windows "
              f"{cell['window_medians']}), ratio_median "
              f"{cell['ratio_median']}, round spread [{cell['ratio_min']}, "
              f"{cell['ratio_max']}] over {cell['rounds']} rounds, dense "
              f"{cell['dense_step_ms']} ms, sparse {cell['sparse_step_ms']} "
              f"ms, MFU dense {cell['mfu_dense']} sparse "
              f"{cell['mfu_sparse']}, overhead {cell['overhead_ms']} ms = "
              f"{cell.get('overhead_vs_floor')} x floor "
              f"{cell.get('roofline_floor_ms')} ms; launches "
              f"{runs[key]}" + (f"; overlap arm {cell['overlap_arm']}, "
                                f"launches {runs[key + ' overlap']}"
                                if "overlap_arm" in cell else ""))
    # after the timed runs, one B1 call at each config's padded row
    gen = torch.Generator(device="cuda").manual_seed(20)
    spec = get_compressor(bench.FIXED, density=0.001)
    err = 0.0
    for key, model, dataset, *_ in bench.CONFIGS:
        if key not in result["detail"]["configs"]:
            continue
        net = get_model(model, dataset, device="meta").module
        layout = fused_ef_layout(spec, plan_for_params(net.param_layout,
                                                       0.001))
        err = max(err, _b1_padded_check(key, net.n_params, layout[2], gen))
        torch.cuda.empty_cache()
    print(f"phase headline {mode}: {wall:.1f} s for bench.main, "
          f"{time.perf_counter() - t0:.1f} s with the checks")
    with open(os.path.join(d, "summary.json"), "w") as f:
        json.dump({"result": result, "runs": runs, "want": want,
                   "err": err, "wall": wall}, f)
    return 0


def _headline_child(mode: str) -> dict:
    """Phase 20a or 20b in a fresh process (``--headline-worker``); its
    output printed here; its summary."""
    d = os.path.join(RUN_DIR, f"headline_{mode}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--headline-worker", mode, d],
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        print(f"  [{mode}] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"headline {mode}: exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(os.path.join(d, "summary.json")) as f:
        out = json.load(f)
    out["process_s"] = time.perf_counter() - t0
    return out


def _headline_floor_phase(kind: str) -> dict:
    """Phase 20c: the floor re-priced on this card against the committed
    artifact (bytes, k and nc exactly, floors within 5%); the loader's
    floors on the card; 19b's floor (config 2's bytes over the copy
    rate) beside the loaded vgg16 floor."""
    from gaussiank_sgd_torch import roofline
    from gaussiank_sgd_torch.policy.rules import load_roofline_floor
    with open(os.path.join(roofline.ARTIFACTS, "roofline.json")) as f:
        committed = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        fresh = roofline.main(["--out", os.path.join(tmp, "roofline.json")])
    gaps = {}
    for key, cell in committed["configs"].items():
        new = fresh["configs"][key]
        for field in ("params", "k", "candidates", "fused_bytes",
                      "unfused_bytes", "exchange_bytes_allgather",
                      "exchange_bytes_gtopk"):
            if new[field] != cell[field]:
                raise AssertionError(f"floor {key}: {field} {new[field]} != "
                                     f"the committed {cell[field]}")
        gaps[key] = new["floor_ms"] / cell["floor_ms"] - 1
        if abs(gaps[key]) > 0.05:
            raise AssertionError(f"floor {key}: {new['floor_ms']} ms vs the "
                                 f"committed {cell['floor_ms']} ms")
    loaded = {}
    for key, model, _ in roofline.CONFIG_MODELS:
        loaded[key] = load_roofline_floor(model, "cuda", device_name=kind)
        if loaded[key] != committed["configs"][key]["floor_ms"]:
            raise AssertionError(f"loader {model}: {loaded[key]}")
    if load_roofline_floor("mnistnet", "cuda", device_name=kind) is not None:
        raise AssertionError("the loader gave mnistnet a floor")
    copy_floor, _, _, rate = _copy_floor()
    print(f"phase headline floor: re-priced at {fresh['bandwidth_gbps']} "
          f"GB/s (rounds {fresh['bandwidth_rounds_gbps']}) against the "
          f"committed {committed['bandwidth_gbps']} GB/s "
          f"({committed['device']}, {committed['power_limit']}): bytes, k "
          f"and nc equal for all five, floors within "
          f"{max(abs(v) for v in gaps.values()):.2%} ("
          + ", ".join(f"{k} {fresh['configs'][k]['floor_ms']} vs "
                      f"{committed['configs'][k]['floor_ms']} ms"
                      for k in committed["configs"])
          + f"); the loader on {kind!r}: {loaded}, mnistnet None; 19b's "
          f"floor (copy rate {rate / 1e12:.3f} TB/s) {copy_floor:.4f} ms "
          f"beside the loaded vgg16 {loaded['vgg16']} ms")
    return {"bandwidth_gbps": fresh["bandwidth_gbps"],
            "floors_ms": {k: c["floor_ms"]
                          for k, c in fresh["configs"].items()},
            "copy_floor_ms": copy_floor, "loaded": loaded}


def _headline_sentinel_phase() -> dict:
    """Phase 20d: the sentinel on the committed history: ``--self-test``
    exits 0, the plain comparison prints its table and exit code,
    ``--emit-event`` a strictly valid record."""
    from gaussiank_sgd_torch.telemetry import sentinel
    from gaussiank_sgd_torch.telemetry.events import validate_file
    if sentinel.main(["--self-test"]) != 0:
        raise AssertionError("sentinel --self-test failed on the committed "
                             "history")
    rc = sentinel.main([])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "verdict.jsonl")
        rc_emit = sentinel.main(["--emit-event", path])
        rep = validate_file(path, strict=True)
        with open(path) as f:
            verdict = json.loads(f.read().strip())
    if rc_emit != rc or not rep.ok or verdict["event"] != "bench_regression":
        raise AssertionError(f"sentinel --emit-event: rc {rc_emit}, "
                             f"{rep.errors[:3]}, {verdict}")
    print(f"phase headline sentinel: its self-test 0, its comparison of "
          f"the committed history exit {rc} ({verdict['status']}: "
          f"{verdict['baseline_rev']} -> {verdict['new_rev']}), the emitted "
          f"record strictly valid")
    return {"sentinel_rc": rc, "sentinel_status": verdict["status"]}


def _headline_phase(kind: str) -> dict:
    """Phase 20: the headline bench driver on all five configs in a fresh
    process, vgg16 alone with the overlap arm in another, the card-priced
    floor and its loader, and the sentinel."""
    import torch
    t0 = time.perf_counter()
    full = _headline_child("full")
    torch.cuda.empty_cache()
    alone = _headline_child("vgg16")
    d_full = full["result"]["detail"]["configs"]["vgg16"]
    d_alone = alone["result"]["detail"]["configs"]["vgg16"]
    print(f"phase headline vgg16 alone: dense step {d_alone['dense_step_ms']}"
          f" ms in a fresh process beside {d_full['dense_step_ms']} ms in "
          f"20a's run of all five (after resnet20); sparse "
          f"{d_alone['sparse_step_ms']} vs {d_full['sparse_step_ms']} ms; "
          f"ratio_window_min {d_alone['ratio_window_min']} vs "
          f"{d_full['ratio_window_min']}")
    arm = d_alone["overlap_arm"]
    if (arm["pipe_overlap"], arm["seq_overlap"]) != ("pipelined", "off") \
            or not arm["overlapped_bytes_sent"] or arm["n_buckets"] != 4:
        raise AssertionError(f"overlap arm {arm}")
    floor = _headline_floor_phase(kind)
    rest = _headline_sentinel_phase()
    wall = time.perf_counter() - t0
    print(f"phase headline: {wall:.1f} s (20a {full['process_s']:.1f} s, "
          f"20b {alone['process_s']:.1f} s, with the processes' start); the "
          f"value {full['result']['value']} "
          f"({full['result']['detail']['worst_config']})")
    runs = {f"20a {k}": v for k, v in full["runs"].items()}
    runs.update({f"20b {k}": v for k, v in alone["runs"].items()})
    return {"runs": runs, "err": max(full["err"], alone["err"]),
            "value": full["result"]["value"],
            "worst_config": full["result"]["detail"]["worst_config"],
            "floor": floor, "sentinel_rc": rest["sentinel_rc"],
            "wall_s": wall}


# ------------------------- phase 21: the lint tiers' step audit, the A/B
# harness and convergence parity

CONVERGENCE_ARGV = ["--nprocs", "2", "--steps", "300", "--density", "0.01",
                    "--batch-size", "8", "--lr", "0.005",
                    "--compress-warmup-steps", "10", "--arms",
                    "none,gaussian,topk,gaussian@gtopk,gaussian_fused"]


def _audit_phase() -> dict:
    """Phase 21a: ``lint audit`` on the card in an NCCL group of one:
    every arm's host syncs a warm step beside its allow-list, its
    collective inventory (equal to the committed
    ``.gklint-torch-programs.json``), both identities bit for bit; then the
    ``gaussian_fused`` arm again at density 1/32, where its kernels
    launch, with each B1/B2 call held bit for bit against its plain
    version as it runs."""
    import torch
    from gaussiank_sgd_torch.lint import program_audit as pa
    t0 = time.perf_counter()
    _reset_launches()
    report = pa.run_audit(device="cuda")
    torch.cuda.synchronize()
    launches = _launches()
    inv_bad, inv_warn = pa.compare_programs(
        report, pa.load_programs(pa.default_programs_path()))
    if report["violations"] or inv_bad or inv_warn \
            or report["backend"] != "nccl":
        raise AssertionError(f"audit on the card ({report['backend']}): "
                             f"{report['violations'] + inv_bad + inv_warn}")
    for name, arm in report["arms"].items():
        coll = ", ".join(f"{k} {v['total']:g} ({v['in_pipeline']:g} in the "
                         f"pipelined phase)"
                         for k, v in arm["collectives"].items())
        print(f"phase lint audit {name}: wire {arm['wire_format']}, overlap "
              f"{arm['overlap']}, {arm['n_buckets']} bucket(s); host syncs "
              f"a warm step {arm['syncs'] or 'none'}, allowed "
              f"{arm['syncs_allowed'] or 'none'}; a step: {coll}")
    for ident in report["identities"]:
        print(f"phase lint audit identity {ident['group']}: same build "
              f"{ident['same_build']}, bit for bit {ident['same_bits']} "
              f"({', '.join(ident['arms'])})")
    # the arm's density 0.0625 is above B1's 1/32: gaussian_fused runs its
    # warm fallback there, as the reference's, and launches no kernel. So
    # the arm runs again at 1/32: on its own 128-element buckets, which the
    # fused-EF gate refuses (B2 a bucket), and on 2,048-element ones, which
    # it takes (B1 a chunk); every call held bit for bit as it runs.
    name = "gaussian_fused_pipe_wire"
    runs = {"audit": launches}
    err = 0.0
    # the kernel each bucket size must launch: B2 on 128, B1 on 2,048
    for bucket, kernel in ((128, "fused_select"), (2048, "fused_ef_select")):
        spec = dict(pa.ARMS[name], density=1 / 32, bucket_size=bucket)
        _reset_launches()
        with _b1_checked() as b1, _b2_checked() as b2:
            with pa._group_of_one(torch.device("cuda")):
                arm = pa.run_arm(name, spec, torch.device("cuda"),
                                 count_syncs=False)
        torch.cuda.synchronize()
        got = _launches()
        key = f"audit {name} 1/32 {bucket}"
        runs[key] = got
        build = (arm["wire_format"], arm["overlap"])
        if build != ("u16bf16", "pipelined") or got[kernel] == 0 \
                or (got["fused_ef_select"], got["fused_select"]) \
                != (b1["calls"], b2["calls"]):
            raise AssertionError(f"{key}: {build}, launches {got}, checked "
                                 f"B1 {b1['calls']}, B2 {b2['calls']}")
        err = max(err, b1["err"], b2["err"])
        print(f"phase lint audit {name} at density 1/32 on "
              f"{arm['n_buckets']} {bucket}-element buckets ({build[0]}, "
              f"{build[1]}): B1 {b1['calls']} call(s) at "
              f"{sorted(b1['shapes'])}, B2 {b2['calls']} at "
              f"{sorted(b2['shapes'])}, each held bit for bit")
    print(f"phase lint audit: the audit's own launches {launches} (its "
          f"{name} at density {pa.ARMS[name]['density']} runs the warm "
          f"fallback); {time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "err": err,
            "syncs": {n: a["syncs"] for n, a in report["arms"].items()}}


def _ab_phase() -> dict:
    """Phase 21b: ``policy_ab --measure`` on the card: ``bench_matrix``'s
    quick matrix at most 10 steps a timed run over the five BASELINE
    configs (B1's launches by config equal to the derived counts: a
    warm-up and 3 timed rounds of min(n_steps, 10) sparse steps on the
    ``gaussian_fused`` cell), then the replay against the card-priced
    floor; its acceptance block and decision log printed; then one
    untimed B1 call at each config's padded row, bit for bit."""
    import torch
    from gaussiank_sgd_torch import bench_matrix, benchlib, policy_ab
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.trainstep import fused_ef_layout
    d = os.path.join(RUN_DIR, "policy_ab")
    shutil.rmtree(d, ignore_errors=True)
    models = {row[1]: row[0] for row in bench_matrix.CONFIGS}
    runs = {}
    real = benchlib.bench_model

    def counted(model, *args, **kw):
        _reset_launches()
        out = real(model, *args, **kw)
        torch.cuda.synchronize()
        runs[models[model]] = _launches()
        return out

    t0 = time.perf_counter()
    benchlib.bench_model = counted
    try:
        result = policy_ab.run(["--measure", "--device", "cuda",
                                "--out-dir", d])
    finally:
        benchlib.bench_model = real
    wall = time.perf_counter() - t0
    spec = get_compressor("gaussian_fused", density=0.001)
    gen = torch.Generator(device="cuda").manual_seed(21)
    err = 0.0
    for name, model, dataset, _, _, n_steps, policy, bsize in \
            bench_matrix.CONFIGS:
        net = get_model(model, dataset, device="meta").module
        fused = fused_ef_layout(spec, plan_for_params(
            net.param_layout, 0.001, bsize, policy=policy))
        want = dict.fromkeys(("fused_ef_select", "fused_select",
                              "fused_stats", "multi_threshold_counts"), 0)
        want["fused_ef_select" if fused else "fused_select"] = 4 * min(
            n_steps, policy_ab.MEASURE_STEPS)
        if runs.get(name) != want:
            raise AssertionError(f"policy_ab {name}: launches "
                                 f"{runs.get(name)}, want {want}")
        # the timed runs are not checked call by call: one untimed B1 call
        # at the config's padded row, as 20a holds them
        if fused is None or fused[0] != 1:
            raise AssertionError(f"policy_ab {name}: the gaussian_fused "
                                 f"cell's plan is {fused}, not one fused "
                                 f"whole-model bucket")
        err = max(err, _b1_padded_check(name, net.n_params, fused[2], gen))
        torch.cuda.empty_cache()
    for key, row in result["configs"].items():
        print(f"phase lint policy_ab {key}: dense {row['dense_ms']} ms; "
              f"fixed ratios "
              + ", ".join(f"{a} {v['ratio_median']}"
                          for a, v in row["fixed"].items())
              + f"; adaptive median {row['adaptive']['ratio_median']} mean "
              f"{row['adaptive']['ratio_mean']} ({row['adaptive']['start_arm']}"
              f" -> {row['adaptive']['final_arm']}, "
              f"{row['adaptive']['recompiles']} rebuild(s)); floor "
              f"{row['floor_ms']} ms ({row['floor_source']}); launches "
              f"{runs[key]}")
    for dec in result["decision_log"]:
        print(f"phase lint policy_ab decision {dec['config']} step "
              f"{dec['step']}: {dec['event']} {dec['knob']} {dec['old']} -> "
              f"{dec['new']} ({dec['reason']})")
    acc = {k: v for k, v in result["acceptance"].items()
           if k != "strict_wins_sample"}
    print(f"phase lint policy_ab acceptance: {json.dumps(acc)}; "
          f"{len(result['decision_log'])} decision(s); {wall:.1f} s")
    return {"runs": runs, "acceptance": acc, "err": err,
            "decisions": len(result["decision_log"]), "wall_s": wall}


def _convergence_phase() -> dict:
    """Phase 21c: ``convergence_parity`` at the committed artifact's
    settings (mnistnet, density 0.01, 300 steps, batch 8, lr 0.005, 10
    dense steps) on 2 gloo ranks on this card (the reference's ran 8):
    each compressed arm within the reference's bound against the dense
    arm (top-1 >= dense - 0.03, val loss < 0.2); B1 (or B2, where the
    fused-EF gate refuses the plan) once a sparse step a rank on the
    ``gaussian_fused`` arm and no kernel on the others."""
    from gaussiank_sgd_torch import convergence_parity
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.trainstep import fused_ef_layout
    d = os.path.join(RUN_DIR, "convergence")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    out = convergence_parity.run([*CONVERGENCE_ARGV, "--device", "cuda",
                                  "--out-dir", d, "--tag", "card"])
    wall = time.perf_counter() - t0
    with open(os.path.join(REPO, "analysis", "artifacts",
                           "convergence_parity.json")) as f:
        ref = {a["arm"]: a for a in json.load(f)["arms"]}
    arms = {a["arm"]: a for a in out["arms"]}
    dense = arms["dense"]
    import torch
    spec = get_compressor("gaussian_fused", density=0.01)
    net = get_model("mnistnet", "mnist", device="meta").module
    fused = fused_ef_layout(spec, plan_for_params(net.param_layout, 0.01))
    sparse_steps = 300 - 10
    runs = {}
    for name, arm in arms.items():
        if arm["val_loss"] >= 0.2 or (
                name != "dense" and arm["top1"] < dense["top1"] - 0.03):
            raise AssertionError(f"convergence {name}: {arm} against dense "
                                 f"{dense}")
        want = dict.fromkeys(("fused_ef_select", "fused_select",
                              "fused_stats", "multi_threshold_counts"), 0)
        if name == "gaussian_fused":
            want["fused_ef_select" if fused else "fused_select"] = \
                sparse_steps
        for r, got in enumerate(out["launches"][name]):
            if got != want:
                raise AssertionError(f"convergence {name} rank {r}: "
                                     f"launches {got}, want {want}")
            runs[f"{name} rank {r}"] = got
        base = ref.get(name)
        run0 = out["seed_runs"][name][0]
        print(f"phase lint convergence {name}: final loss "
              f"{run0['final_loss']:.6g}, val loss {run0['val_loss']:.6g}, "
              f"top-1 {arm['top1']}, {arm['bytes_per_step']} B a step "
              f"({arm['wire_format']}) at 2 ranks"
              + (f"; the reference's at 8 ranks: {base['final_loss']:.6g}, "
                 f"{base['val_loss']:.6g}, {base['top1']}, "
                 f"{base['bytes_per_step']} B" if base else "")
              + f"; launches a rank {out['launches'][name][0]}")
    # the ranks' calls are in their own processes, unchecked: one B1 call
    # here at the arm's padded row and density
    if fused is None:
        raise AssertionError("convergence: the gaussian_fused arm's plan "
                             "is not fused")
    err = _b1_padded_check("mnistnet", net.n_params, fused[2],
                           torch.Generator(device="cuda").manual_seed(22),
                           density=0.01)
    print(f"phase lint convergence: 2 ranks (the reference's 8), every "
          f"compressed arm within top-1 >= dense - 0.03 and val loss < 0.2; "
          f"{wall:.1f} s")
    return {"runs": runs, "wall_s": wall, "err": err,
            "arms": {n: dict(out["seed_runs"][n][0],
                             bytes_per_step=a["bytes_per_step"])
                     for n, a in arms.items()}}


def _lint_phase() -> dict:
    """Phase 21: the step audit, the A/B harness on the card's matrix and
    convergence parity."""
    import torch
    t0 = time.perf_counter()
    audit = _audit_phase()
    torch.cuda.empty_cache()
    ab = _ab_phase()
    torch.cuda.empty_cache()
    conv = _convergence_phase()
    wall = time.perf_counter() - t0
    print(f"phase lint: {wall:.1f} s (21b {ab['wall_s']:.1f} s, 21c "
          f"{conv['wall_s']:.1f} s)")
    runs = {f"21a {k}": v for k, v in audit["runs"].items()}
    runs.update({f"21b {k}": v for k, v in ab["runs"].items()})
    runs.update({f"21c {k}": v for k, v in conv["runs"].items()})
    return {"runs": runs, "err": max(audit["err"], ab["err"], conv["err"]),
            "acceptance": ab["acceptance"],
            "convergence": conv["arms"], "syncs": audit["syncs"],
            "wall_s": wall}


# ------------------------------------ phase 22: kernel B5 (BatchNorm)

# the models whose BatchNorms phase 22 checks and times, at the cells'
# batches (lstman4 at batch 16): (dnn, dataset, batch, one input's shape)
B5_MODELS = (("resnet50", "imagenet", 64, (224, 224, 3)),
             ("vgg16", "cifar10", 1024, (32, 32, 3)),
             ("lstman4", None, 16, (161, 200)))
# relative L2 limits of B5 against its plain version (see
# tests/test_torch_kernels_cuda.py): y, running mean, running var, dx,
# d scale, d bias
B5_LIMITS = (1e-5, 1e-5, 1e-5, 2e-4, 1e-4, 1e-4)
_OPS_BN = 10             # B5's operations an element, both directions


def _b5_model_shapes(dnn: str, dataset, batch: int, image) -> dict:
    """Each BatchNorm input of ``dnn``'s train-mode forward in bf16 on the
    card, as the model hands it on: ``{(shape, strides, axis): count}``."""
    import torch
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.models.flat import FlatModel
    seen: dict = {}
    orig = FlatModel._batch_norm

    def record(self, p, x, name, train, axis=1):
        key = (tuple(x.shape), tuple(x.stride()), axis)
        seen[key] = seen.get(key, 0) + 1
        return orig(self, p, x, name, train, axis)

    model = get_model(dnn, dataset, dtype=torch.bfloat16,
                      device="cuda").module
    FlatModel._batch_norm = record
    try:
        with torch.no_grad():
            model(torch.zeros(batch, *image, device="cuda"), train=True)
    finally:
        FlatModel._batch_norm = orig
    del model
    return seen


def _b5_shape(key, count: int, mem_rate: float, gen) -> dict:
    """B5 at one BatchNorm input layout: against its plain version within
    ``B5_LIMITS``, its launches counted, then timed: forward and backward
    device time (``_device_ms``), the eager forward + backward through
    autograd with its launches (``_median_ms``), the plain version's and
    ``torch.batch_norm``'s the same way (a yardstick; the port never calls
    it), beside the bound of 14 B an element for bf16 (x read and y
    written forward; dy and x read and dx written backward)."""
    import torch
    from gaussiank_sgd_torch.ops import batch_norm as B
    shape, strides, axis = key
    dev = torch.device("cuda")
    c = shape[axis]
    x = torch.empty_strided(shape, strides, dtype=torch.bfloat16,
                            device=dev)
    x.copy_(torch.randn(shape, device=dev, generator=gen) * 1.5 + 0.3)
    scale = torch.randn(c, device=dev, generator=gen) * 0.5 + 1.0
    bias = torch.randn(c, device=dev, generator=gen) * 0.1
    stats = torch.rand(2, c, device=dev, generator=gen) + 0.5
    # dy in y's layout, as the next layer's backward hands it on, and
    # affine in x per channel besides its noise, so dx's mean and variance
    # terms cancel most of dy * mul at every M
    view = [1] * len(shape)
    view[axis] = c
    slope = torch.randn(c, device=dev, generator=gen).view(view)
    g = torch.empty_strided(shape, strides, device=dev).copy_(
        x.float() * slope + 0.5 * torch.randn(shape, device=dev,
                                              generator=gen))

    def both(fn):
        xx = x.detach().clone().requires_grad_(True)
        s = scale.clone().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        rm, rv = stats[0].clone(), stats[1].clone()
        y = fn(xx, s, b, rm, rv, axis, 0.9, 1e-5)
        return (y.detach(), rm, rv,
                *torch.autograd.grad(y, [xx, s, b], g))

    before = dict(B.LAUNCHES)
    kern, plain = both(B.batch_norm_train), both(B.batch_norm_train_plain)
    torch.cuda.synchronize()
    if (B.LAUNCHES["batch_norm_forward"] - before["batch_norm_forward"],
            B.LAUNCHES["batch_norm_backward"]
            - before["batch_norm_backward"]) != (1, 1):
        raise AssertionError(f"B5 {shape}: launches {B.LAUNCHES}")
    errs = [float((a.float() - b.float()).norm() / b.float().norm())
            for a, b in zip(kern, plain)]
    for what, err, limit in zip(("y", "running mean", "running var", "dx",
                                 "d scale", "d bias"), errs, B5_LIMITS):
        if not err < limit:
            raise AssertionError(f"B5 {shape} {strides}: {what} relative "
                                 f"L2 {err:.3g} >= {limit}")
    if kern[0].stride() != x.stride():
        raise AssertionError(f"B5 {shape}: y strides {kern[0].stride()}")
    n = x.numel()
    geo = B.memory_geometry(shape, strides, axis)
    rm, rv = stats[0].clone(), stats[1].clone()
    _, saved = B.forward_kernel(x, scale, bias, rm, rv, axis, 0.9, 1e-5)
    fwd_ms = _device_ms(lambda: B.forward_kernel(x, scale, bias, rm, rv,
                                                 axis, 0.9, 1e-5))
    bwd_ms = _device_ms(lambda: B.backward_kernel(g, saved))
    xr = x.detach().requires_grad_(True)
    sr = scale.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)

    def step(fn):
        y = fn(xr, sr, br, rm, rv, axis, 0.9, 1e-5)
        return torch.autograd.grad(y, [xr, sr, br], g)

    def library(xx, s, b, rm, rv, axis, momentum, eps):
        # bf16 out; the cast lets it take the f32 dy
        return torch.batch_norm(xx, s, b, rm, rv, True, 1 - momentum, eps,
                                True).float()

    call_ms = _median_ms(lambda: step(B.batch_norm_train), 10)
    plain_ms = _median_ms(lambda: step(B.batch_norm_train_plain), 5)
    library_ms = (_median_ms(lambda: step(library), 5) if axis == 1
                  else None)
    bound_ms, bound_by = _bound_ms(14 * n, _OPS_BN * n, mem_rate)
    ms = fwd_ms + bwd_ms
    lib = (f", torch.batch_norm {library_ms:.4f} ms" if library_ms
           else "")
    print(f"phase B5 {list(shape)} [outer, C, inner] {list(geo)} x{count}: "
          f"rel L2 y {errs[0]:.2g} stats {max(errs[1:3]):.2g} dx "
          f"{errs[3]:.2g} d scale {errs[4]:.2g} d bias {errs[5]:.2g}; "
          f"device fwd {fwd_ms:.4f} + bwd {bwd_ms:.4f} = {ms:.4f} ms "
          f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.0%}); "
          f"eager fwd+bwd {call_ms:.4f} ms; plain {plain_ms:.4f} ms{lib}")
    return {"shape": list(shape), "strides": list(strides), "axis": axis,
            "geometry": list(geo), "count": count, "errs": errs,
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _b5_phase(mem_rate: float) -> dict:
    """Phase 22: kernel B5 at every BatchNorm layout of ResNet-50 (batch
    64), VGG-16 (batch 1,024) and lstman4 (batch 16) as the models hand
    them on, each checked and timed (``_b5_shape``); per model, the sums
    over its BatchNorms of a step (device time, bound, eager calls, plain
    version)."""
    import torch
    from gaussiank_sgd_torch.ops import batch_norm as B
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(22)
    B.reset_launches()
    out = {}
    checked = 0
    for dnn, dataset, batch, image in B5_MODELS:
        shapes = _b5_model_shapes(dnn, dataset, batch, image)
        checked += len(shapes)
        rows = [_b5_shape(key, count, mem_rate, gen)
                for key, count in shapes.items()]
        torch.cuda.empty_cache()
        step = {key: sum(r[key] * r["count"] for r in rows)
                for key in ("ms", "bound_ms", "call_ms", "plain_ms")}
        n_bn = sum(shapes.values())
        print(f"phase B5 {dnn} (batch {batch}, {n_bn} BatchNorms): device "
              f"{step['ms']:.3f} ms a step forward + backward (bound "
              f"{step['bound_ms']:.3f} ms, {step['bound_ms'] / step['ms']:.0%}"
              f"); eager {step['call_ms']:.3f} ms; plain version "
              f"{step['plain_ms']:.3f} ms")
        out[dnn] = {"batch_norms": n_bn, "step": step, "shapes": rows}
    # one launch of each direction a shape checked (held in _b5_shape);
    # the rest are the timing loops' warm-ups, captures and replays
    out["launches_checks"] = {name: checked for name in B.LAUNCHES}
    out["launches_timing"] = {name: n - checked
                              for name, n in B.LAUNCHES.items()}
    out["err"] = max(max(r["errs"]) for v in out.values()
                     if isinstance(v, dict) and "shapes" in v
                     for r in v["shapes"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def main(only: str = "") -> int:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.compressors import decompress, k_for
    from gaussiank_sgd_torch.models.vgg import VGG16
    from gaussiank_sgd_torch.ops import _build
    from gaussiank_sgd_torch.ops import fused_select as fs
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    mem_rate = _mem_rate(kind)
    print(f"phase card: {kind}, {torch.cuda.device_count()} device(s), "
          f"memory rate {mem_rate / 1e12:.2f} TB/s, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build, every source at once
    t0 = time.perf_counter()
    built = _build.load_all()
    wall = time.perf_counter() - t0
    for name, lib in built.items():
        regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
        print(f"phase build {name}: {os.path.relpath(lib.path, REPO)} (nvcc "
              f"{lib.seconds:.2f} s); {' | '.join(regs)}")
    print(f"phase build: {len(built)} sources in {wall:.2f} s")
    usage = _ptxas_usage(built["threshold_select"].log, "count_kernel")
    if usage is None:
        print("phase build count_kernel: no ptxas report (library reused)")
    else:
        regs, spills, used = usage
        print(f"phase build count_kernel (B4): {used}; {spills}")
        if regs > 64:
            raise AssertionError(f"count_kernel uses {regs} registers > 64")
    if only == "--zoo":
        zoo = _zoo_phase(mem_rate)
        print(json.dumps({"zoo": {key: v for key, v in zoo.items()
                                  if key != "profile"}}))
        return 0
    if only == "--runtime":
        print(json.dumps({"runtime": _runtime_phase()}))
        return 0
    if only == "--bench":
        print(json.dumps({"bench": _bench_phase(mem_rate)}))
        return 0
    if only == "--lm":
        out = {"lm": {key: v for key, v in _lm_phase(mem_rate).items()
                      if key != "profile"}, "ring": _ring_phase(),
               "sp": _sp_phase(), "spine": _spine_phase()}
        print(json.dumps(out, default=str))
        return 0
    if only == "--pod":
        print(json.dumps({"pod_and_health": _pod_and_health_phase()}))
        return 0
    if only == "--elastic":
        print(json.dumps({"policy_and_elastic": _policy_elastic_phase()},
                         default=str))
        return 0
    if only == "--headline":
        print(json.dumps({"headline": _headline_phase(kind)}))
        return 0
    if only == "--lint":
        print(json.dumps({"lint": _lint_phase()}, default=str))
        return 0
    if only == "--bn":
        print(json.dumps({"batch_norm": _b5_phase(mem_rate)}))
        return 0

    # 3. B1 at VGG-16's shape
    density = 0.001
    n = VGG16(device=torch.device("meta")).n_params
    k = k_for(n, density)
    nc = fs._chunk_geometry(n, density)[3]
    gen = torch.Generator(device=dev).manual_seed(0)
    b1, b1_err, res, g, warm = _b1_phase(n, density, gen, mem_rate)
    cold = torch.zeros(1, device=dev)

    # 4. B2 at [1, n] and [4, 65536]
    x = (res + g)[:, :n].contiguous()
    b2_err = 0.0
    for name, xx, t in (("[1, n] cold", x, cold), ("[1, n] warm", x, warm),
                        ("[4, 65536]", torch.randn(
                            4, 65536, device=dev, generator=gen),
                         torch.tensor([0.0, 1.0, 2.0, 3.0], device=dev))):
        out = fs.fused_select_candidates_chunked(xx, t, density)
        ref = fs.fused_select_plain(xx, t, density)
        torch.cuda.synchronize()
        b2_err = max(b2_err, _same(out, ref, f"B2 {name}"))
        print(f"phase B2 {name}: counts={out[2].tolist()} bit-identical "
              f"(vals, idx, counts)")
    b2 = _time_kernel(
        f"B2 [1, {n}]",
        lambda: fs.fused_select_candidates_chunked(x, warm, density),
        lambda: fs.fused_select_plain(x, warm, density),
        _bound_ms(n * 4 + nc * 8 + 8, _OPS_SELECT * n, mem_rate))
    del res, g

    # 5. B3 and B4 at [n], on the estimate's own candidates
    b3, b4, b3_err, b4_err = _b3_b4_phase(x[0], k, mem_rate)
    del x

    # 6a. the main path with gaussian_fused, then the registry's flat
    # compressor on the run's residual
    fused_argv = ["--compressor", "gaussian_fused", "--max-steps", "6",
                  "--compress-warmup-steps", "2"]
    trainer = _config(CONFIG2, fused_argv, "config2")
    n_total, k_total = trainer.plan.total_numel, trainer.plan.total_k
    if (n_total, k_total) != (n, k):
        raise AssertionError(f"plan ({n_total}, {k_total}) != ({n}, {k})")
    records, fused_launches, (r, _) = _drive(
        trainer, "main", lambda: trainer.comp.fn(
            trainer.state.ef_residual[:n_total].contiguous(), k_total,
            trainer.state.comp_state[0, 0]))
    kinds = [rec["kind"] for rec in records]
    if kinds != ["dense"] * 2 + ["sparse"] * 4:
        raise AssertionError(f"step kinds {kinds}")
    if fused_launches["fused_ef_select"] != 4:
        raise AssertionError(f"B1 launched {fused_launches['fused_ef_select']}"
                             f" times in 4 sparse steps")
    if fused_launches["fused_select"] < 1:
        raise AssertionError("B2 was not launched on the main path")
    bn_launches = {"main": _bn_launches(trainer, records, BNS["vgg16"],
                                         "main")}
    acc = trainer.state.ef_residual[:n_total]
    if not torch.equal(decompress(r.compressed, n_total) + r.residual, acc):
        raise AssertionError("flat compressor: decompress + residual != acc")
    dense_ms = [rec["step_ms"] for rec in records if rec["kind"] == "dense"]
    sparse_ms = [rec["step_ms"] for rec in records if rec["kind"] == "sparse"]
    print(f"phase main path: n={n_total} k={k_total} launches "
          f"{fused_launches}, B5 {bn_launches['main']} in 6 steps and the "
          f"MFU probe; dense step ms {[round(v, 2) for v in dense_ms]}"
          f", sparse step ms {[round(v, 2) for v in sparse_ms]} (first of "
          f"each includes warm-up); flat compressor num_selected "
          f"{int(r.num_selected)} of k={k_total}, EF invariant exact")
    del acc, r
    nsel = _ef_invariant(trainer, "fused sparse step")
    print(f"phase EF invariant: decompress(sent) + residual == acc bit for "
          f"bit on one sparse step (num_selected {nsel}, k {k_total})")

    # where a sparse step's time goes: 3 steps under torch.profiler
    main_profile = _profile(trainer, "profile")
    del trainer

    # 6b. gaussian_pallas: the unfused step with kernels B3 and B4
    trainer = _config(CONFIG2, ["--compressor", "gaussian_pallas", "--max-steps",
                        "6", "--compress-warmup-steps", "2"],
                       "config2_pallas")
    records_p, pallas_launches, _ = _drive(trainer, "pallas")
    if trainer.ts.fused_ef is not None:
        raise AssertionError("gaussian_pallas took the fused EF path")
    want = {"fused_stats": 4, "multi_threshold_counts": 8,
            "fused_ef_select": 0, "fused_select": 0}
    if pallas_launches != want:
        raise AssertionError(f"gaussian_pallas launches {pallas_launches}, "
                             f"want {want} in 4 sparse steps")
    bn_launches["pallas"] = _bn_launches(trainer, records_p, BNS["vgg16"],
                                           "pallas")
    ratios = _within_5pct_of_k(records_p, "gaussian_pallas")
    nsel = _ef_invariant(trainer, "unfused sparse step")
    print(f"phase pallas path: launches {pallas_launches} in 4 sparse "
          f"steps, B5 {bn_launches['pallas']} in 6 and the MFU probe; "
          f"num_selected / k {[round(v, 4) for v in ratios]}; EF "
          f"invariant exact on one more unfused step (num_selected {nsel})")
    _profile(trainer, "pallas profile")
    del trainer

    # 6c. config 2 as the repo ships it (compressor 'gaussian')
    trainer = _config(CONFIG2, ["--max-steps", "4", "--compress-warmup-steps", "2"],
                       "config2_shipped")
    if trainer.comp.name != "gaussian":
        raise AssertionError(f"config 2 runs {trainer.comp.name!r}")
    with _recorded_calls(trainer) as calls:
        records_s, _, _ = _drive(trainer, "shipped")
        bn_launches["shipped"] = _bn_launches(trainer, records_s,
                                              BNS["vgg16"], "shipped")
        nsel = _ef_invariant(trainer, "config 2 gaussian")
    replay = _replay_on_cpu(calls, trainer.cfg.density, "config 2 gaussian")
    print(f"phase shipped config 2: compressor gaussian, B5 "
          f"{bn_launches['shipped']} in 4 steps and the MFU probe, EF "
          f"invariant exact on one more step (num_selected {nsel}); "
          f"num_selected / k of "
          f"each call (2 sparse steps and that one), each equal to the CPU's "
          f"from the card's t0: " + "; ".join(replay))
    del calls
    _profile(trainer, "shipped profile")
    del trainer

    # 6d. gaussian_warm: one host sync per sparse step (its branch)
    trainer = _config(CONFIG2, ["--compressor", "gaussian_warm", "--max-steps", "6",
                        "--compress-warmup-steps", "2"], "config2_warm")
    with _recorded_calls(trainer) as calls:
        _drive(trainer, "warm")
        nsel = _ef_invariant(trainer, "config 2 gaussian_warm")
    replay = _replay_on_cpu(calls, trainer.cfg.density, "gaussian_warm")
    if " cold" not in replay[0]:
        raise AssertionError(f"gaussian_warm: first call {replay[0]}")
    print(f"phase warm path: EF invariant exact on one more step "
          f"(num_selected {nsel}); num_selected / k of each call (4 sparse "
          f"steps and that one; the first is cold: estimate and bisection), "
          f"each equal to the CPU's from the card's t0: " + "; ".join(replay))
    del calls
    _profile(trainer, "warm profile")
    del trainer

    # the seed fixes the run: config 2 again from the same seed (weights,
    # batches and dropout masks); the first loss is a forward only and must
    # repeat bit for bit, later ones carry cuDNN's backward summation order
    again = [rec["loss"] for rec in _steps(_config(CONFIG2, fused_argv,
                                                   "config2_repeat"))]
    first = [rec["loss"] for rec in records]
    if again[0] != first[0]:
        raise AssertionError(f"seeded runs differ at step 1: {first} vs "
                             f"{again}")
    print(f"phase repeat: config 2 from the same seed, losses {again} vs "
          f"{first} (step 1 bit for bit; max rel gap "
          f"{max(abs(a - b) / abs(b) for a, b in zip(again, first)):.2e})")

    # small input: the same narrow runs on the card and on the CPU
    for compressor, kw in (("gaussian_fused", {}),
                           ("gaussian_pallas", dict(bucket_policy="uniform",
                                                    bucket_size=4096))):
        losses = {device: _small_run(device, compressor, **kw)
                  for device in ("cuda", "cpu")}
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                     losses["cpu"])]
        if max(gaps) > 1e-3:
            raise AssertionError(f"{compressor}: card and CPU disagree: "
                                 f"{losses}")
        print(f"phase small input {compressor} {kw}: narrow VGG f32 losses "
              f"on the card {losses['cuda']} vs CPU {losses['cpu']} (max "
              f"rel gap {max(gaps):.2e} <= 1e-3)")

    # 7. the exchange: B1 at the uniform plan's shape, then config 2 with
    # and without an NCCL group of one, the ordered scatter, two workers
    res = torch.zeros(229, 65_536, device=dev)
    g = torch.zeros(229, 65_536, device=dev)
    res[:, :] = torch.randn(229, 65_536, device=dev, generator=gen) * 0.01
    g[:, :] = torch.randn(229, 65_536, device=dev, generator=gen) * 0.01
    k_u = k_for(65_536, density)
    _, warm_u = fs.gaussian_fused_ef_compress_batched(
        res, g, 1.0, k_u, torch.zeros(229, device=dev), density=density)
    nc_u = fs._chunk_geometry(65_536, density)[3]
    out = fs.fused_ef_select_candidates_chunked(res, g, 1.0, warm_u, density)
    b1_err = max(b1_err, _same(out, fs.fused_ef_select_plain(
        res, g, 1.0, warm_u, density), "B1 [229, 65536]"))
    print(f"phase B1 [229, 65536] warm: {nc_u} candidates a chunk, counts "
          f"{int(out[3].min())}..{int(out[3].max())}, bit-identical")
    # one chunk's call, as the pipelined schedule makes it on this plan
    b1_err = max(b1_err, _same(
        fs.fused_ef_select_candidates_chunked(res[:1], g[:1], 1.0,
                                              warm_u[:1], density),
        fs.fused_ef_select_plain(res[:1], g[:1], 1.0, warm_u[:1], density),
        "B1 [1, 65536]"))
    print("phase B1 [1, 65536] warm (row 0): bit-identical")
    b1_u = _time_kernel(
        "B1 [229, 65536]",
        lambda: fs.fused_ef_select_candidates_chunked(res, g, 1.0, warm_u,
                                                      density),
        lambda: fs.fused_ef_select_plain(res, g, 1.0, warm_u, density),
        _bound_ms(3 * 229 * 65_536 * 4 + 229 * nc_u * 8 + 229 * 8,
                  _OPS_SELECT * 229 * 65_536, mem_rate))
    del res, g, out

    b1_exchange = _exchange_runs(dev)
    _scatter_phase(n, dev)
    torch.cuda.empty_cache()
    _two_workers_phase()

    # 8. the ResNet family: config 1, B1 at ResNet-50's padded EF row,
    # config 3 on three paths
    _config1_phase()
    b1_r50, b1_r50_err, res, g, _ = _b1_phase(RESNET50[0], density, gen,
                                              mem_rate)
    b1_err = max(b1_err, b1_r50_err)
    del res, g
    torch.cuda.empty_cache()
    c3 = _config3_phases(mem_rate)
    b2_err = max(b2_err, c3["b2_err"])
    b3_err, b4_err = max(b3_err, c3["b3_err"]), max(b4_err, c3["b4_err"])

    # 9. the training loop as users run it: config 3 through fit() with
    # eval passes and checkpoints (written outside the repository: ~300 MB
    # each), the resume, microbatching and clipping, eval card vs CPU
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        loop = _fit_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loop["microbatch"] = _microbatch_phase(c3["peak"])
    _eval_card_vs_cpu_phase()

    # 10-11. the language workloads: config 4 (LSTM, carried hidden state)
    # and config 5 (Transformer-base, randomkec; gaussian_fused arm)
    c4 = _config4_phases(mem_rate)
    c5 = _config5_phases(mem_rate)
    b1_err = max(b1_err, c4["b1_err"], c5["b1_err"])
    b2_err = max(b2_err, c4["b2_err"], c5["b2_err"])
    b3_err, b4_err = max(b3_err, c4["b3_err"]), max(b4_err, c4["b4_err"])

    # 12. the comparison arms: config 3's TopK arm, config 2's other arms,
    # the gTop-k exchange (B2 on its unfused step), and their timings
    c12 = _topk_arm_phase({"profile": c3["profile"], "peak": c3["peak"],
                           "b1_ms": b1_r50["ms"]})
    runs = {"config3 topk": c12["launches"],
            **{f"config2 {name}": v for name, v in _arms_phase().items()},
            "config2 gtopk": _gtopk_phase(dev)["gtopk"]}
    _comparison_timings(c12.pop("acc"), mem_rate)

    def comparison(key: str) -> dict:
        return {"launches": sum(v[key] for v in runs.values()),
                "runs": {name: v[key] for name, v in runs.items()}}

    # 13. the reference's options: config 2 on the optax path with
    # nesterov, fold_lr (B1 at scale = lr(step)) and sigma_scale, its
    # resume, and the two-level exchange of four ranks on this card
    torch.cuda.empty_cache()
    options = _options_phase(mem_rate, main_profile)
    b1_err = max(b1_err, options.pop("max_abs_err"))
    two_level = _two_level_phase()
    options["launches_two_level"] = two_level["launches"]

    # 14. the model zoo: lstman4 (CTC), alexnet and mnistnet
    torch.cuda.empty_cache()
    zoo = _zoo_phase(mem_rate)
    b1_err, b2_err = max(b1_err, zoo["err"]), max(b2_err, zoo["b2_err"])
    zoo_times = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")

    # 15. the default-on runtime: rollback, preemption, the prefetching
    # loader, the native CIFAR pipeline
    torch.cuda.empty_cache()
    runtime = _runtime_phase()
    b1_err = max([b1_err] + [v["err"] for v in runtime.values()])

    # 16. the bench harness, the pipelined schedule, the instruments
    torch.cuda.empty_cache()
    bench = _bench_phase(mem_rate)
    b1_err, b2_err = (max(b1_err, bench["b1_err"]),
                      max(b2_err, bench["b2_err"]))

    def bench_runs(key: str) -> dict:
        runs = {name: v[key] for name, v in bench["launches"].items()}
        return {"launches": sum(runs.values()), "runs": runs}

    # 17. transformer_lm at full width, the ring on the card, the trainer
    # at (dp 1, sp 2), config 2 traced through the telemetry spine
    torch.cuda.empty_cache()
    lm = _lm_phase(mem_rate)
    ring = _ring_phase()
    sp = _sp_phase()
    spine = _spine_phase()
    b1_err = max(b1_err, lm["err"], sp["err"], spine["err"])
    b2_err = max(b2_err, lm["err"], spine["err"])
    lm_times = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")

    def lm_runs(key: str) -> dict:
        return {"launches": lm["launches"][key],
                "spine": spine["launches"][key]}

    # 18. the pod rig (two gloo ranks on this card, a SIGKILL, a relaunch)
    # and run health (clean, NaN chaos, its cost)
    torch.cuda.empty_cache()
    pod = _pod_and_health_phase()
    b1_err = max(b1_err, pod["pod"]["err"], pod["health"]["err"])

    # 19. the adaptive policy engine (a scripted lifecycle across B1 -> B3
    # and B4, the shipped rules) and the elastic service (2 -> 3 -> 2)
    torch.cuda.empty_cache()
    pe = _policy_elastic_phase()
    b1_err = max(b1_err, pe["script"]["err"], pe["rules"]["err"],
                 pe["elastic"]["err"])
    b3_err = max(b3_err, pe["script"]["b3_err"])
    b4_err = max(b4_err, pe["script"]["b4_err"])
    policy_elastic = {
        "fused_ef_select": {
            "launches": pe["script"]["launches"]["fused_ef_select"]
            + pe["rules"]["launches"] + pe["elastic"]["launches"],
            "runs": {"script": pe["script"]["launches"]["fused_ef_select"],
                     "rules": pe["rules"]["launches"],
                     **{f"elastic {k}": v
                        for k, v in pe["elastic"]["runs"].items()}}},
        **{name: {"launches": pe["script"]["launches"][name],
                  "runs": {"script": pe["script"]["launches"][name]}}
           for name in ("fused_stats", "multi_threshold_counts")}}
    # 20. the headline bench driver (all five configs in a fresh process,
    # vgg16 alone with the overlap arm), the card-priced floor and the
    # regression sentinel
    torch.cuda.empty_cache()
    headline = _headline_phase(kind)
    b1_err = max(b1_err, headline["err"])

    def headline_runs(key: str) -> dict:
        runs = {name: v.get(key, 0) for name, v in headline["runs"].items()}
        return {"launches": sum(runs.values()), "runs": runs}

    # 21. the lint tiers' step audit, the policy A/B harness on the card's
    # matrix and convergence parity on two gloo ranks
    torch.cuda.empty_cache()
    lint = _lint_phase()
    b1_err = max(b1_err, lint["err"])
    b2_err = max(b2_err, lint["err"])

    def lint_runs(key: str) -> dict:
        runs = {name: v.get(key, 0) for name, v in lint["runs"].items()}
        return {"launches": sum(runs.values()), "runs": runs}

    # 22. kernel B5 at every BatchNorm of ResNet-50, VGG-16 and lstman4
    torch.cuda.empty_cache()
    bn = _b5_phase(mem_rate)

    print(f"phase total: {time.perf_counter() - t_start:.1f} s, the build "
          f"included")

    # 23. the kernels line
    select_src = "gaussiank_sgd_torch/csrc/fused_select.cu"
    thresh_src = "gaussiank_sgd_torch/csrc/threshold_select.cu"
    kernels = [
        {"name": "fused_ef_select (B1)", "route": "cuda", "source": select_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_pack.py:179",
         "launches": fused_launches["fused_ef_select"], "max_abs_err": b1_err,
         **b1, "launches_exchange": b1_exchange,
         **{f"{key}_229x65536": b1_u[key]
            for key in ("ms", "call_ms", "plain_ms", "bound_ms")},
         "resnet50": {"launches": c3["fused"]["fused_ef_select"],
                      "shape": [1, RESNET50[2]], **b1_r50},
         "training_loop": {f"launches_{key}": v for key, v in loop.items()},
         "lstm": {"launches": c4["fused"]["fused_ef_select"],
                  "shape": [1, LSTM[2]], **c4["b1"]},
         "transformer": {"launches": c5["fused"]["fused_ef_select"],
                         "shape": [1, TRANSFORMER[2]], **c5["b1"]},
         "comparison": comparison("fused_ef_select"),
         "options": options,
         "zoo": {"launches": zoo["launches"],
                 **{name: {"shape": [1, ZOO[name][2]],
                           **{key: zoo[f"b1_{name}"][key]
                              for key in zoo_times}}
                    for name in ("lstman4", "alexnet")}},
         "runtime": {"launches": sum(v["launches"]
                                     for v in runtime.values()),
                     "runs": {name: v["launches"]
                              for name, v in runtime.items()}},
         "bench": {**bench_runs("fused_ef_select"),
                   **{f"{key}_{shape}": v[key]
                      for shape, v in bench["b1_times"].items()
                      for key in ("ms", "call_ms", "plain_ms", "bound_ms",
                                  "bound_by")}},
         "transformer_lm": {**lm_runs("fused_ef_select"),
                            "sp2": sp["launches"], "shape": lm["shape"],
                            **{key: lm["b1"][key] for key in lm_times}},
         "pod": {"launches": pod["pod"]["launches"]
                 + pod["health"]["launches"],
                 "runs": {**pod["pod"]["runs"],
                          "health": pod["health"]["launches"]}},
         "policy_elastic": policy_elastic["fused_ef_select"],
         "headline": headline_runs("fused_ef_select"),
         "lint": lint_runs("fused_ef_select")},
        {"name": "fused_select (B2)", "route": "cuda", "source": select_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_pack.py:152",
         "launches": fused_launches["fused_select"], "max_abs_err": b2_err,
         **b2, "resnet50": {"launches": c3["fused"]["fused_select"],
                            "shape": [1, RESNET50[0]], **c3["b2"]},
         "lstm": {"launches": c4["fused"]["fused_select"],
                  "shape": [1, LSTM[0]], **c4["b2"]},
         "transformer": {"launches": c5["fused"]["fused_select"],
                         "shape": [1, TRANSFORMER[0]], **c5["b2"]},
         "comparison": comparison("fused_select"),
         "zoo": {"launches": zoo["launches_b2"],
                 "shape": [1, ZOO["lstman4"][0]],
                 **{key: zoo["b2_lstman4"][key] for key in zoo_times}},
         "bench": bench_runs("fused_select"),
         "transformer_lm": {**lm_runs("fused_select"),
                            "shape": [1, lm["n"]],
                            **{key: lm["b2"][key] for key in lm_times}},
         "headline": headline_runs("fused_select"),
         "lint": lint_runs("fused_select")},
        {"name": "fused_stats (B3)", "route": "cuda", "source": thresh_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_select.py:76",
         "launches": pallas_launches["fused_stats"], "max_abs_err": b3_err,
         **b3, "resnet50": {"launches": c3["pallas"]["fused_stats"],
                            "shape": [RESNET50[0]], **c3["b3"]},
         "lstm": {"launches": c4["pallas"]["fused_stats"],
                  "shape": [LSTM[0]], **c4["b3"]},
         "transformer": {"launches": c5["fused"]["fused_stats"]},
         "comparison": comparison("fused_stats"),
         "bench": bench_runs("fused_stats"),
         "transformer_lm": lm_runs("fused_stats"),
         "policy_elastic": policy_elastic["fused_stats"],
         "headline": headline_runs("fused_stats"),
         "lint": lint_runs("fused_stats")},
        {"name": "multi_threshold_counts (B4)", "route": "cuda",
         "source": thresh_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_select.py:112",
         "launches": pallas_launches["multi_threshold_counts"],
         "max_abs_err": b4_err, **b4,
         "resnet50": {"launches": c3["pallas"]["multi_threshold_counts"],
                      "shape": [RESNET50[0]], **c3["b4"]},
         "lstm": {"launches": c4["pallas"]["multi_threshold_counts"],
                  "shape": [LSTM[0]], **c4["b4"]},
         "transformer": {"launches": c5["fused"]["multi_threshold_counts"]},
         "comparison": comparison("multi_threshold_counts"),
         "bench": bench_runs("multi_threshold_counts"),
         "transformer_lm": lm_runs("multi_threshold_counts"),
         "policy_elastic": policy_elastic["multi_threshold_counts"],
         "headline": headline_runs("multi_threshold_counts"),
         "lint": lint_runs("multi_threshold_counts")},
        {"name": "batch_norm (B5)", "route": "cuda",
         "source": "gaussiank_sgd_torch/csrc/batch_norm.cu",
         "replaces": None, "launches": bn_launches["main"],
         "launches_config2": bn_launches,
         "launches_config3": c3["bn"],
         "launches_checks": bn["launches_checks"],
         "launches_timing": bn["launches_timing"],
         "max_rel_l2_err": bn["err"],
         **{dnn: bn[dnn] for dnn, _, _, _ in B5_MODELS}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--two-level-worker"]:
        sys.exit(_two_level_worker(int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4]))
    if sys.argv[1:2] == ["--bench-worker"]:
        sys.exit(_bench_worker(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4]))
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(_sp_worker(int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4]))
    if sys.argv[1:2] == ["--pod-worker"]:
        sys.exit(_pod_worker(int(sys.argv[2])))
    if sys.argv[1:2] == ["--headline-worker"]:
        sys.exit(_headline_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main(only=sys.argv[1] if sys.argv[1:2] in (
        ["--zoo"], ["--runtime"], ["--bench"], ["--lm"], ["--pod"],
        ["--elastic"], ["--headline"], ["--lint"], ["--bn"]) else ""))
