#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device: print the ``nvidia-smi`` name and power limit; require CUDA.
2. Build: compile the kernels (csrc/bp_layered.cu as its cyclic and its
   xor group, csrc/bp_long.cu and csrc/bp_stream.cu each as their four
   f32/bf16 min-sum and sum-product parts, csrc/op_rate.cu), one nvcc per
   object started together, and print each build time and what ptxas
   reports of the decode kernels (bp_layered.cu, bp_long.cu, bp_stream.cu:
   registers, shared memory, spills); hold bp_long.cu's scratch layout, as
   the library sizes it, against the record codec
   (:func:`check_long_scratch_layout`); then build the native host library
   (``myldpccppapi_torch/native``) with g++ and print its seconds.
3. Short-code kernel vs plain: the kernel on CUDA against its plain
   version (``decode_qc_cuda_plain``) on CUDA at batch 1000 and on the CPU
   on the batch's first 64 frames, for all six 802.16e rates at n=576
   plus n=2304 rate 1/2 at 5 dB and for r1/2, r3/4B and n=2304 at 2 dB, a
   per-layer alpha tuple, early exit on, and off at 5 dB (:func:`exits`;
   alpha 0.75 is phase 3d's "soft layered" case); then bench.py's single
   pass at the launch shapes the main path meets: batch 1 (one block),
   batch 70 (fewer codewords than SMs) and the triage's straggler pass
   (1024 frames of a batch of 8192 at 5 dB, those that failed the
   5-iteration fast pass first): 20 cases.  Bits, converged, iterations
   and total_iters must be equal.  Every kernel-A log line names the tile
   (codewords per block, which the wrapper picks from the batch) and L
   (lanes per check row).
3b. Long-code kernel vs plain: the kernel against ``decode_qc_long_plain``
   on CUDA (batch 101) and on the CPU (batch 16), for nr_code(384, 1),
   nr_code(384, 2) and nr_code(208, 1), rate-matched rv0 LLRs at an SNR
   where nearly every frame converges and one where most run 30
   iterations, alpha 0.8 and a per-layer alpha tuple, early exit on, and
   off at the easy SNR; and at the main path's batch of 512 on
   nr_code(384, 1), past one wave of resident blocks, the hard SNR with
   early exit off; then at batch 1 (early exit on and off) and at more than
   two waves (early exit off: min-sum f32 and bf16, sum-product),
   posteriors compared: 24 cases.  The same four fields must be equal.
3c. The same kernel on DVB-S2 (multi-edge cells, the masked wrap row) and
   the global placement (csrc/bp_stream.cu, kernel D's port: layers
   staged in shared memory by bulk copies, compressed min-sum messages),
   against their plain version (the lazy-aware one in lazy mode) on CUDA
   and, for 16200, on the CPU at batch 16: dvbs2(16200, "1/2") and
   dvbs2(16200, "8/9") (rows of 35 circulants) in shared memory,
   dvbs2(64800, "1/2") and dvbs2(64800, "3/4") in global memory, at an SNR
   where nearly every frame converges and one where most run 30
   iterations, exact and lazy, alpha 0.85 at the easy SNR and per layer
   at the hard one, early exit on, and off at the easy SNR; dvbs2(64800, "9/10") (rows of 40) once; a
   plain staircase QC code whose posterior passes shared memory (kernel
   D's own domain), on all-zero-codeword LLRs from hopeless to easy; the
   global placement forced on nr_code(384, 1) and dvbs2(16200, "1/2"),
   equal to the shared one; the main path's batch of 1024, lazy, early
   exit off (latched frames keep sweeping); then the stage plan's
   corners, forced global: a code whose consecutive layers share five of
   their six columns (nearly every cell forwarded), a z of 101 (z x 4 and
   z x 2 bytes not multiples of 16: the padded layout) in f32 and bf16;
   and dvbs2(16200, "3/4") (rows of 22 circulants, shared) at batch 1 and
   past two waves as in 3b: 40 cases (the 64800 codes run exact and lazy
   at the easy SNR with early exit on, and lazy at the hard one: early
   exit off runs in the main path's batch case).  Then the persistent
   grid's turns (:func:`stream_turn_cases`): dvbs2(64800, "1/2") at 1.4 dB
   at batch 1024, past the card's resident blocks (turns of a few
   sweeps), and at batch 64 (one turn a codeword), min-sum in f32 and
   bf16 (exact and lazy, early exit on and off, soft output) and
   sum-product in f32 and bf16, each against the plain version on CUDA,
   and the clocked instantiation against the unclocked one, its sweeps
   equal to the frames' iterations and its turns as the rule says: 18
   cases.
3d. Kernel A's new modes vs plain: flooding min-sum (alpha 1.0, alpha 0.75,
   per-layer alpha, beta 0.25), SCMS, sum-product (flooding and layered)
   and soft output (min-sum layered and flooding, sum-product layered and
   flooding), at 5 dB on all six 802.16e rates at n=576 plus n=2304 rate
   1/2, early exit on, and off on r1/2, r3/4B and n=2304, and at 2 dB on
   r1/2 and n=2304 (120 cases): the kernel at
   batch 1000 (a ragged tail) against its plain version on CUDA, and at 5
   dB at batch 16 against it on the CPU on r1/2, r3/4B and n=2304.  Bits, converged, iterations,
   total_iters and the posteriors of every frame must be equal, with one
   tolerance: torch's CPU exp/log1p are not its CUDA ones (the phase
   counts the phi inputs where they differ), so sum-product is held
   against the CPU to equal bits and converged flags and iterations
   within 1 (its CPU posteriors' largest difference is logged).  Against
   the plain version on CUDA, sum-product is held bit-exact like every
   other mode.
3e. Kernel B's route (the same kernel, table-driven, on 5G NR codes of more
   than 120 circulants with z < 64): nr_code(z, 1) for z in 16, 32, 56 and
   nr_code(z, 2) for z in 8, 40, rate-matched rv0 LLRs with LLR-0
   punctured columns, at an SNR where nearly every frame converges and one
   where most run 30 iterations, early exit on, and off at the easy SNR
   (15 cases), against the plain version on CUDA (batch 101) and the CPU
   (batch 16); ``Decoder(...,
   device="cuda")`` must resolve to ``"cuda"`` there.  Then the route's main
   path: nr_code(32, 1) encoded on the card at batch 4096, 3 dB, through
   ``Decoder``, with bench.py's gates.
3f. Kernel C's sum-product and soft-output modes vs plain: sum-product,
   soft output (alpha 0.8) and both, on nr_code(384, 1) and nr_code(64, 2)
   (rate-matched rv0 LLRs, LLR-0 punctured columns) at batch 64,
   dvbs2(16200, "1/2") (multi-edge, masked rows; shared) at batch 64 and
   dvbs2(64800, "1/2") (global, csrc/bp_stream.cu, its messages staged
   under sum-product) at batch 16 (soft output also with early exit off)
   and dvbs2(64800, "9/10") under sum-product (rows of 40: messages read
   from device memory), at an SNR where nearly every
   frame converges and one where many run 30 iterations, exact and lazy
   syndrome, early exit on and off; one case forced into the global
   placement on NR (equal to the shared one too) and one at
   ``max_iters=0`` (the posterior is the channel LLR): 19 cases.  Bits,
   converged, iterations, total_iters and the posteriors of every frame
   must equal the plain version's on CUDA, and the launch counters must
   show the placement and mode; sum-product is held against the CPU at a
   converging point to equal bits and converged flags, iterations within
   1 (torch's CPU exp/log1p are not its CUDA ones), min-sum soft output
   bit-exact.
3k. The edge-list path (ops/bp_edgelist.py: torch ops, no kernel of its
   own, the reference's XLA gathers and scatters) on CUDA against the same
   function on the CPU, batch 16: dvbs2_oracle(16200, "1/2") (``Decoder``
   auto, which must resolve to ``"edgelist"``) and wimax(576, "3/4B")
   (explicit ``"edgelist"``), layered and flooding NMS alpha 0.75, 20
   iterations, soft output, at an SNR where nearly every frame converges
   and one where most run all 20 sweeps, early exit on, and off at the
   easy SNR (12 cases): bits, converged, iterations, total_iters and
   posteriors equal; a bf16 case on the oracle held the same way; a
   sum-product case held as phase 3d holds sum-product against the CPU.
4. Short-code main path: ``Decoder(wimax(576, "3/4B"), bench config,
   device="cuda")`` at batch 8192, 5 dB, noise from a torch.Generator on
   the card; then the ``Coder`` TDMPCL byte-stream round trip of the CLI
   ``test`` flow, held against the CPU TDMP decode of the same soft stream.
4b. NR main path (BASELINE config 4): nr_code(384, 1) encoded on the card,
   rate-matched rv0 over the full buffer, BPSK/AWGN at 3, 4, 5 and 6 dB,
   de-rate-matched and decoded by ``Decoder(..., device="cuda")`` (layered
   NMS alpha 0.8, 30 iterations, batch 512), which must resolve to
   ``cuda_long``; bench.py's gates at each point, and the torch path on
   the same LLRs at 5 dB.  ``Decoder(..., soft_output=True)`` on the same
   code resolves to ``cuda_long`` (kernel C's soft mode) and equals the
   torch path, posteriors included; soft output on nr_code(48, 1), which
   neither kernel serves (z < 64), resolves to the torch path on the card
   (phase 4u decodes such a case) and an explicit kernel there raises; the
   sum-product ``Decoder`` runs kernel C's sum-product mode at 3-6 dB
   with the same gates and equals the torch path at 5 dB.  Then the CLI
   ``waterfall --family nr --z 384 --bg 1`` for two SNR points, and again
   from its checkpoint, which must run no new step.
4c. DVB-S2 main path (BASELINE config 3): dvbs2(64800, "1/2") encoded on
   the card (``ira_encode_fn``), BPSK/AWGN at 1.0 and 1.4 dB, decoded by
   ``Decoder(..., device="cuda")`` (layered NMS alpha 0.85, 30 iterations,
   lazy syndrome, batch 1024), which must resolve to ``cuda_long`` with the
   posterior in global memory; bench.py's gates at 1.4 dB; equal to the
   lazy plain version, and within the lazy contract of the exact torch
   path; the same ``Decoder`` with soft output (kernel C's soft mode in the
   global placement) passes the gates at 1.4 dB and equals the lazy plain
   version, posteriors included.  Then the CLI ``waterfall --family dvbs2
   --n 16200 --rate 1/2`` for two SNR points, and again from its
   checkpoint.
4d. Flooding main path: ``Decoder(wimax(576, "3/4B"), ..., device="cuda")``
   on phase 4's LLRs (batch 8192, 5 dB) with flooding NMS alpha 0.75, SCMS,
   flooding sum-product (on the 2y/sigma^2 LLRs) and layered soft output,
   40 iterations: each must resolve to ``"cuda"``, pass bench.py's gates and
   equal ``Decoder(..., implementation="torch")``.  Then the ``Coder`` MSCL
   and SCMS round trips of phase 4's byte stream, the first 2048 codewords
   of each equal to the CPU decode of the same soft stream; and the CLI
   ``waterfall --family wimax --schedule flooding --self-correction`` for
   two SNR points, and again from its checkpoint.
4e. BASELINE 3m: dvbs2(64800, "3/4") encoded on the card, as 16APSK
   (gamma 2.85) through complex AWGN at 14.8 dB, max-log demapped on the
   card (the first frames equal to the CPU demap within 1e-5), decoded by
   phase 4c's ``Decoder`` config (global placement, lazy) at batch 1024
   with bench.py's gates; then the CLI ``waterfall --family dvbs2 --n
   64800 --rate 3/4 --mod 16apsk`` at 14.8 dB and its resume.
4f. BASELINE 4m: nr_code(384, 1) encoded on the card, rate-matched rv0
   over the full buffer, as 64QAM at 13.5 dB, demapped (separable max-log),
   de-rate-matched and decoded by ``Decoder`` (NR_CFG, shared placement)
   at batch 512 with the same gates.
4g. BICM-ID: dvbs2(16200, "3/4") as 16APSK at 13.9 dB, batch 1024, alpha
   0.85, 30 iterations: one-shot and two exchanges on the same symbols;
   the two soft passes must launch kernel C's soft mode (its counter), the
   FER with the exchanges must be below the one-shot FER, and the loop
   must equal the same loop whose decodes take the plain version on CUDA.
   Then wimax(576, "1/2") as natural-label 8PSK at 10 dB, batch 2048,
   alpha 0.75 on kernel A's soft mode (FER not above one-shot, equal to the
   plain loop), and the CLI ``waterfall --mod 16apsk --id-outer 2`` on the
   same DVB-S2 code and its resume.
3g. (runs after 4g, like 3h-4j) bf16 messages, kernel A's other modes and
   kernel B's route against their plain versions on CUDA, bit-exact,
   bf16 posteriors included: flooding NMS alpha 0.75, SCMS, layered
   sum-product, layered and flooding soft output on wimax(576, "3/4B") at
   batch 1000, 5 and 2 dB, and nr_code(32, 1) at batch 101, 3 and -1.25
   dB (12 cases); the tiles f32/bf16.
3h. bf16 against the true codeword at the reference's own points
   (tests/test_zlane.py, tests/test_bf16.py): dvbs2_ira_qc(16200, "8/9")
   at 6.5 dB on kernel C, wimax(576, "3/4B") at 5.5 dB on kernel A (NMS
   alpha 0.75 and sum-product), 16 frames each through ``Decoder``: every
   frame converges to the true info bits.
4h. bf16 main paths through ``Decoder``, each equal to its plain version
   (the one with the kernel's rounding points) on CUDA: phase 4's wimax
   LLRs (layered NMS alpha 0.75 and flooding sum-product), NR BG1 Z=384 at
   3-6 dB (min-sum alpha 0.8; sum-product and soft output at 5 dB),
   DVB-S2 64800 r1/2 at 1.4 dB, lazy, in the placement its bf16 fit
   picks (global) and forced into the other one (shared); then the CLI
   ``waterfall --msg-dtype bfloat16`` on wimax 576 r1/2 layered min-sum
   beside the f32 run of the same frames, their FERs printed.
4i. BASELINE configs 1 and 1c: regular(648), flooding sum-product, 16 sim
   steps of batch 64 at 2 dB through ``sim_step`` on kernel A (1c with
   CRC-16, so ``Decoder`` wraps the kernel in the acceptance retry):
   config 1 must show undetected errors, 1c none and some CRC rejections;
   on 16 batches the kernel + wrap equals ``Decoder(implementation=
   "torch")``'s in-loop latch (bits, converged, iterations, accepted);
   the retry's share of a batch's decode time.
4j. The three legs of ``__graft_entry__.dryrun_multichip`` on one card
   through ``sim_step`` with the reference's configs and SNR points: wimax
   576 r1/2 CRC-16 (kernel A), DVB-S2 16200 r1/2 with post-decode outer
   BCH (kernel C), NR BG1 z=32 rate-matched rv0 CRC-16 (kernel B's route);
   and leg 2's code with the BCH in the decoder: kernel C + wrap equals
   the latch on true and forged frames, fewer and more than the cap.
4n. (runs after 4j) BASELINE config 3's point on the DVB-S2 standard-domain
   oracle: dvbs2_oracle(64800, "1/2") encoded on the card (its
   ``encode_fn``), BPSK/AWGN at 1.4 dB, batch 1024, through ``Decoder``
   (auto: ``"edgelist"``), layered NMS alpha 0.85, 30 iterations, with
   bench.py's gates (the syndrome through the QC form); the same noisy
   frames, permuted into the QC order by ``std_interleave``, through
   dvbs2(64800, "1/2") on the global placement (csrc/bp_stream.cu, phase
   4c's config): equal bits on every frame that both converge, both
   convergence counts logged.
4o. BASELINE config 4t (benchmarks/run_baseline.py:883-929): ``plan_tb(20000,
   40000, qm=2)`` (C = 3, K' = 6699, Z = 320), 128 transport blocks encoded
   on the card (``NRTransport.encode``), BPSK/AWGN at 3 dB, received
   through the transport's default decoder (kernel C inside the acceptance
   wrapper, CRC24B at span K'; its launches counted) and through the same
   receive with ``implementation="torch"`` on CUDA: payload, tb_ok,
   tb_crc_ok, cb_ok, converged and iterations equal, and no TB with
   tb_ok carries a wrong payload.  Then a small-Z block, ``plan_tb(1000,
   3000, bg=1, qm=2)`` (Z = 48, kernel B's route), the same way.
4p. (runs after 4o) Multi-process campaigns (myldpccppapi_torch/parallel/):
   (a) ``make_sharded_campaign_step`` on a world-size-1 NCCL group on
   cuda:0, BASELINE config 5's 8 points (0.5-4.0 dB, layered NMS alpha
   0.8, 25 iterations) at the whole batch of 1024 on NR BG1 z=64
   (triangular encode) and DVB-S2 16200 r1/2 (IRA encode), equal in every
   field to ``sim_step`` on position 0's generators, kernel C launched;
   then each family's campaign at world 1 as the CLI runs it, and the
   step's collective timed alone; (b) ``dryrun_multichip(4)`` on
   ``spawn``'s 4 ranks of the one card (snr 2 x data 2, gloo, tensors on
   cuda:0): each rank's ``Decoder`` on the three legs must resolve to
   kernel A, C and B's route and launch it, and every rank's [4] stats
   must equal a recount in this process (``sim_step`` on the seed rule's
   generator of every (position, point), summed over the data axis), every
   field; (c) config 5 through the real entry point, ``python -m
   torch.distributed.run --standalone --nproc-per-node 4 -m
   myldpccppapi_torch -- waterfall ... --snr-shards 2 --dist-backend gloo
   --batch 1024`` (512 frames a data rank, up to 100 frame errors or 8192
   frames a point) for both families, then again from its checkpoint: no
   new step.  A rank that fails, or a non-zero exit, fails the phase.
4q. (runs after 4o, like 4r and 4s) Learned min-sum weights: (a)
   ``train_nms`` on the card at benchmarks/learned_nms.py:98-99's point
   (wimax 576 r3/4B, 8 unrolled sweeps, batch 512, per-frame SNR over
   4-5.5 dB, lr 0.02, one tied row), cut from 300 to 40 steps: the losses
   finite and falling (the trained row's loss on a fixed held-out batch
   of 2048 frames below alpha 0.75's; the per-step losses of fresh batches
   are logged, first and last ten), the weights inside their clip range;
   (b) one unrolled forward and gradient on the card equal to the CPU's
   on the same LLRs (posteriors bit-exact, the loss to rtol 1e-5, the
   gradient to the tests' rtol 1e-4 + atol 1e-5 of its largest); (c) the
   trained and the stored ``learned_weights_wimax576_r34B_tied.json``
   tied schedules through ``Decoder`` on kernel A at phase 4's bench point
   (8192 frames, 5 dB, triage 5), each equal to ``Decoder(implementation=
   "torch")`` in every field, with bench.py's gates; (d) the stored
   ``learned_weights_nr_bg2_z384_tied.json`` on nr_code(384, 2), 8
   sweeps, the whole codeword through BPSK/AWGN at -3 dB (the schedule's
   own channel), batch 1024, on kernel C, equal to its plain version;
   (e) the stored per-iteration ``learned_weights_wimax576_r12_T10.json``
   (12 sweeps, soft output) through ``"auto"`` on the card, which must
   resolve to the torch path (the reference's jnp route), equal to the
   CPU in every field (phase 4u's case (c), timed in 4u).
4r. GDBF (ops/bitflip.py, torch ops): at phase 4's LLRs without the
   perturbation the card equals the CPU in every field; the default
   (noise 0.6) through ``Decoder`` at 6 and 7 dB (8192 frames encoded on
   the card; converged frames hold a zero syndrome; FER and mean
   iterations logged); rs_ldpc() at phase 4k's 6.5 dB batch and at 9 dB;
   the ``Coder`` BF byte stream (1024 codewords, sigma 0.21) on the card,
   decoded bytes equal to the source.
4s. CLI ``probe`` at its defaults on the card (wimax 576 r1/2, amplitude
   8, up to 2048 pairs: kernel A, launches counted), its ``ImpulseReport``
   equal to the CPU's in every field; ``impulse_probe(nr_code(384, 1),
   max_pair_patterns=256)`` on kernel C equal to the same probe on the
   torch path of the card; one ``Decoder`` call inside
   ``utils.profiling.trace``, whose Chrome trace names
   ``bp_layered_kernel``.
4t. (not BASELINE config 4t, which is phase 4o) The native host library
   (``myldpccppapi_torch/native``: the C++ goldens and packed GF(2)
   kernels, built with g++ in phase 2 on the card's host, its seconds
   logged): the ``Coder`` decode type ``CPU`` (its C++ flooding golden)
   round trips phase 4's stream (every converged codeword's bytes equal
   the source) and equals the NumPy golden (ops/golden.py) on its first
   128 codewords (converged, iterations, bits of converged frames);
   kernel A without triage at the bench point's first 256 frames equals
   ``native.decode_golden_layered_native`` in bits, converged and
   iterations; then CLI ``bench``'s ``bench.measure()`` at full size
   (wimax 576 r3/4B, 8192 frames, 5 dB, triage 5, 7 timed calls), its
   gates held and its JSON record logged as a ``{"bench": ...}`` line;
   kernel A's launches there go into its kernels-line entry
   (``bench_launches``).
4u. (runs after 4t) The torch route: what no kernel's gate admits, and
   the reference sends to its jnp path (XLA ops), runs on torch ops on the
   card (``Decoder`` resolves ``"auto"`` to ``"torch"``), through the normal
   entry points at full width.  Each case must resolve to the torch path,
   launch none of the port's kernels and, on the batch's first frames,
   equal the same ``Decoder`` on the CPU in every field (sum-product: equal
   bits and converged flags at a converging point, its largest posterior
   difference logged); its time (median of 3 CUDA-event-timed calls), its
   CUDA kernels and host-to-device copies (``torch.profiler``) and its
   busy share are logged.  (a) NR BG1 Z=384 on phase 4b's 5 dB
   LLRs (batch 512, 30 sweeps): flooding NMS alpha 0.8, SCMS, flooding
   sum-product with soft output; then ``make_codec("nr", z=384)``'s byte
   stream (64 codewords at 3 dB) through SCMS (the torch route; its first
   8 codewords equal to the CPU decode) and MSCL (the layered substitution
   on kernel C, with its warning); (b) DVB-S2 16200 r1/2 at 1.5 dB and
   64800 r1/2 at 1.4 dB, flooding NMS alpha 0.85, batch 1024 (64800: one
   timed call, 4 frames against the CPU); (c) phase 4q (e)'s per-iteration
   schedule, timed; (d) ``rs_ldpc_from_n(8192)`` at batch 256, 6.5 dB,
   layered and flooding, then its ``Coder("MSCL")`` stream (256
   codewords), which must warn as the reference does and decode every
   converged codeword to its source bytes; (e) soft output on
   nr_code(32, 1), batch 512, 3 dB; (f) one CLI ``waterfall --family nr
   --z 384 --schedule flooding`` point at 5 dB, 512 frames.
6. (runs first, after the build) Kernel E, the op-rate calibration
   (csrc/op_rate.cu, tools/roofline.py): its five bodies (E's fma4, mix3
   and mix4; sfu, the decoders' phi; mufu, bare ex2/lg2) against their
   plain version on CUDA at 200 iterations on a grid that fills every SM,
   bit-exact but mufu (to roofline.MUFU_ATOL); then the calibrated f32
   instruction rate (fma4) and special-function result rate (mufu), each
   at two depths, which must not pass the card's issue ceiling (SMs x 128
   FP32 or x 16 MUFU per clock at the maximum SM clock) by more than 5%;
   every later ``bound()`` divides by them.
3i. Kernel A's xor group (RS-LDPC) vs plain: rs_ldpc(s=4, gamma=4,
   rho=8) (n=128), rs_ldpc(s=5) (n=1024) and rs_ldpc() (2048): layered
   alpha 0.75 and per layer, flooding, SCMS, sum-product layered and
   flooding, soft output layered and flooding, bf16 layered and bf16
   flooding sum-product, at an SNR where nearly every frame converges and
   one where most run 20 iterations, early exit on, and off at the easy
   SNR (90 cases): bit-exact at batch 101 (a ragged tile) against the
   plain version on CUDA, posteriors included; at the easy SNR the f32
   modes at batch 16 against it on the CPU for n <= 1024 (sum-product as
   in 3d).
3j. Kernel A's multi-edge cells vs plain: wimax 576 r1/2 (z=24) with extra
   circulants in two layers, and with cells making up ten of one layer's
   twelve circulants; layered alpha 0.75 and per layer, sum-product
   layered, soft output layered, bf16 layered, flooding and SCMS, at 5
   and 1 dB (42 cases), held as in 3i; then ``Decoder`` on the second code
   at batch 1000, 5 dB.
4k. RS-LDPC main path (benchmarks/rs_ldpc_bench.py): ``Decoder(rs_ldpc(),
   layered NMS alpha 0.75, 20 iterations)`` at batch 2048, 6.5 dB, noise
   from a torch.Generator on the card, must resolve to ``"cuda"`` (the xor
   mode) and pass bench.py's gates, equal to the plain version; then
   ``make_codec("rs_ldpc")``'s byte stream through TDMPCL (1024 codewords
   at 7 dB) and ``make_codec("wimax", 576, "1/2", crc="16")``'s through
   its CRC path (2048 codewords at 5 dB): the decoded bytes equal the
   source.
4l. BASELINE config 2 (benchmarks/run_baseline.py:368-398): the code of
   ``make_codec("wifi", 1944, "5/6")`` at batch 4096, 6.5 dB, layered NMS
   alpha 0.75, early exit, through ``Decoder`` on kernel A's cyclic
   layered mode, with bench.py's gates.
5. Times: CUDA events, median of 7 after a warm-up (for the plain versions
   but the layered short-code and NR min-sum ones, one timed call after the
   warm-up: they measure the host, not the card): each kernel and its plain version (single pass, no
   triage) and the whole Decoder call, at the main paths' shapes (the
   wimax Decoder's two triage passes apart: the fast pass over the batch
   and the straggler pass over its cap), DVB-S2
   64800 in lazy and exact mode, kernel A's flooding, SCMS, sum-product and
   layered soft-output modes at phase 4d's shape, kernel B's route at
   nr_code(32, 1), batch 4096, 3 dB; the kernel on dvbs2(16200, "1/2") at
   batch 1024, its posterior in shared and in global memory; kernel C's
   sum-product and soft output on phase 4b's 5 dB LLRs and soft output on
   phase 4c's 1.4 dB ones; the 3m and 4m receive paths (the demap alone,
   the decode, both together); one BICM-ID step (two exchanges); and the
   bf16 main paths (kernel A at wimax 576, C at NR and at DVB-S2 64800 in
   both placements); kernel A's xor mode on 4k's path, its multi-edge mode
   on 3j's ``Decoder`` shape and config 2 (4l); phase 4n's oracle
   ``Decoder`` call (median of 5), its sweeps, the torch ops that launch a
   kernel (counted by a ``TorchDispatchMode``) and the CUDA kernels
   (``torch.profiler``) of one call per sweep, and the kernels' device
   time over the call's time (the busy share); config 4t's receive alone
   and encode + channel + receive (median of 5), as payload Mbit/s;
   phase 4p's config-5 campaign frames/s of each family at world 1 (NCCL,
   the step already warm) and at 4 ranks on the card (the CLI's own wall
   times), also over the points past the first group (whose steps carry
   each rank's first launches and first collective), the step's
   collective (NCCL at world 1; gloo at 4 ranks, per rank) and the spawn
   and init seconds of the 4 ranks; phase 4q's training step (ms), the
   bench point's ``Decoder`` with the trained and stored tied schedules
   against alpha 0.75's (ms, mean iterations); GDBF's ``Decoder`` on phase
   4's LLRs (ms per batch and per iteration, torch ops and CUDA kernels
   an iteration, busy share); the probes' seconds.

The line before the last is the kernels' JSON record, one entry per kernel
and mode: each ``launches`` counts its launches in its main path's
``Decoder`` call (and ``coder_launches`` those of the Coder TDMPCL, MSCL or
SCMS decode), each counter set to 0 just before its run; ``bound_ms`` is
the least time the card could take for the same work (:func:`bound`, at
phase 6's calibrated rates); the
sum-product entries' ``cpu_posterior_max_abs_err`` is their largest
posterior difference against the plain version on the CPU (phases 3d,
3f).  Kernel C's sum-product entry counts phase 4b's sum-product
``Decoder``, its soft-output entry the BICM-ID soft passes (phase 4g; its
times are phase 4b's soft ``Decoder``'s).  Each ``bp_long*`` entry adds
``lone_sweep_us`` (one block alone, early exit off, 30 sweeps against 1,
on phase 4b's first 5 dB codeword); phase 5 logs beside it the R bytes
of the library's scratch layout (min-sum records, or sum-product's
per-edge messages), which phase 2 holds against the record codec.  The global placement's
entries (``bp_stream*``, csrc/bp_stream.cu: the DVB-S2 64800 path lazy,
with soft output (phase 4c) and in bf16 (4h)); the lazy one adds the
exact syndrome's time (``exact_ms``).  Phase 5 logs, beside each of
their bounds, the design's own floor (:func:`streamed_floor`: the stage
plan's bytes over the HBM rate; ``bound_ms`` counts the state as on
chip).  The 3m and 4m receive paths add ``m3_*``/``m4_*`` fields to the
global and shared entries.  The bf16 entries count phase 4h's
``Decoder`` calls (the shared placement at DVB-S2 64800 its forced
decode; the bound writes posteriors at 2 B); config 1/1c (``config1*``) and the legs
(``acceptance_leg_*``) add their counts and times to the entries whose
kernel the acceptance wraps; ``bp_long`` adds config 4t's (``config4t_*``:
the launches of phase 4o's receive, its accepted TBs of ``config4t_tbs``,
the receive's time and payload Mbit/s, and those of encode + channel +
receive) and phase 4p's (``config5_*``: kernel C's launches in the
world-1 campaigns, and the campaigns' frames/s); the entries of the
kernels that the multi-rank dry run's legs run (``bp_layered`` leg 1,
``bp_layered_route_b`` leg 3, ``bp_long`` leg 2) add each rank's launches
(``multichip_4_ranks_launches``).  The edge-list path launches no kernel of its own, so its
record (phase 3k's worst difference, 4n's convergence counts and phase
5's times and launch counts) is a JSON line of its own, ``{"edgelist":
{...}}``, before the card's name; so are GDBF's (``{"gdbf": {...}}``)
and the trainer's (``{"train_nms": {...}}``) and phase 4u's torch route
(``{"torch_route": {...}}``: each case's times, counts and busy share;
``bp_long`` adds the NR MSCL stream's launches, ``mscl_nr_coder_launches``).  ``bp_layered`` adds the
tied schedules' launches and ``Decoder`` times (``learned_tied_*``) and
the CLI probe's (``probe_launches``, ``probe_s``) and phase 4t's bench
(``bench_launches``: its warm-up and timed calls; ``bench_mbits``,
``bench_batch_ms``, ``bench_vs_native_golden``; the whole record is the
``{"bench": ...}`` line of phase 4t); ``bp_long`` the NR BG2
schedule's (``learned_nr_bg2_launches``) and the NR probe's
(``probe_nr_launches``).  The last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from myldpccppapi_torch import (
    Coder,
    Decoder,
    DecoderConfig,
    Encoder,
    Modulation,
    QCCode,
    cli,
    demap_llr,
    dvbs2,
    make_bicm_id_receive,
    make_codec,
    make_modulation,
    modulate,
    nr_code,
    regular,
    rs_ldpc,
    wimax,
)
from myldpccppapi_torch.codes import (
    NRTransport,
    dvbs2_ira_qc,
    dvbs2_oracle,
    encode_numpy,
    ira_encode_fn,
    ira_encode_numpy,
    plan_tb,
    rate_match_bits,
    rate_match_llr,
    ru_precompute,
    std_interleave,
    triangular_encode_fn,
    triangular_encode_numpy,
)
from myldpccppapi_torch.codes.bch import bch_attach_fn, bch_matrix
from myldpccppapi_torch.codes.crc import CRC_POLYS, crc_attach_fn
from myldpccppapi_torch import bench, native
from myldpccppapi_torch.ops import _build, cuda_bp, cuda_stream, golden
from myldpccppapi_torch.ops.channel import sigma_from_snr_db, transmit
from myldpccppapi_torch.ops.cuda_bp import (
    decode_qc_cuda,
    decode_qc_cuda_plain,
    tile_size,
)
from myldpccppapi_torch.ops.cuda_long import (
    GLOBAL,
    SHARED,
    blocks_per_sm,
    decode_qc_long,
    decode_qc_long_plain,
    placement,
    scratch_bytes,
)
from myldpccppapi_torch.ops.bitflip import GDBFConfig, decode_gdbf
from myldpccppapi_torch.ops.bp import accept_fail_fn, msg_dtype
from myldpccppapi_torch.ops.impulse import impulse_probe
from myldpccppapi_torch.ops.learned import (
    LearnedWeights,
    make_unrolled,
    soft_ber_loss,
    train_nms,
)
from myldpccppapi_torch.ops.packing import unpack_bits_np
from myldpccppapi_torch.campaign import CampaignConfig, WaterfallCampaign
from myldpccppapi_torch.parallel import (
    dist as pdist,
    make_mesh,
    make_sharded_campaign_step,
    point_generator,
)
from myldpccppapi_torch.parallel.dryrun import (
    dryrun_multichip,
    leg_snrs,
    multichip_legs,
    multichip_mesh,
)
from myldpccppapi_torch.sim import SimStats, sim_step
from myldpccppapi_torch.utils.profiling import trace
from myldpccppapi_torch.tools.roofline import (
    BODIES,
    MUFU_ATOL,
    calibrate,
    ceilings,
    n_elements,
    op_rate,
    op_rate_plain,
)

SEED = 20260816
BATCH = 8192
SNR_DB = 5.0
#: phase 4d's Coder round trips are held against the CPU decode of this
#: many codewords of their stream
CPU_FRAMES = 2048
#: bench.py's operating point: layered NMS, alpha 0.75, 40 iterations,
#: two-phase triage with a 5-iteration fast pass
BENCH_CFG = DecoderConfig(algorithm="min-sum", schedule="layered",
                          normalization=0.75, max_iters=40, triage_iters=5)
RATES_576 = ("1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6")
FIELDS = ("bits", "converged", "iterations", "total_iters")
#: BASELINE config 4 (benchmarks/run_baseline.py config4): layered NMS
#: alpha 0.8, 30 iterations, batch 512, 3-6 dB
NR_CFG = DecoderConfig(normalization=0.8, max_iters=30)
#: kernel C's sum-product mode on the same path
NR_SP_CFG = DecoderConfig(algorithm="sum-product", max_iters=30)
NR_BATCH = 512
NR_SNRS = (3.0, 4.0, 5.0, 6.0)
#: kernel C cases: (z, bg, [an SNR where nearly every frame converges, one
#: where most frames run 30 iterations]) for rate-matched rv0 LLRs
NR_CASES = ((384, 1, (3.0, -1.25)), (384, 2, (3.0, -3.0)),
            (208, 1, (3.0, -1.25)))
#: BASELINE config 3 (benchmarks/run_baseline.py config3): DVB-S2 64800
#: r1/2, layered NMS alpha 0.85, 30 iterations, lazy syndrome, batch 1024
DVB_CFG = DecoderConfig(normalization=0.85, max_iters=30, syndrome_mode="lazy")
DVB_BATCH = 1024
DVB_SNRS = (1.0, 1.4)
#: kernel C/D DVB-S2 cases: (n, rate, placement, [an SNR where nearly every
#: frame converges, one where most frames run 30 iterations])
DVB_CASES = ((16200, "1/2", SHARED, (1.5, 0.0)), (16200, "8/9", SHARED, (6.5, 5.5)),
             (64800, "1/2", GLOBAL, (1.4, 1.0)), (64800, "3/4", GLOBAL, (4.2, 3.5)))
#: kernel A's new modes (phase 3d): name -> (kernels-line group, config
#: fields); "per-layer" gets one alpha per base row of each code
#: phase 3d's codes (RATES_576 at n=576, then n=2304 r1/2) that also run
#: at 2 dB and against the CPU at 5 dB: r1/2, r3/4B and n=2304
CPU_CODES = (0, 4, 6)
#: phase 3d's codes that also run at 2 dB: r1/2 and n=2304 (r3/4B
#: converges no frame there)
MODE_2DB_CODES = (0, 6)
#: phase 3's CPU comparison: the plain version on the CPU on this many
#: frames of each case's batch
CPU_CASE_FRAMES = 64
A_MODES = {
    "flooding alpha 1.0": ("flooding", dict(schedule="flooding")),
    "flooding alpha 0.75": ("flooding", dict(schedule="flooding", normalization=0.75)),
    "flooding per-layer": ("flooding", dict(schedule="flooding", normalization=None)),
    "flooding beta 0.25": ("flooding", dict(schedule="flooding", offset=0.25)),
    "scms": ("scms", dict(schedule="flooding", self_correction=True)),
    "sp flooding": ("sp", dict(schedule="flooding", algorithm="sum-product")),
    "sp soft flooding": ("sp", dict(schedule="flooding", algorithm="sum-product",
                                    soft_output=True)),
    "sp soft layered": ("sp", dict(algorithm="sum-product", soft_output=True)),
    "soft layered": ("soft", dict(normalization=0.75, soft_output=True)),
    "soft flooding": ("soft", dict(schedule="flooding", normalization=0.75,
                                   soft_output=True)),
}
#: phase 4d's main paths, on phase 4's code and LLRs; each names the
#: kernels-line group it gives launches and times to
MODE_CFGS = {
    "flooding": DecoderConfig(schedule="flooding", normalization=0.75, max_iters=40),
    "scms": DecoderConfig(schedule="flooding", self_correction=True, max_iters=40),
    "sp": DecoderConfig(schedule="flooding", algorithm="sum-product", max_iters=40),
    "soft": DecoderConfig(normalization=0.75, max_iters=40, soft_output=True),
}
#: kernel B's route (phase 3e): (z, bg) and, per base graph, an SNR where
#: nearly every frame converges and one where most run 30 iterations
B_CODES = ((16, 1), (32, 1), (56, 1), (8, 2), (40, 2))
B_SNRS = {1: (3.0, -1.25), 2: (3.0, -3.0)}
#: the route's main path and phase-5 shape
B_MAIN = (32, 1)
B_BATCH = 4096
B_SNR = 3.0
#: BASELINE 3m (benchmarks/run_baseline.py config3m): DVB-S2 64800 r3/4
#: received as 16APSK (gamma 2.85, the rate's EN 302 307 ring ratio),
#: max-log demap, phase 4c's decoder config (alpha 0.85, 30 iterations,
#: lazy syndrome), batch 1024, 14.8 dB
M3_RATE = "3/4"
M3_SNR = 14.8
#: BASELINE 4m (config4m): NR BG1 Z=384, rv0 over the full buffer, received
#: as 64QAM, max-log demap, NR_CFG, batch 512, 13.5 dB
M4_SNR = 13.5
#: BICM-ID (benchmarks/bicm_id_bench.py): DVB-S2 16200 r3/4 as quasi-Gray
#: 16APSK, alpha 0.85, 30 iterations, batch 1024, 13.9 dB, two exchanges
#: against one-shot on the same symbols; and its short-code case: wimax
#: 576 r1/2 as natural-label 8PSK, alpha 0.75, 30 iterations, 10 dB
ID_CFG = DecoderConfig(normalization=0.85, max_iters=30)
ID_BATCH = 1024
ID_SNR = 13.9
ID_OUTER = 2
ID_SHORT_CFG = DecoderConfig(normalization=0.75, max_iters=30)
ID_SHORT_BATCH = 2048
ID_SHORT_SNR = 10.0
#: bf16 messages (phases 3g, 3h, 4h): the main paths' configs in bf16
BF16 = dict(msg_dtype="bfloat16")
BF16_A_CFGS = {  # kernel A at wimax 576 r3/4B, batch 8192, 5 dB
    "layered": DecoderConfig(normalization=0.75, max_iters=40, **BF16),
    "sp flooding": DecoderConfig(schedule="flooding", algorithm="sum-product",
                                 max_iters=40, **BF16),
}
BF16_NR_CFGS = {  # kernel C at NR BG1 Z=384, batch 512, 5 dB
    "min-sum": dataclasses.replace(NR_CFG, **BF16),
    "sum-product": dataclasses.replace(NR_SP_CFG, **BF16),
    "soft": dataclasses.replace(NR_CFG, soft_output=True, **BF16),
}
BF16_DVB_CFG = dataclasses.replace(DVB_CFG, **BF16)
#: kernel A's other bf16 modes and kernel B's route (phase 3g), on
#: numpy LLRs at batch 1000
BF16_A_MODES = {
    "flooding": dict(schedule="flooding", normalization=0.75),
    "scms": dict(schedule="flooding", self_correction=True),
    "sp layered": dict(algorithm="sum-product"),
    "soft layered": dict(normalization=0.75, soft_output=True),
    "soft flooding": dict(schedule="flooding", normalization=0.75, soft_output=True),
}
#: BASELINE configs 1 and 1c (benchmarks/run_baseline.py config1, config1c):
#: regular (3,6) n=648, flooding sum-product, batch 64, 2 dB; 1c with
#: CRC-16-aided acceptance.  ACC_STEPS sim steps of each
ACC_CFG = DecoderConfig(algorithm="sum-product", schedule="flooding")
ACC_BATCH = 64
ACC_SNR = 2.0
ACC_STEPS = 16
#: phase 3i: RS-LDPC codes (s, gamma, rho) and, per code, an SNR where
#: nearly every frame converges and one where most run all 20 iterations
RS_CASES = ((4, 4, 8, (5.0, 1.0)), (5, 6, 32, (6.5, 5.0)), (6, 6, 32, (6.5, 5.0)))
#: kernel A's modes held on the xor group (3i); "per-layer" gets one alpha
#: per base row
XOR_MODES = {
    "layered": dict(normalization=0.75),
    "per-layer": dict(normalization=None),
    "flooding": dict(schedule="flooding"),
    "scms": dict(schedule="flooding", self_correction=True),
    "sp layered": dict(algorithm="sum-product"),
    "sp flooding": dict(schedule="flooding", algorithm="sum-product"),
    "soft layered": dict(normalization=0.75, soft_output=True),
    "soft flooding": dict(schedule="flooding", normalization=0.75, soft_output=True),
    "bf16 layered": dict(normalization=0.75, msg_dtype="bfloat16"),
    "bf16 sp flooding": dict(schedule="flooding", algorithm="sum-product",
                             msg_dtype="bfloat16"),
}
#: kernel A's modes held on multi-edge cells (3j)
ME_MODES = {
    "layered": dict(normalization=0.75),
    "per-layer": dict(normalization=None),
    "sp layered": dict(algorithm="sum-product"),
    "soft layered": dict(normalization=0.75, soft_output=True),
    "bf16 layered": dict(normalization=0.75, msg_dtype="bfloat16"),
    "flooding": dict(schedule="flooding", normalization=0.75),
    "scms": dict(schedule="flooding", self_correction=True),
}
#: 3j's SNRs on wimax 576 r1/2 with extra blocks: nearly every frame
#: converges at the first, most run all 40 iterations at the second
ME_SNRS = (5.0, 1.0)
#: the multi-edge entry's shape: 3j's code with the most cells, batch
#: 1000, 5 dB, layered NMS alpha 0.75, 40 iterations
ME_CFG = DecoderConfig(normalization=0.75, max_iters=40)
ME_BATCH = 1000
#: the RS-LDPC main path (benchmarks/rs_ldpc_bench.py:28-37): rs_ldpc() =
#: (2048, 1723), layered NMS alpha 0.75, 20 iterations, batch 2048, 6.5 dB;
#: its byte stream through make_codec("rs_ldpc") and TDMPCL at 7 dB
RS_CFG = DecoderConfig(schedule="layered", normalization=0.75, max_iters=20)
RS_BATCH = 2048
RS_SNR = 6.5
RS_STREAM_SNR = 7.0
RS_STREAM_CODEWORDS = 1024
#: BASELINE config 2 (benchmarks/run_baseline.py:368-398): wifi(1944,
#: "5/6"), layered NMS alpha 0.75, early exit, batch 4096, 6.5 dB
WIFI_CFG = DecoderConfig(schedule="layered", normalization=0.75, early_exit=True)
WIFI_BATCH = 4096
WIFI_SNR = 6.5
#: phase 6: kernel E against its plain version at this depth (bit-exact),
#: and its entry's times (fma4) at E_DEPTH
E_CHECK_DEPTH = 200
E_DEPTH = 1000
#: the kernel each leg of __graft_entry__.dryrun_multichip (built by
#: parallel/dryrun.py's multichip_legs) must resolve to on the card
LEG_KERNELS = {"wimax576_crc16": "cuda", "dvbs2_16200_bch": "cuda_long",
               "nr_bg1_z32_rm_crc16": "cuda"}
#: the edge-list path (phase 3k), CUDA against the CPU: the DVB-S2 16200
#: r1/2 oracle (auto) and wimax 576 r3/4B (explicit "edgelist"), batch 16,
#: layered NMS alpha 0.75, EL_ITERS sweeps, at an SNR where nearly every
#: frame converges and one where most run all the sweeps
EL_CASES = (("oracle", (2.0, 0.8)), ("wimax", (5.0, 1.0)))
EL_BATCH = 16
EL_ITERS = 20
#: phase 4n: BASELINE config 3's point (layered NMS alpha 0.85, 30
#: iterations, batch 1024, 1.4 dB) on the standard-domain oracle
ORACLE_CFG = DecoderConfig(normalization=0.85, max_iters=30)
ORACLE_SNR = 1.4
#: phase 4o: BASELINE config 4t (benchmarks/run_baseline.py:883-929): A =
#: 20000, G = 40000, QPSK (C = 3, K' = 6699, Z = 320), 128 TBs, 3.0 dB, the
#: transport's default decoder; and a small-Z block (Z = 48) on kernel B's
#: route at the same point
TB_ARGS = ((20000, 40000), dict(qm=2))
TB_SMALL_ARGS = ((1000, 3000), dict(bg=1, qm=2))
TB_BATCH = 128
TB_SNR = 3.0
TB_FIELDS = ("payload", "tb_ok", "tb_crc_ok", "cb_ok", "converged", "iterations")
#: phase 4p: BASELINE config 5 (benchmarks/run_baseline.py:1015-1066): 8
#: SNR points, layered NMS alpha 0.8, 25 iterations, NR BG1 z=64
#: (triangular encode) and DVB-S2 16200 r1/2 (IRA encode); through the CLI
#: on MP_RANKS ranks of the one card (gloo), snr 2 x data 2, a batch of
#: C5_BATCH (512 frames a data rank), up to C5_TARGET frame errors or
#: C5_MAX_FRAMES frames a point; at world 1 (NCCL) the whole batch on one rank
C5_CFG = DecoderConfig(schedule="layered", normalization=0.8, max_iters=25)
C5_SNRS = [0.5 * i for i in range(1, 9)]
C5_FAMILIES = {
    "nr_bg1_z64": ["--family", "nr", "--z", "64", "--bg", "1"],
    "dvbs2_short": ["--family", "dvbs2", "--n", "16200", "--rate", "1/2"],
}
C5_BATCH = 1024
C5_TARGET = 100
C5_MAX_FRAMES = 8192
MP_RANKS = 4
MP_SNR_SHARDS = 2
MP_TIMEOUT_S = 600
#: aten ops that launch no device kernel (views, host scalars)
#: phase 4q: benchmarks/learned_nms.py:98-99's training point (wimax 576
#: r3/4B, 8 unrolled sweeps, batch 512, per-frame SNR over 4-5.5 dB, lr
#: 0.02, one tied row of per-layer weights), cut from 300 steps to
#: LEARN_STEPS (depth, not width); the held-out batch of the "falling" gate
LEARN_KW = dict(n_iters=8, batch=512, snr_db=(4.0, 5.5), lr=0.02, tie_iters=True)
LEARN_STEPS = 40
LEARN_HELD_OUT = 2048
#: the stored schedules the reference trained (read, never written)
WEIGHTS_DIR = pathlib.Path(__file__).resolve().parent / "benchmarks"
#: (d): the stored NR schedule's point, nr_code(384, 2), 8 sweeps, -3 dB
LEARN_NR_ITERS = 8
LEARN_NR_SNR = -3.0
LEARN_NR_BATCH = 1024
#: (e): the stored per-iteration schedule on wimax 576 r1/2, 10 sweeps
LEARN_ITER_BATCH = 1024
LEARN_ITER_SNR = 2.0
#: phase 4r: GDBF at the bench code's batch; its noisy runs' SNRs, and
#: an RS-LDPC point where bit flipping converges (it converges no frame of
#: the (2048, 1723) code at phase 4k's 6.5 dB)
GDBF_SNRS = (6.0, 7.0)
GDBF_RS_SNR = 9.0
#: the Coder BF stream: codewords and channel sigma (the reference test's)
BF_CODEWORDS = 1024
BF_SIGMA = 0.21
#: phase 4s: the NR probe's pairs
PROBE_NR_PAIRS = 256
#: phase 4t: the codewords of phase 4's stream on which Coder("CPU") (the
#: C++ golden) is held against the NumPy golden, and the bench point's
#: frames on which kernel A is held against the C++ layered golden
#: (bench.py's baseline frames)
NATIVE_NUMPY_FRAMES = 128
NATIVE_LAYERED_FRAMES = 256
#: phase 4u: the torch route on the card (torch ops, no kernel), where no
#: kernel's gate admits a request and the reference takes its jnp path.
#: (a) NR BG1 Z=384 (config 4's code) on phase 4b's 5 dB LLRs, batch 512,
#: 30 sweeps, in the three modes no kernel serves on it (sum-product with
#: soft output, so that its posteriors are held too); its byte stream
#: through make_codec("nr", z=384) with SCMS (the torch route) and MSCL
#: (its layered substitution, on kernel C)
TR_NR_CFGS = {
    "flooding": DecoderConfig(schedule="flooding", normalization=0.8, max_iters=30),
    "scms": DecoderConfig(schedule="flooding", self_correction=True, max_iters=30),
    "sp flooding": DecoderConfig(schedule="flooding", algorithm="sum-product",
                                 soft_output=True, max_iters=30),
}
TR_NR_SNR = 5.0
TR_STREAM_CODEWORDS = 64
TR_STREAM_SNR = 3.0
#: each case's frames held against the CPU, and its timed calls
TR_CPU_FRAMES = 8
TR_REPS = 3
#: (b) DVB-S2 r1/2, flooding NMS alpha 0.85, 30 sweeps, batch 1024: (n,
#: SNR, timed calls, frames held against the CPU)
TR_DVB_CFG = DecoderConfig(schedule="flooding", normalization=0.85, max_iters=30)
TR_DVB_CASES = ((16200, 1.5, TR_REPS, 16), (64800, 1.4, 1, 4))
TR_DVB_BATCH = 1024
#: (d) rs_ldpc_from_n(8192), whose state no thread block holds: layered
#: and flooding NMS alpha 0.75, 20 sweeps, batch 256, 6.5 dB; its byte
#: stream through Coder("MSCL")
TR_RS_N = 8192
TR_RS_CFGS = {"layered": DecoderConfig(normalization=0.75, max_iters=20),
              "flooding": DecoderConfig(schedule="flooding", normalization=0.75,
                                        max_iters=20)}
TR_RS_BATCH = 256
TR_RS_SNR = 6.5
TR_RS_STREAM_CODEWORDS = 256
#: (e) soft output on nr_code(32, 1) (z < 64: kernel B's route and kernel
#: C refuse it): NR_CFG with soft output, rate-matched rv0 LLRs, batch 512
TR_SOFT_Z = 32
TR_SOFT_BATCH = 512
TR_SOFT_SNR = 3.0
NO_LAUNCH_OPS = {"view", "_unsafe_view", "t", "transpose", "slice", "select",
                 "unsqueeze", "squeeze", "expand", "alias", "detach",
                 "as_strided", "permute", "lift_fresh", "scalar_tensor",
                 "_local_scalar_dense"}
#: the card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s, which
#: bound() divides bytes by, and f32 operations/s outside the tensor cores
#: (a fused multiply-add counted as two), which phase 6 logs beside its
#: calibrated rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: the special-function units' rate (exp2, lg2): 16 results per clock and
#: SM on compute capability 9.0 (the CUDA C++ Programming Guide's
#: arithmetic-instruction throughput table) x 132 SMs x the H100 SXM's
#: 1.98 GHz boost clock
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
#: phase 6's calibrated rates on this card (kernel E's port,
#: tools/roofline.py), which bound() divides operations by: "f32" FP32
#: instructions/s (fma4), "sfu" special-function results/s (mufu)
RATES = {}
#: a calibrated rate above the card's issue ceiling by more than this
#: share means the loop was optimised away
RATE_SLACK = 0.05
#: f32 operations per edge and sweep that the decode itself needs, by mode,
#: each one FP32 instruction (what a kernel recomputes, such as q in a
#: second pass, is not counted; an abs or a negation is an operand
#: modifier of the instruction that reads it, so it is not counted
#: either):
#: layered min-sum: q, two mins and a max, the sign compare (5); the
#: compare of |q| with m1, the magnitude and sign selects, the delta and
#: its add to P (5);
#: flooding min-sum: the same 5, the two selects and the compare (3), one
#: add of the posterior rebuild (1);
#: SCMS: q is read, not formed: mins, max, sign (4), the compare and
#: selects (3), the rebuild add (1), and the next q: a subtraction, two
#: sign-bit reads and a select (4);
#: sum-product: q (1), phi(|q|) (3: two clamps and the subtraction of its
#: two log1pf), its add to the total and the sign compare (2), total -
#: phi(|q|) and phi of that (4), the sign select (1), plus the delta and
#: its add (2, layered) or the rebuild add (1, flooding).  Two phi per
#: edge, each an expf and two log1pf: six special-function results,
#: OPS_SFU_PER_EDGE_SWEEP.
OPS_PER_EDGE_SWEEP = {"layered": 10, "flooding": 9, "scms": 12,
                      "sp layered": 13, "sp flooding": 12}
OPS_SFU_PER_EDGE_SWEEP = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def shape(code, batch: int, mode_bits: int = 0, itemsize: int = 4) -> str:
    """Kernel A's launch shape for ``batch`` codewords: codewords per block
    (the tile the wrapper picks from the batch) and lanes per check row."""
    tile = tile_size(code, torch.cuda.current_device(), batch, mode_bits, itemsize)
    return f"tile={tile} L={cuda_bp.lanes(code)}"


def exits(easy: bool) -> tuple:
    """Early exit on, and off at the SNR where nearly every frame converges:
    there every latched block keeps sweeping, the path that early exit off
    adds.  At the hard SNR nearly no block finishes early, so early exit
    off runs the same sweeps as on, and is not repeated."""
    return (True, False) if easy else (True,)


def max_abs_diff(a, b) -> float:
    """Max |a - b| over the DecodeResult fields, the posteriors too where
    either has them; raises unless 0."""
    worst = 0.0
    if (a.posteriors is None) != (b.posteriors is None):
        raise AssertionError("posteriors: only one side has them")
    if a.posteriors is not None:
        x, y = a.posteriors.cpu(), b.posteriors.cpu()
        if not torch.equal(x, y):
            raise AssertionError(f"posteriors differ (max abs "
                                 f"{float((x - y).abs().max())})")
    for f in FIELDS:
        x = getattr(a, f).cpu().to(torch.int64)
        y = getattr(b, f).cpu().to(torch.int64)
        if x.shape != y.shape:
            raise AssertionError(f"{f}: shape {tuple(x.shape)} != {tuple(y.shape)}")
        d = float((x - y).abs().max()) if x.numel() else 0.0
        if d != 0.0:
            raise AssertionError(f"{f} differs (max abs {d})")
        worst = max(worst, d)
    return worst


def sp_cpu_diff(a, b) -> float:
    """Sum-product's tolerance against its plain version on the CPU, whose
    exp/log1p are not CUDA's: equal bits and converged flags, iterations
    within 1 (raises otherwise).  Returns the posteriors' max |a - b| (0.0
    without soft output)."""
    for f in ("bits", "converged"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"sum-product on the CPU: {f} differs")
    d_it = (a.iterations.cpu().to(torch.int64) - b.iterations.cpu()).abs().max()
    if int(d_it) > 1:
        raise AssertionError(f"sum-product on the CPU: iterations differ by {int(d_it)}")
    if a.posteriors is None:
        return 0.0
    return float((a.posteriors.cpu() - b.posteriors.cpu()).abs().max())


def numpy_llr(code, batch: int, snr_db: float, seed: int) -> np.ndarray:
    """Codewords of random info bits through BPSK/AWGN, noise from numpy
    (the code's own encoder precompute where it has one, else RU's)."""
    rng = np.random.default_rng(seed)
    mats = getattr(code, "encoder_matrices", None) or ru_precompute(code)
    u = rng.integers(0, 2, size=(batch, mats.w.shape[1]), dtype=np.uint8)
    c = encode_numpy(mats, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def nr_numpy_llr(code, batch: int, snr_db: float, seed: int) -> torch.Tensor:
    """NR codewords of random info bits, rate-matched rv0 over the full
    buffer, through BPSK/AWGN (noise from numpy), de-rate-matched: [batch,
    n] float32 on the CPU with LLR 0 in the 2Z punctured columns."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    tx = triangular_encode_numpy(code, u)[:, code.punctured_front:]
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * tx.astype(np.float32) + sigma * rng.standard_normal(tx.shape).astype(np.float32)
    return rate_match_llr(code, torch.from_numpy((y * np.float32(2 / sigma**2)).astype(np.float32)))


def phase_long_kernel_vs_plain() -> float:
    worst = 0.0
    n_cases = 0
    for ci, (z, bg, snrs) in enumerate(NR_CASES):
        code = nr_code(z, bg)
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.7, 0.9, code.m_b), 3))
        for si, snr in enumerate(snrs):
            llr_gpu = nr_numpy_llr(code, 101, snr, SEED + 100 + ci).cuda()
            llr_cpu = llr_gpu[:16].cpu()
            shown = None  # the alpha 0.8, early-exit case, for the log
            for alpha in (0.8, per_layer):
                for early_exit in exits(si == 0):
                    cfg = DecoderConfig(normalization=alpha, max_iters=30,
                                        early_exit=early_exit)
                    k = decode_qc_long(code, cfg, llr_gpu)
                    k16 = decode_qc_long(code, cfg, llr_cpu.cuda())
                    torch.cuda.synchronize()
                    worst = max(worst,
                                max_abs_diff(k, decode_qc_long_plain(code, cfg, llr_gpu)),
                                max_abs_diff(k16, decode_qc_long_plain(code, cfg, llr_cpu)))
                    n_cases += 1
                    shown = shown or k
            at_max = (shown.iterations == 30).float().mean().item()
            log(f"[phase3b] {code.name} snr={snr} "
                f"conv={shown.converged.float().mean().item():.4f} "
                f"at_30_iters={at_max:.4f} total_iters={int(shown.total_iters)}: "
                "kernel == plain (cpu, cuda)")
    # the main path's batch spans more than one wave of resident blocks;
    # frames that run all 30 sweeps exercise every block's R slice there
    z, bg, (_, hard) = NR_CASES[0]
    code = nr_code(z, bg)
    cfg = DecoderConfig(normalization=0.8, max_iters=30, early_exit=False)
    llr = nr_numpy_llr(code, NR_BATCH, hard, SEED + 200).cuda()
    k = decode_qc_long(code, cfg, llr)
    torch.cuda.synchronize()
    worst = max(worst, max_abs_diff(k, decode_qc_long_plain(code, cfg, llr)))
    n_cases += 1
    log(f"[phase3b] {code.name} batch={NR_BATCH} snr={hard} early_exit=off "
        f"conv={k.converged.float().mean().item():.4f} "
        f"total_iters={int(k.total_iters)}: kernel == plain (cuda)")
    d, n = wave_cases("phase3b", code, lambda b, s: nr_numpy_llr(code, b, hard, s).cuda(),
                      SEED + 210)
    log(f"[phase3b] {n_cases + n} cases bit-exact")
    return max(worst, d)


def wave_cases(tag, code, make_llr, seed) -> tuple[float, int]:
    """The shared placement at batch 1 (one block: early exit on and off)
    and at more than two waves of resident blocks (early exit off: every
    block runs every sweep, its records or messages read back each sweep),
    min-sum in f32 and bf16 and sum-product, posteriors compared, against
    the plain version on CUDA.  Returns the largest difference (0.0: any
    other raises) and the cases run."""
    base = NR_CFG if code.name.startswith("nr") else dataclasses.replace(DVB_CFG,
                                                                      syndrome_mode="exact")
    many = (dataclasses.replace(base, early_exit=False, soft_output=True),
            dataclasses.replace(base, early_exit=False, msg_dtype="bfloat16", soft_output=True),
            dataclasses.replace(NR_SP_CFG, early_exit=False))
    wave = torch.cuda.get_device_properties(0).multi_processor_count * max(
        blocks_per_sm(code, cfg, SHARED) for cfg in many)
    cases = [(1, dataclasses.replace(base, soft_output=True)),
             (1, dataclasses.replace(base, early_exit=False, soft_output=True)),
             *((2 * wave + 37, cfg) for cfg in many)]
    worst = 0.0
    for batch, cfg in cases:
        before = decode_qc_long.launches
        k, d = check_long(code, cfg, make_llr(batch, seed + batch))
        if decode_qc_long.launches != before + 1:
            raise AssertionError(f"{code.name}: not launched in the shared placement")
        worst = max(worst, d)
        log(f"[{tag}] {code.name} batch={batch} ({wave} blocks a wave) {cfg.algorithm} "
            f"{cfg.msg_dtype} early_exit={cfg.early_exit} {summary(k)}: kernel == plain (cuda)")
    return worst, len(cases)


def phase_long_modes_vs_plain() -> tuple[dict, float]:
    """Phase 3f; returns the largest difference per kernels-line group
    ("sp", "soft") against the plain version on CUDA (0.0: any other
    raises) and sum-product's largest posterior difference against it on
    the CPU."""
    dev = torch.cuda.current_device()
    nr1, nr2 = nr_code(384, 1), nr_code(64, 2)
    d16, d64 = dvbs2(16200, "1/2"), dvbs2(64800, "1/2")
    # (code, batch, snr, mode, config fields, compare on the CPU at batch
    #  16, force the global placement); sum-product's hard SNRs lie below
    #  min-sum's, since it converges where min-sum does not
    cases = []
    for mode, snr, syn, ee, cpu in (
            ("sp", 3.0, "exact", True, True), ("sp", -2.0, "exact", True, False),
            ("soft", 3.0, "exact", True, True), ("soft", -1.25, "exact", False, False),
            ("sp soft", -2.0, "lazy", True, False), ("sp soft", 3.0, "exact", False, False)):
        cases.append((nr1, 64, snr, mode, dict(syndrome_mode=syn, early_exit=ee), cpu, False))
    cases.append((nr1, 64, 3.0, "soft", dict(max_iters=0), False, False))
    for mode, snr, syn, ee in (("sp soft", 3.0, "exact", True), ("soft", -3.0, "lazy", False),
                               ("sp", -4.0, "exact", True)):
        cases.append((nr2, 64, snr, mode, dict(syndrome_mode=syn, early_exit=ee), False, False))
    for mode, snr, syn, ee, cpu in (
            ("sp soft", 1.5, "exact", True, True), ("soft", 0.0, "lazy", False, True),
            ("sp soft", 0.0, "lazy", True, False), ("sp soft", 1.5, "exact", False, False)):
        cases.append((d16, 64, snr, mode, dict(syndrome_mode=syn, early_exit=ee), cpu, False))
    for mode, snr, kw in (("soft", 1.4, dict(syndrome_mode="lazy")),
                          ("soft", 1.4, dict(syndrome_mode="lazy", early_exit=False)),
                          ("sp soft", 1.0, dict(syndrome_mode="exact"))):
        cases.append((d64, 16, snr, mode, kw, False, False))
    cases.append((dvbs2(64800, "9/10"), 16, 6.5, "sp soft", {}, False, False))
    cases.append((nr1, 64, -2.0, "sp soft", {}, False, True))
    worst = {"sp": 0.0, "soft": 0.0}
    sp_cpu_post = 0.0
    llrs = {}
    for ci, (code, batch, snr, mode, kw, cpu, force) in enumerate(cases):
        key = (code.name, batch, snr)
        if key not in llrs:
            seed = SEED + 600 + len(llrs)
            llrs[key] = (nr_numpy_llr(code, batch, snr, seed) if code.name.startswith("nr")
                         else dvbs2_llr(code, batch, snr, seed))
        llr_cpu = llrs[key]
        llr_gpu = llr_cpu.cuda()
        fields = {"max_iters": 30, **kw}
        if "sp" in mode.split():
            fields["algorithm"] = "sum-product"
        else:
            fields["normalization"] = 0.8
        fields["soft_output"] = "soft" in mode.split()
        cfg = DecoderConfig(**fields)
        group = "sp" if cfg.algorithm == "sum-product" else "soft"
        before = (decode_qc_long.global_launches, decode_qc_long.soft_launches,
                  decode_qc_long.sp_launches)
        k = decode_qc_long(code, cfg, llr_gpu, _place=GLOBAL if force else 0)
        torch.cuda.synchronize()
        after = (decode_qc_long.global_launches, decode_qc_long.soft_launches,
                 decode_qc_long.sp_launches)
        want_global = force or placement(code, dev) == GLOBAL
        if (after[0] > before[0], after[1] > before[1], after[2] > before[2]) != (
                want_global, cfg.soft_output, cfg.algorithm == "sum-product"):
            raise AssertionError(f"{code.name} {mode}: launched the wrong mode")
        worst[group] = max(worst[group],
                           max_abs_diff(k, decode_qc_long_plain(code, cfg, llr_gpu)))
        where = "global" if want_global else "shared"
        note = "cuda"
        if force:
            worst[group] = max(worst[group], max_abs_diff(k, decode_qc_long(code, cfg, llr_gpu)))
            note = "cuda; forced global == shared"
        if cpu:
            cpu16 = llr_cpu[:16].contiguous()
            k16 = decode_qc_long(code, cfg, cpu16.cuda(), _place=GLOBAL if force else 0)
            p16 = decode_qc_long_plain(code, cfg, cpu16)
            if cfg.algorithm == "sum-product":
                sp_cpu_post = max(sp_cpu_post, sp_cpu_diff(k16, p16))
                note += "; cpu: equal bits and converged flags"
            else:
                worst[group] = max(worst[group], max_abs_diff(k16, p16))
                note += ", cpu"
        if cfg.soft_output:
            hard = (k.posteriors <= 0).to(torch.uint8)
            if cfg.max_iters and not torch.equal(hard, k.bits):
                raise AssertionError(f"{code.name} {mode}: bits disagree with posteriors")
            if not cfg.max_iters and not torch.equal(k.posteriors, llr_gpu):
                raise AssertionError("max_iters=0: the posterior is not the channel LLR")
        log(f"[phase3f] {code.name} {where} {mode} snr={snr} "
            + " ".join(f"{a}={b}" for a, b in kw.items())
            + f" {summary(k)}: kernel == plain ({note})")
    log(f"[phase3f] {len(cases)} cases bit-exact against the plain version on "
        "CUDA (posteriors of every frame included); sum-product against the "
        "CPU at a converging point: equal bits and converged flags, "
        f"iterations within 1 (largest posterior difference {sp_cpu_post})")
    return worst, sp_cpu_post


def dvbs2_llr(code, batch: int, snr_db: float, seed: int) -> torch.Tensor:
    """DVB-S2 codewords of random info bits (``ira_encode_numpy``) through
    BPSK/AWGN, noise from numpy: [batch, n] float32 on the CPU."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = ira_encode_numpy(code, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return torch.from_numpy((y * np.float32(2 / sigma**2)).astype(np.float32))


def staircase_qc(z: int = 360, q: int = 54, kb: int = 108, seed: int = 7) -> QCCode:
    """The staircase QC code of the reference's tests/test_pallas.py
    (_staircase_qc: a p0 column and a dual-diagonal parity part, layers of
    unequal degree) at n_b = 162: its posterior, 233,280 B, passes a
    thread block's shared memory, so it is kernel D's own domain, a plain
    single-circulant code in the global placement (other sizes: the
    stage plan's corners)."""
    rng = np.random.default_rng(seed)
    base = np.full((q, kb + q), -1, dtype=np.int32)
    for g in range(kb):
        deg = 8 if g < kb // 3 else 3
        for l in rng.choice(q, size=deg, replace=False):
            base[l, g] = int(rng.integers(0, z))
    base[0, kb] = 1
    base[q // 2, kb] = 0
    base[q - 1, kb] = 1
    for j in range(q - 1):
        base[j, kb + 1 + j] = 0
        base[j + 1, kb + 1 + j] = 0
    return QCCode(name=f"staircase_z{z}_q{q}", base=base, z=z)


def window_qc(z: int = 96, m_b: int = 24, width: int = 6, seed: int = 9) -> QCCode:
    """Layer i holds columns i .. i + width - 1 (of m_b + width - 1), random
    shifts: consecutive layers share width - 1 columns, so the stage plan
    forwards nearly every cell."""
    rng = np.random.default_rng(seed)
    base = np.full((m_b, m_b + width - 1), -1, dtype=np.int32)
    for i in range(m_b):
        base[i, i:i + width] = rng.integers(0, z, size=width)
    return QCCode(name=f"window_z{z}_w{width}", base=base, z=z)


def all_zero_llr(code, batch: int, seed: int, lo: float = 1.0, hi: float = 8.0):
    """Consistent Gaussian LLRs of the all-zero codeword (a codeword of any
    code), mean m and variance 2m, m spread over the batch from hopeless
    to easy: [batch, n] float32 on the card."""
    rng = np.random.default_rng(seed)
    m = np.linspace(lo, hi, batch, dtype=np.float32)[:, None]
    return torch.from_numpy((m + np.sqrt(2 * m) * rng.standard_normal(
        (batch, code.n))).astype(np.float32)).cuda()


def check_long(code, cfg, llr_gpu, llr_cpu=None, force_global=False):
    """The long-code kernel against its plain version on the same LLRs, on
    CUDA and (``llr_cpu``) on the CPU; returns the CUDA result and the
    largest difference (0.0: any other raises)."""
    place = GLOBAL if force_global else 0
    k = decode_qc_long(code, cfg, llr_gpu, _place=place)
    torch.cuda.synchronize()
    worst = max_abs_diff(k, decode_qc_long_plain(code, cfg, llr_gpu))
    if llr_cpu is not None:
        k16 = decode_qc_long(code, cfg, llr_cpu.cuda(), _place=place)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_diff(k16, decode_qc_long_plain(code, cfg, llr_cpu)))
    return k, worst


def summary(res, cap: int = 30) -> str:
    return (f"conv={res.converged.float().mean().item():.4f} "
            f"at_{cap}_iters={(res.iterations == cap).float().mean().item():.4f} "
            f"total_iters={int(res.total_iters)}")


def phase_dvbs2_kernel_vs_plain() -> tuple[float, float]:
    """Returns the largest differences of the shared and the global mode
    (0.0: any other raises)."""
    dev = torch.cuda.current_device()
    worst = {SHARED: 0.0, GLOBAL: 0.0}
    n_cases = 0
    for ci, (n, rate, where, snrs) in enumerate(DVB_CASES):
        code = dvbs2(n, rate)
        if placement(code, dev) != where:
            raise AssertionError(f"{code.name}: placement {placement(code, dev)}, "
                                 f"expected {where}")
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.75, 0.9, code.m_b), 3))
        batch = 101 if n == 16200 else 64
        for si, snr in enumerate(snrs):
            llr_cpu = dvbs2_llr(code, batch, snr, SEED + 300 + ci)
            llr_gpu = llr_cpu.cuda()
            cpu16 = llr_cpu[:16].contiguous() if n == 16200 else None
            # alpha scalar at the easy SNR, per layer at the hard one
            alphas = ((0.85, per_layer)[si],)
            before = decode_qc_long.global_launches
            # 64800: early exit off runs in the main path's batch case
            # below, and the hard SNR runs lazy only (its plain version on
            # CUDA is what the phase's time goes to)
            for mode in ("exact", "lazy") if n == 16200 or si == 0 else ("lazy",):
                for alpha in alphas:
                    for early_exit in exits(si == 0 and n == 16200):
                        cfg = DecoderConfig(normalization=alpha, max_iters=30,
                                            early_exit=early_exit,
                                            syndrome_mode=mode)
                        k, d = check_long(code, cfg, llr_gpu, cpu16)
                        worst[where] = max(worst[where], d)
                        n_cases += 1
                        if early_exit:
                            log(f"[phase3c] {code.name} "
                                f"{'shared' if where == SHARED else 'global'} "
                                f"snr={snr} {mode} {summary(k)}: kernel == plain"
                                + (" (cpu, cuda)" if cpu16 is not None else " (cuda)"))
            if (decode_qc_long.global_launches > before) != (where == GLOBAL):
                raise AssertionError(f"{code.name} ran in the wrong placement")
    # rows of 40 circulants, in global memory
    code = dvbs2(64800, "9/10")
    cfg = DecoderConfig(normalization=tuple(np.round(np.linspace(0.75, 0.9, code.m_b), 3)),
                        max_iters=30, syndrome_mode="lazy")
    k, d = check_long(code, cfg, dvbs2_llr(code, 64, 6.5, SEED + 310).cuda())
    worst[GLOBAL] = max(worst[GLOBAL], d)
    n_cases += 1
    log(f"[phase3c] {code.name} (widest row {code.max_row_degree}) global "
        f"snr=6.5 lazy per-layer {summary(k)}: kernel == plain (cuda)")
    # kernel D's own domain: a plain QC code past shared memory
    code = staircase_qc()
    if placement(code, dev) != GLOBAL:
        raise AssertionError(f"{code.name} is not in the global placement")
    llr = all_zero_llr(code, 64, SEED + 320)
    for mode in ("exact", "lazy"):
        for early_exit in (True, False):
            cfg = DecoderConfig(normalization=0.8, max_iters=30,
                                early_exit=early_exit, syndrome_mode=mode)
            k, d = check_long(code, cfg, llr)
            worst[GLOBAL] = max(worst[GLOBAL], d)
            n_cases += 1
        log(f"[phase3c] {code.name} n={code.n} global {mode} {summary(k)}: "
            "kernel == plain (cuda)")
    # the global mode forced where shared memory would hold the posterior
    forced = ((nr_code(384, 1), DecoderConfig(normalization=0.8, max_iters=30),
               lambda snr, seed: nr_numpy_llr(nr_code(384, 1), 64, snr, seed),
               (3.0, -1.25)),
              (dvbs2(16200, "1/2"), DVB_CFG,
               lambda snr, seed: dvbs2_llr(dvbs2(16200, "1/2"), 64, snr, seed),
               (1.5, 0.0)))
    for fi, (code, base_cfg, make, snrs) in enumerate(forced):
        for snr in snrs:
            llr = make(snr, SEED + 330 + fi).cuda()
            for mode in ("exact", "lazy"):
                cfg = dataclasses.replace(base_cfg, syndrome_mode=mode)
                k, d = check_long(code, cfg, llr, force_global=True)
                worst[GLOBAL] = max(worst[GLOBAL], d,
                                    max_abs_diff(k, decode_qc_long(code, cfg, llr)))
                n_cases += 1
            log(f"[phase3c] {code.name} forced global snr={snr} {summary(k)}: "
                "kernel (global) == kernel (shared) == plain (cuda)")
    # the main path's batch, every block running all 30 sweeps
    code = dvbs2(64800, "1/2")
    cfg = dataclasses.replace(DVB_CFG, early_exit=False)
    k, d = check_long(code, cfg, dvbs2_llr(code, DVB_BATCH, 1.4, SEED + 340).cuda())
    worst[GLOBAL] = max(worst[GLOBAL], d)
    n_cases += 1
    log(f"[phase3c] {code.name} batch={DVB_BATCH} snr=1.4 lazy early_exit=off "
        f"{summary(k)}: kernel == plain (cuda)")
    # rows of 22 circulants in shared memory, one block and past two waves
    code = dvbs2(16200, "3/4")
    d, n = wave_cases("phase3c", code, lambda b, s: dvbs2_llr(code, b, 3.0, s).cuda(),
                      SEED + 345)
    worst[SHARED] = max(worst[SHARED], d)
    n_cases += n
    # the stage plan's corners, in the global placement
    corners = ((window_qc(), DecoderConfig(normalization=0.8, max_iters=30)),
               (staircase_qc(z=101, q=24, kb=48), DecoderConfig(normalization=0.8, max_iters=30,
                                                                syndrome_mode="lazy")),
               (staircase_qc(z=101, q=24, kb=48), DecoderConfig(normalization=0.8, max_iters=30,
                                                                msg_dtype="bfloat16",
                                                                soft_output=True)))
    for ci, (code, cfg) in enumerate(corners):
        plan = cuda_stream.stage_plan(code)
        k, d = check_long(code, cfg, all_zero_llr(code, 64, SEED + 350 + ci),
                          force_global=True)
        worst[GLOBAL] = max(worst[GLOBAL], d)
        n_cases += 1
        log(f"[phase3c] {code.name} forced global {cfg.msg_dtype} {cfg.syndrome_mode}: "
            f"{int((~plan.loaded).sum())} of {plan.total_cols} cells forwarded, "
            f"{summary(k)}: kernel == plain (cuda)")
    d, n = stream_turn_cases()
    worst[GLOBAL] = max(worst[GLOBAL], d)
    n_cases += n
    log(f"[phase3c] {n_cases} cases bit-exact")
    return worst[SHARED], worst[GLOBAL]


def stream_turn_cases() -> tuple[float, int]:
    """D's port's persistent grid on dvbs2(64800, "1/2") at 1.4 dB: at the
    main path's batch, past the card's resident blocks (turns of
    ``cuda_stream.TURN_SWEEPS`` sweeps from the queue), and at batch 64
    (one turn a codeword), every mode against the plain version on CUDA;
    then the clocked instantiation (a profiler recording) against the
    unclocked one, in f32 and bf16, its sweeps equal to the frames'
    iterations and its turns as the launcher's rule says.  Returns the
    largest difference (0.0: any other raises) and the cases run."""
    code = dvbs2(64800, "1/2")
    slots = torch.cuda.get_device_properties(0).multi_processor_count * \
        cuda_stream.blocks_per_sm(code, False, 4)
    bf16 = dataclasses.replace(DVB_CFG, msg_dtype="bfloat16")
    modes = (dataclasses.replace(DVB_CFG, syndrome_mode="exact"), DVB_CFG,
             dataclasses.replace(DVB_CFG, early_exit=False, soft_output=True),
             dataclasses.replace(bf16, soft_output=True),
             dataclasses.replace(bf16, syndrome_mode="exact", early_exit=False),
             DecoderConfig(algorithm="sum-product", max_iters=30, syndrome_mode="lazy"),
             DecoderConfig(algorithm="sum-product", max_iters=30, msg_dtype="bfloat16",
                           soft_output=True))
    worst, n_cases = 0.0, 0
    for batch in (DVB_BATCH, 64):
        llr = dvbs2_llr(code, batch, 1.4, SEED + 360 + batch).cuda()
        quantum = cuda_stream.turn_sweeps(batch, slots, DVB_CFG.max_iters)
        for cfg in modes:
            before = decode_qc_long.global_launches
            k, d = check_long(code, cfg, llr)
            if decode_qc_long.global_launches != before + 1:
                raise AssertionError(f"{code.name} batch={batch}: not the global placement")
            worst = max(worst, d)
            n_cases += 1
            log(f"[phase3c] {code.name} batch={batch} ({slots} slots, turns of {quantum}) "
                f"{cfg.algorithm} {cfg.msg_dtype} {cfg.syndrome_mode} "
                f"early_exit={cfg.early_exit} {summary(k)}: kernel == plain (cuda)")
        for cfg in (DVB_CFG, bf16):
            plain = decode_qc_long(code, cfg, llr)
            before = cuda_stream.phase_cycles() or dict.fromkeys(cuda_stream.PHASE_SLOTS, 0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                clocked = decode_qc_long(code, cfg, llr)
                torch.cuda.synchronize()
            after = cuda_stream.phase_cycles()
            got = {key: after[key] - before[key] for key in cuda_stream.PHASE_SLOTS}
            worst = max(worst, max_abs_diff(clocked, plain))
            n_cases += 1
            iters = clocked.iterations.to(torch.int64)
            want = (iters + quantum - 1) // quantum
            if got["sweeps"] != int(iters.sum()) or got["turns"] != int(want.clamp(min=1).sum()):
                raise AssertionError(f"{code.name} batch={batch} {cfg.msg_dtype}: clocked "
                                     f"sweeps {got['sweeps']}, turns {got['turns']}; the "
                                     f"frames' {int(iters.sum())} and {int(want.sum())}")
            phases = sum(got[key] for key in cuda_stream.PHASES)
            log(f"[phase3c] {code.name} batch={batch} {cfg.msg_dtype} clocked == unclocked: "
                f"{got['turns']} turns, {got['sweeps'] / got['turns']:.3f} sweeps a turn, "
                f"phases {phases / got['resident']:.4f} of resident")
    return worst, n_cases


def phase_kernel_vs_plain() -> float:
    """Phase 3: the per-layer alpha only; alpha 0.75 runs the same layered
    instantiation in phase 3d's "soft layered" case on every code, SNR and
    early-exit setting.  Then bench.py's single pass at the launch shapes
    the main path meets: batch 1 (one block), a batch below the SM count,
    and the triage's straggler pass (its cap of frames, those that failed
    the fast pass first)."""
    codes = [wimax(576, r) for r in RATES_576] + [wimax(2304, "1/2")]
    worst = 0.0
    n_cases = 0
    for ci, code in enumerate(codes):
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.65, 0.85, code.m_b), 3))
        # 2 dB on the three codes phase 3d also runs there
        for snr in (5.0, 2.0) if ci in CPU_CODES else (5.0,):
            llr = numpy_llr(code, 1000, snr, SEED + ci)
            llr_gpu = torch.from_numpy(llr).cuda()
            # the CPU plain version on the first CPU_CASE_FRAMES frames (a
            # frame decodes alike in any batch; the CPU takes seconds a
            # thousand)
            llr_cpu = torch.from_numpy(llr[:CPU_CASE_FRAMES])
            for early_exit in exits(snr == 5.0):
                cfg = DecoderConfig(normalization=per_layer, max_iters=40,
                                    early_exit=early_exit)
                k = decode_qc_cuda(code, cfg, llr_gpu)
                k_few = decode_qc_cuda(code, cfg, llr_cpu.cuda())
                torch.cuda.synchronize()
                worst = max(worst,
                            max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_gpu)),
                            max_abs_diff(k_few, decode_qc_cuda_plain(code, cfg, llr_cpu)))
                n_cases += 1
            log(f"[phase3] {code.name} {shape(code, 1000)} snr={snr} "
                f"conv={k.converged.float().mean().item():.4f} "
                f"total_iters={int(k.total_iters)}: kernel == plain (cuda; cpu on "
                f"{CPU_CASE_FRAMES} frames)")
    code = wimax(576, "3/4B")
    single = dataclasses.replace(BENCH_CFG, triage_iters=0)
    fast = dataclasses.replace(single, max_iters=BENCH_CFG.triage_iters)
    llr = torch.from_numpy(numpy_llr(code, BATCH, SNR_DB, SEED + 60)).cuda()
    bad = ~decode_qc_cuda(code, fast, llr).ok
    cap = max(8, int(BATCH * BENCH_CFG.triage_cap_frac))
    stragglers = llr[torch.argsort((~bad).to(torch.uint8), stable=True)[:cap]].contiguous()
    small = (("batch 1", llr[:1].contiguous()), ("batch 70", llr[:70].contiguous()),
             (f"straggler pass ({int(bad.sum())} of {cap} failed the fast pass)",
              stragglers))
    for what, x in small:
        k = decode_qc_cuda(code, single, x)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_diff(k, decode_qc_cuda_plain(code, single, x)))
        n_cases += 1
        log(f"[phase3] {code.name} {what} {shape(code, x.shape[0])} "
            f"conv={k.converged.float().mean().item():.4f} "
            f"total_iters={int(k.total_iters)}: kernel == plain (cuda)")
    log(f"[phase3] {n_cases} cases bit-exact")
    return worst


def phase_modes_vs_plain() -> tuple[dict, float]:
    """Phase 3d; returns the largest difference per kernels-line group
    against the plain version on CUDA (0.0: any other raises) and
    sum-product's largest posterior difference against it on the CPU."""
    dev = torch.cuda.current_device()
    # torch's phi inputs (x in [1e-7, 30]) where its CPU exp or log1p give
    # other f32 results than its CUDA ones
    x = torch.linspace(1e-7, 30.0, 1_000_001)
    ex = torch.exp(-x)
    n_exp = int((ex != torch.exp(-x.cuda()).cpu()).sum())
    ex_gpu = ex.cuda()
    n_log = int(((torch.log1p(ex) != torch.log1p(ex_gpu).cpu())
                 | (torch.log1p(-ex) != torch.log1p(-ex_gpu).cpu())).sum())
    log(f"[phase3d] torch exp(-x) cpu != cuda on {n_exp}, log1p(+-e) on "
        f"{n_log} of {x.numel()} phi inputs")
    codes = [wimax(576, r) for r in RATES_576] + [wimax(2304, "1/2")]
    worst = {group: 0.0 for group, _ in A_MODES.values()}
    sp_cpu_post = 0.0
    n_cases = 0
    erased = 0
    for ci, code in enumerate(codes):
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.65, 0.85, code.m_b), 3))
        # 2 dB on two of the codes: every mode there runs the same
        # instantiations as at 5 dB, with most blocks at 40 sweeps
        for snr in (5.0, 2.0) if ci in MODE_2DB_CODES else (5.0,):
            llr_cpu = torch.from_numpy(numpy_llr(code, 1000, snr, SEED + 400 + ci))
            llr_gpu = llr_cpu.cuda()
            cpu16 = llr_cpu[:16].contiguous()
            shown = {}
            for name, (group, kw) in A_MODES.items():
                if kw.get("normalization", 1.0) is None:
                    kw = dict(kw, normalization=per_layer)
                # early exit off on the CPU codes only
                for early_exit in exits(snr == 5.0 and ci in CPU_CODES):
                    cfg = DecoderConfig(max_iters=40, early_exit=early_exit, **kw)
                    k = decode_qc_cuda(code, cfg, llr_gpu)
                    worst[group] = max(
                        worst[group],
                        max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_gpu)))
                    # against the CPU at 5 dB only, on the codes that also
                    # run at 2 dB (r1/2, r3/4B, n=2304): at 2 dB and on the
                    # other rates the CPU plain version would repeat the
                    # CUDA one checked above
                    if snr == 5.0 and ci in CPU_CODES and group != "sp":
                        worst[group] = max(worst[group], max_abs_diff(
                            decode_qc_cuda(code, cfg, cpu16.cuda()),
                            decode_qc_cuda_plain(code, cfg, cpu16)))
                    elif snr == 5.0 and ci in CPU_CODES:
                        sp_cpu_post = max(sp_cpu_post, sp_cpu_diff(
                            decode_qc_cuda(code, cfg, cpu16.cuda()),
                            decode_qc_cuda_plain(code, cfg, cpu16)))
                    n_cases += 1
                    if early_exit:
                        shown[name] = k
            # SCMS erases: its frames run otherwise than plain flooding's
            diff = int((shown["scms"].iterations
                        != shown["flooding alpha 1.0"].iterations).sum())
            erased += diff
            log(f"[phase3d] {code.name} snr={snr} tiles "
                + "/".join(str(tile_size(code, dev, 1000, m)) for m in (1, 5, 2))
                + f" (flooding/scms/sp) L={cuda_bp.lanes(code)} conv "
                + " ".join(f"{n.split()[0]}={shown[n].converged.float().mean().item():.3f}"
                           for n in ("flooding alpha 0.75", "scms", "sp flooding"))
                + f" scms!=flooding on {diff} frames: "
                f"{len(exits(snr == 5.0 and ci in CPU_CODES)) * len(A_MODES)} cases kernel "
                "== plain (cuda; cpu, "
                + ("sum-product within its tolerance)" if snr == 5.0 and ci in CPU_CODES
                   else "not compared)"))
    if erased == 0:
        raise AssertionError("SCMS never ran otherwise than plain flooding")
    log(f"[phase3d] {n_cases} cases bit-exact against the plain version on "
        "CUDA (posteriors of every frame included; sum-product too); against "
        "the CPU at 5 dB every min-sum case bit-exact, sum-product with equal "
        "bits and converged flags, iterations within 1 (largest posterior "
        f"difference {sp_cpu_post})")
    return worst, sp_cpu_post


def phase_route_b_vs_plain():
    """Phase 3e; returns the largest difference (0.0: any other raises),
    the route's main-path Decoder, its LLRs and its launches."""
    worst = 0.0
    n_cases = 0
    for ci, (z, bg) in enumerate(B_CODES):
        code = nr_code(z, bg)
        impl = Decoder(code, NR_CFG, device="cuda").implementation
        if impl != "cuda" or code.num_blocks <= 120:
            raise AssertionError(f"{code.name}: resolved to {impl}")
        for si, snr in enumerate(B_SNRS[bg]):
            llr_gpu = nr_numpy_llr(code, 101, snr, SEED + 500 + ci).cuda()
            llr_cpu = llr_gpu[:16].cpu()
            for early_exit in exits(si == 0):
                cfg = DecoderConfig(normalization=0.8, max_iters=30,
                                    early_exit=early_exit)
                k = decode_qc_cuda(code, cfg, llr_gpu)
                k16 = decode_qc_cuda(code, cfg, llr_cpu.cuda())
                torch.cuda.synchronize()
                worst = max(worst,
                            max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_gpu)),
                            max_abs_diff(k16, decode_qc_cuda_plain(code, cfg, llr_cpu)))
                n_cases += 1
                if early_exit:
                    shown = k
            log(f"[phase3e] {code.name} ({code.num_blocks} circulants) impl=cuda "
                f"{shape(code, 101)} snr={snr} "
                f"{summary(shown)}: kernel == plain (cpu, cuda)")
    log(f"[phase3e] {n_cases} cases bit-exact")
    code = nr_code(*B_MAIN)
    dec = Decoder(code, NR_CFG, device="cuda")
    u, llr = nr_card_llr(code, B_BATCH, (B_SNR,), SEED + 510)
    llr = llr[B_SNR]
    decode_qc_cuda.launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    launches = decode_qc_cuda.launches
    if launches < 1:
        raise AssertionError("kernel B's route launched no kernel")
    log(f"[phase3e] Decoder impl={dec.implementation} {code.name} batch={B_BATCH} "
        f"snr={B_SNR} {gates(dec, res, u)} launches={launches}")
    return worst, dec, llr, launches


def nr_card_llr(code, batch: int, snrs, seed: int):
    """NR codewords of random info bits encoded on the card, rate-matched
    rv0 over the full buffer, through BPSK/AWGN at each SNR and
    de-rate-matched: (info bits, {snr: [batch, n] LLRs})."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randint(0, 2, (batch, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    e = code.n - code.punctured_front  # rv0 over the full buffer
    tx = rate_match_bits(code, triangular_encode_fn(code)(u), e)
    llrs = {}
    for snr in snrs:
        llr_e, _ = transmit(gen, tx, snr)
        llrs[snr] = rate_match_llr(code, llr_e, e).contiguous()
    torch.cuda.synchronize()
    return u, llrs


def phase_main_path():
    code = wimax(576, "3/4B")
    dec = Decoder(code, BENCH_CFG, device="cuda")
    if dec.implementation != "cuda":
        raise AssertionError(f"main path resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u = torch.randint(0, 2, (BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr, _ = transmit(gen, Encoder(code, device="cuda")(u), SNR_DB)
    torch.cuda.synchronize()

    decode_qc_cuda.launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    decoder_launches = decode_qc_cuda.launches
    if decoder_launches < 2:
        raise AssertionError(f"expected a fast and a straggler launch, got "
                             f"{decoder_launches}")
    log(f"[phase4] Decoder impl={dec.implementation} batch={BATCH} "
        f"snr={SNR_DB} {gates(dec, res, u)} launches={decoder_launches}")
    plain = Decoder(code, BENCH_CFG, device="cuda", implementation="torch")
    max_abs_diff(res, plain(llr))
    log("[phase4] Decoder(cuda) == Decoder(torch) on the same LLRs")

    # the CLI `test` flow: Coder byte stream, TDMPCL on the card
    src = bytes((ord("a") + i % 26) for i in range(432_000))
    coder = Coder(432, 576, "3/4B", device="cuda")
    coder.for_encoder()
    coder.for_decoder(BATCH)
    prior = coder.encode(src)
    cw = unpack_bits_np(prior).reshape(-1, code.n)
    if code.syndrome(cw).any():
        raise AssertionError("encoded stream holds a non-codeword")
    post = coder.test(prior, 10 ** (-SNR_DB / 20), seed=SEED)
    decode_qc_cuda.launches = 0
    out, stats = coder.decode(post, len(src), "TDMPCL", return_stats=True)
    torch.cuda.synchronize()
    coder_launches = decode_qc_cuda.launches
    if coder_launches < 1:
        raise AssertionError("the Coder TDMPCL decode launched no kernel")
    cpu = Coder(432, 576, "3/4B", device="cpu")
    cpu.for_decoder(BATCH)
    out_cpu, stats_cpu = cpu.decode(post, len(src), "TDMP", return_stats=True)
    if not (np.array_equal(out, out_cpu)
            and np.array_equal(stats["converged"], stats_cpu["converged"])
            and np.array_equal(stats["iterations"], stats_cpu["iterations"])):
        raise AssertionError("Coder TDMPCL (cuda) differs from TDMP (cpu)")
    err = int(np.sum(np.frombuffer(src, np.uint8) != out))
    log(f"[phase4] Coder TDMPCL round trip: {len(src)} bytes, "
        f"{len(cw)} codewords, mean_iters={stats['mean_iters']:.3f}, "
        f"ErrNum={err}, launches={coder_launches}; equal to the CPU TDMP "
        "decode")
    return dec, llr, u, decoder_launches, coder_launches, (coder, src, post)


def gates(dec, res, u, syndrome=None) -> str:
    """bench.py's sanity gates on one decoded batch: convergence > 0.98,
    bit errors <= unconverged frames x k, and converged frames with a zero
    syndrome (``syndrome``: [B, n] NumPy bits -> [B, m], the code's own by
    default).  Returns the batch's summary."""
    code = dec.code
    syndrome = syndrome or code.syndrome
    conv = res.converged.float().mean().item()
    unconv = int((~res.converged).sum())
    berr = int((dec.info_bits(res) != u).sum())
    if not conv > 0.98:
        raise AssertionError(f"convergence {conv} <= 0.98")
    if berr > unconv * code.k_info:
        raise AssertionError(f"{berr} bit errors > {unconv} unconverged x k")
    bits = res.bits.cpu().numpy()
    if syndrome(bits[res.converged.cpu().numpy()]).any():
        raise AssertionError("a converged frame has a nonzero syndrome")
    return (f"conv={conv:.4f} mean_iters={res.iterations.float().mean().item():.3f} "
            f"total_iters={int(res.total_iters)} bit_errors={berr}")


def phase_flooding_main_path(llr, u, stream):
    """Phase 4d on phase 4's LLRs and byte stream; returns the Decoders by
    kernels-line group, their launches, and the Coder MSCL / SCMS
    launches."""
    code = wimax(576, "3/4B")
    decs, launches = {}, {}
    for group, cfg in MODE_CFGS.items():
        dec = Decoder(code, cfg, device="cuda")
        if dec.implementation != "cuda":
            raise AssertionError(f"{group} main path resolved to {dec.implementation}")
        decode_qc_cuda.launches = 0
        res = dec(llr)
        torch.cuda.synchronize()
        launches[group] = decode_qc_cuda.launches
        if launches[group] < 1:
            raise AssertionError(f"the {group} Decoder launched no kernel")
        max_abs_diff(res, Decoder(code, cfg, device="cuda", implementation="torch")(llr))
        decs[group] = dec
        log(f"[phase4d] Decoder {group} impl={dec.implementation} batch={BATCH} "
            f"snr={SNR_DB} {gates(dec, res, u)} launches={launches[group]}; "
            "== Decoder(torch)")
    coder, src, post = stream
    coder_launches = {}
    for de_type in ("MSCL", "SCMS"):
        decode_qc_cuda.launches = 0
        out, stats = coder.decode(post, len(src), de_type, return_stats=True)
        torch.cuda.synchronize()
        coder_launches[de_type] = decode_qc_cuda.launches
        if coder_launches[de_type] < 1:
            raise AssertionError(f"the Coder {de_type} decode launched no kernel")
        # the CPU decode of the stream's first CPU_FRAMES codewords (a frame
        # decodes alike in any batch; the CPU takes seconds per thousand)
        cpu = Coder(432, 576, "3/4B", device="cpu")
        cpu.for_decoder(BATCH)
        m, nbytes = CPU_FRAMES, CPU_FRAMES * code.k // 8
        out_cpu, stats_cpu = cpu.decode(post[:m * code.n], nbytes, de_type,
                                        return_stats=True)
        if not (np.array_equal(out[:nbytes], out_cpu)
                and np.array_equal(stats["converged"][:m], stats_cpu["converged"])
                and np.array_equal(stats["iterations"][:m], stats_cpu["iterations"])):
            raise AssertionError(f"Coder {de_type} (cuda) differs from the CPU decode")
        err = int(np.sum(np.frombuffer(src, np.uint8) != out))
        log(f"[phase4d] Coder {de_type} round trip: {len(src)} bytes, "
            f"mean_iters={stats['mean_iters']:.3f}, ErrNum={err}, "
            f"launches={coder_launches[de_type]}; its first {m} codewords "
            "equal to the CPU decode")
    waterfall_and_resume("phase4d", ["--family", "wimax", "--n", "576", "--rate", "1/2",
                                     "--snr=1.5,2.0", "--schedule", "flooding",
                                     "--self-correction"], decode_qc_cuda)
    return decs, launches, coder_launches


def phase_nr_main_path():
    code = nr_code(384, 1)
    dec = Decoder(code, NR_CFG, device="cuda")
    if dec.implementation != "cuda_long":
        raise AssertionError(f"NR main path resolved to {dec.implementation}")
    u, llrs = nr_card_llr(code, NR_BATCH, NR_SNRS, SEED + 4)

    decode_qc_long.launches = 0
    results = {snr: dec(llr) for snr, llr in llrs.items()}
    torch.cuda.synchronize()
    launches = decode_qc_long.launches
    if launches < 1:
        raise AssertionError("the NR Decoder launched no long-code kernel")
    for snr, res in results.items():
        log(f"[phase4b] Decoder impl={dec.implementation} {code.name} "
            f"batch={NR_BATCH} snr={snr} {gates(dec, res, u)}")
    log(f"[phase4b] launches={launches}")
    plain = Decoder(code, NR_CFG, device="cuda", implementation="torch")
    max_abs_diff(results[5.0], plain(llrs[5.0]))
    log("[phase4b] Decoder(cuda_long) == Decoder(torch) on the same LLRs at 5 dB")
    # a config neither kernel serves on a small-z code (soft output at 310
    # circulants: kernel B's route and kernel C refuse it) takes the torch
    # path on the card, where the reference takes jnp (phase 4u decodes
    # one); an explicit kernel there still raises
    small = nr_code(48, 1)
    small_soft = dataclasses.replace(NR_CFG, soft_output=True)
    impl = Decoder(small, small_soft, device="cuda").implementation
    if impl != "torch":
        raise AssertionError(f"Decoder({small.name}, soft_output) resolved to {impl}")
    for kernel in ("cuda", "cuda_long"):
        try:
            Decoder(small, small_soft, device="cuda", implementation=kernel)
        except ValueError:
            continue
        raise AssertionError(f"Decoder({small.name}, soft_output, {kernel}) did not raise")
    log(f"[phase4b] Decoder({small.name}, soft_output, device=cuda): impl={impl}; "
        "an explicit cuda or cuda_long raises")

    # soft output on the long code: kernel C's soft mode, equal to the
    # torch path, the posteriors of every frame included
    soft_cfg = dataclasses.replace(NR_CFG, soft_output=True)
    soft = Decoder(code, soft_cfg, device="cuda")
    if soft.implementation != "cuda_long":
        raise AssertionError(f"NR soft output resolved to {soft.implementation}")
    decode_qc_long.soft_launches = 0
    res = soft(llrs[5.0])
    torch.cuda.synchronize()
    if decode_qc_long.soft_launches != 1:
        raise AssertionError("the NR soft-output Decoder did not launch the soft mode")
    max_abs_diff(res, Decoder(code, soft_cfg, device="cuda", implementation="torch")(llrs[5.0]))
    log(f"[phase4b] Decoder({code.name}, soft_output, device=cuda) impl="
        f"{soft.implementation} at 5 dB {gates(soft, res, u)}; == Decoder(torch), "
        "posteriors included")
    # sum-product on the long code: kernel C's sum-product mode at 3-6 dB
    sp = Decoder(code, NR_SP_CFG, device="cuda")
    if sp.implementation != "cuda_long":
        raise AssertionError(f"NR sum-product resolved to {sp.implementation}")
    decode_qc_long.sp_launches = 0
    sp_results = {snr: sp(llr) for snr, llr in llrs.items()}
    torch.cuda.synchronize()
    sp_launches = decode_qc_long.sp_launches
    if sp_launches < 1:
        raise AssertionError("the NR sum-product Decoder launched no sum-product kernel")
    for snr, res in sp_results.items():
        log(f"[phase4b] Decoder sum-product impl={sp.implementation} {code.name} "
            f"batch={NR_BATCH} snr={snr} {gates(sp, res, u)}")
    max_abs_diff(sp_results[5.0], Decoder(code, NR_SP_CFG, device="cuda",
                                          implementation="torch")(llrs[5.0]))
    log(f"[phase4b] sum-product launches={sp_launches}; == Decoder(torch) at 5 dB")

    waterfall_and_resume("phase4b", ["--family", "nr", "--z", "384", "--bg", "1",
                                     "--snr=-2.5,-1.5", "--normalization", "0.8"],
                         decode_qc_long)
    return dec, llrs, launches, sp, sp_launches, soft, u


def waterfall_and_resume(tag: str, code_args: list, kernel,
                         counter: str = "launches") -> None:
    """The CLI ``waterfall`` on the card for its SNR points (batch 256, up
    to 512 frames, 30 iterations), then again from its checkpoint, which
    must run no new step and print the same lines.  ``kernel`` is the
    wrapper (``decode_qc_cuda`` or ``decode_qc_long``) whose launch count
    ``counter`` (shared-memory launches by default) the first run must
    raise."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.json")
        argv = ["waterfall", *code_args, "--batch", "256", "--target-errors",
                "20", "--max-frames", "512", "--max-iters", "30",
                "--checkpoint", ck, "--out", os.path.join(tmp, "wf.csv"),
                "--device", "cuda"]
        runs = []
        for _ in range(2):
            setattr(kernel, counter, 0)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli.main(argv) != 0:
                    raise AssertionError("waterfall exited non-zero")
            with open(ck) as f:
                steps = json.load(f)["steps_done"]
            runs.append((buf.getvalue().strip().splitlines(),
                         getattr(kernel, counter), steps))
        (lines, first_launches, steps), (lines2, resumed_launches, steps2) = runs
        for line in lines:
            log(f"[{tag}] waterfall {line}")
        if first_launches < 1:
            raise AssertionError("the waterfall launched no kernel")
        if resumed_launches != 0 or steps2 != steps or lines2 != lines:
            raise AssertionError(
                f"the resumed waterfall ran new steps ({resumed_launches} "
                f"launches, steps {steps} -> {steps2})")
        log(f"[{tag}] waterfall: {sum(steps)} steps, {first_launches} "
            f"launches ({counter}); rerun from its checkpoint: 0 new steps, "
            "same lines")


def phase_dvbs2_main_path():
    code = dvbs2(64800, "1/2")
    dec = Decoder(code, DVB_CFG, device="cuda")
    where = placement(code, torch.cuda.current_device())
    if dec.implementation != "cuda_long" or where != GLOBAL:
        raise AssertionError(f"DVB-S2 main path resolved to {dec.implementation} "
                             f"in placement {where}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    u = torch.randint(0, 2, (DVB_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    cw = ira_encode_fn(code)(u)
    if code.syndrome(cw[:64].cpu().numpy()).any():
        raise AssertionError("ira_encode_fn made a non-codeword")
    llrs = {snr: transmit(gen, cw, snr)[0].contiguous() for snr in DVB_SNRS}
    torch.cuda.synchronize()

    decode_qc_long.launches = 0
    decode_qc_long.global_launches = 0
    results = {snr: dec(llr) for snr, llr in llrs.items()}
    torch.cuda.synchronize()
    launches, shared = decode_qc_long.global_launches, decode_qc_long.launches
    if launches != len(llrs) or shared:
        raise AssertionError(f"the DVB-S2 Decoder launched the global mode "
                             f"{launches} times and the shared one {shared}")
    for snr, res in results.items():
        state = gates(dec, res, u) if snr == 1.4 else summary(res)
        log(f"[phase4c] Decoder impl={dec.implementation} (posterior in global "
            f"memory) {code.name} batch={DVB_BATCH} snr={snr} lazy {state}")
    log(f"[phase4c] launches={launches} (global mode)")
    for snr, llr in llrs.items():
        max_abs_diff(results[snr], decode_qc_long_plain(code, DVB_CFG, llr))
    log("[phase4c] Decoder(cuda_long) == the lazy plain version at 1.0 and 1.4 dB")
    # the lazy contract against the exact torch path: the same converged
    # frames and bits at a benign point, detection never earlier
    lazy = results[1.4]
    exact = Decoder(code, DVB_CFG, device="cuda", implementation="torch")(llrs[1.4])
    conv = lazy.converged
    if not (torch.equal(conv, exact.converged)
            and torch.equal(lazy.bits[conv], exact.bits[conv])):
        raise AssertionError("lazy and exact decodes differ at 1.4 dB")
    lag = (lazy.iterations - exact.iterations).float()
    if lag.min() < 0:
        raise AssertionError("a lazy decode latched before the exact one")
    log(f"[phase4c] lazy vs Decoder(torch) (exact syndrome) at 1.4 dB: same "
        f"converged frames and bits; lazy - exact iterations: mean "
        f"{lag.mean().item():.3f}, min {int(lag.min())}, max {int(lag.max())}")
    # soft output in the global placement: csrc/bp_stream.cu's soft mode,
    # equal to the lazy plain version
    soft_cfg = dataclasses.replace(DVB_CFG, soft_output=True)
    soft = Decoder(code, soft_cfg, device="cuda")
    decode_qc_long.global_launches = 0
    decode_qc_long.soft_launches = 0
    res = soft(llrs[1.4])
    torch.cuda.synchronize()
    soft_launches = decode_qc_long.soft_launches
    if soft.implementation != "cuda_long" or (
            decode_qc_long.global_launches, soft_launches) != (1, 1):
        raise AssertionError("the DVB-S2 soft-output Decoder did not launch the global "
                             "soft mode")
    max_abs_diff(res, decode_qc_long_plain(code, soft_cfg, llrs[1.4]))
    log(f"[phase4c] Decoder({code.name}, soft_output) impl={soft.implementation} "
        f"(global) at 1.4 dB {gates(soft, res, u)} launches={soft_launches}; == the "
        "lazy plain version, posteriors included")
    waterfall_and_resume("phase4c", ["--family", "dvbs2", "--n", "16200", "--rate",
                                     "1/2", "--snr=0.5,1.0", "--normalization", "0.85"],
                         decode_qc_long)
    return dec, llrs[1.4], launches, soft, soft_launches, u


def received(gen, cw, mod: Modulation, snr_db: float):
    """Codeword bits -> ``mod`` symbols -> complex AWGN with per-component
    sigma = 10^(-snr/20) (sim_step's convention): (y, n0 = 2 sigma^2)."""
    sigma = sigma_from_snr_db(snr_db).cuda()
    sym = modulate(cw, mod)
    noise = torch.randn(sym.shape + (2,), generator=gen, device="cuda")
    return sym + sigma * torch.complex(noise[..., 0], noise[..., 1]), 2 * sigma * sigma


def check_demap(y, n0, mod, llr):
    """The demap on the card against the same torch ops on the CPU for the
    first frames: equal to the tolerance of tests/test_torch_modulation.py
    (complex abs rounds per device); returns the largest difference."""
    cpu = demap_llr(y[:4].cpu(), n0.cpu(), mod)
    got = llr[:4].cpu()
    torch.testing.assert_close(got, cpu, rtol=1e-5, atol=1e-5)
    return float((got - cpu).abs().max())


def phase_3m_main_path():
    """Phase 4e: BASELINE 3m through the demapper and Decoder, then the
    CLI."""
    code = dvbs2(64800, M3_RATE)
    mod = make_modulation("16apsk", M3_RATE)
    dec = Decoder(code, DVB_CFG, device="cuda")
    where = placement(code, torch.cuda.current_device())
    if dec.implementation != "cuda_long" or where != GLOBAL:
        raise AssertionError(f"3m resolved to {dec.implementation} in placement {where}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    u = torch.randint(0, 2, (DVB_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    y, n0 = received(gen, ira_encode_fn(code)(u), mod, M3_SNR)
    decode_qc_long.launches = 0
    decode_qc_long.global_launches = 0
    llr = demap_llr(y, n0, mod)
    res = dec(llr)
    torch.cuda.synchronize()
    launches = decode_qc_long.global_launches
    if launches < 1 or decode_qc_long.launches:
        raise AssertionError("3m did not run in the global placement")
    d = check_demap(y, n0, mod, llr)
    log(f"[phase4e] 3m: {code.name} as {mod.name} (gamma 2.85) batch={DVB_BATCH} "
        f"snr={M3_SNR} max-log demap ({y.numel()} symbols; cuda vs cpu max diff "
        f"{d}) -> Decoder impl={dec.implementation} (global, lazy) "
        f"{gates(dec, res, u)} launches={launches}")
    waterfall_and_resume("phase4e", ["--family", "dvbs2", "--n", "64800", "--rate",
                                     M3_RATE, "--mod", "16apsk", f"--snr={M3_SNR}",
                                     "--normalization", "0.85"],
                         decode_qc_long, "global_launches")
    return dec, mod, y, n0, launches


def phase_4m_main_path():
    """Phase 4f: BASELINE 4m: NR rate-matched rv0 as 64QAM, demapped,
    de-rate-matched and decoded."""
    code = nr_code(384, 1)
    mod = make_modulation("64qam")
    dec = Decoder(code, NR_CFG, device="cuda")
    if dec.implementation != "cuda_long":
        raise AssertionError(f"4m resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    u = torch.randint(0, 2, (NR_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    e = code.n - code.punctured_front  # rv0 over the full buffer
    tx = rate_match_bits(code, triangular_encode_fn(code)(u), e)
    y, n0 = received(gen, tx, mod, M4_SNR)
    decode_qc_long.launches = 0
    llr_e = demap_llr(y, n0, mod)
    res = dec(rate_match_llr(code, llr_e, e).contiguous())
    torch.cuda.synchronize()
    launches = decode_qc_long.launches
    if launches < 1:
        raise AssertionError("4m launched no long-code kernel")
    d = check_demap(y, n0, mod, llr_e)
    log(f"[phase4f] 4m: {code.name} rv0 e={e} as {mod.name} batch={NR_BATCH} "
        f"snr={M4_SNR} separable max-log demap ({y.numel()} symbols; cuda vs cpu "
        f"max diff {d}) -> de-rate-match -> Decoder impl={dec.implementation} "
        f"(shared) {gates(dec, res, u)} launches={launches}")
    return dec, mod, y, n0, e, launches


def frame_errors(dec, res, u) -> int:
    return int((dec.info_bits(res) != u).any(dim=1).sum())


def phase_bicm_id():
    """Phase 4g: BICM-ID on kernel C's soft mode (DVB-S2 16200 r3/4, 16APSK)
    and on kernel A's (wimax 576 r1/2, natural 8PSK); each loop equal to the
    same loop on the plain version on CUDA; then the CLI."""
    code = dvbs2(16200, "3/4")
    mod = make_modulation("16apsk", "3/4")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    u = torch.randint(0, 2, (ID_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    y, n0 = received(gen, ira_encode_fn(code)(u), mod, ID_SNR)
    one_shot = make_bicm_id_receive(code, ID_CFG, mod, n_outer=0, device="cuda")
    rx = make_bicm_id_receive(code, ID_CFG, mod, n_outer=ID_OUTER, device="cuda")
    dec = Decoder(code, ID_CFG, device="cuda")
    if dec.implementation != "cuda_long":
        raise AssertionError(f"BICM-ID resolved to {dec.implementation}")
    res0 = one_shot(y, n0)
    for attr in ("launches", "soft_launches"):
        setattr(decode_qc_long, attr, 0)
    res = rx(y, n0)
    torch.cuda.synchronize()
    launches, soft = decode_qc_long.launches, decode_qc_long.soft_launches
    if soft != ID_OUTER or launches != ID_OUTER + 1:
        raise AssertionError(f"BICM-ID launched {launches} times, {soft} in the soft mode")
    fer0 = frame_errors(dec, res0, u) / ID_BATCH
    fer = frame_errors(dec, res, u) / ID_BATCH
    if not fer < fer0:
        raise AssertionError(f"BICM-ID FER {fer} not below one-shot {fer0}")
    plain = make_bicm_id_receive(code, dataclasses.replace(ID_CFG, implementation="torch"),
                                 mod, n_outer=ID_OUTER, device="cuda")
    max_abs_diff(res, plain(y, n0))
    log(f"[phase4g] BICM-ID {code.name} as {mod.name} batch={ID_BATCH} snr={ID_SNR}: "
        f"one-shot FER {fer0:.4f} conv {res0.converged.float().mean().item():.4f}; "
        f"{ID_OUTER} exchanges FER {fer:.4f} conv "
        f"{res.converged.float().mean().item():.4f}; launches={launches} "
        f"(soft mode {soft}); == the loop on the plain version (cuda)")
    # kernel A's soft mode: the short-code case, natural-label 8PSK
    short = wimax(576, "1/2")
    natural = Modulation("8psk_nat", np.exp(1j * (2 * np.pi * np.arange(8) / 8 + np.pi / 8)
                                            ).astype(np.complex64),
                         ((np.arange(8)[:, None] >> np.arange(3)) & 1).astype(np.uint8))
    us = torch.randint(0, 2, (ID_SHORT_BATCH, short.k), generator=gen, device="cuda",
                       dtype=torch.uint8)
    ys, n0s = received(gen, Encoder(short, device="cuda")(us), natural, ID_SHORT_SNR)
    sdec = Decoder(short, ID_SHORT_CFG, device="cuda")
    s0 = make_bicm_id_receive(short, ID_SHORT_CFG, natural, n_outer=0, device="cuda")(ys, n0s)
    decode_qc_cuda.soft_launches = 0
    s2 = make_bicm_id_receive(short, ID_SHORT_CFG, natural, n_outer=ID_OUTER,
                              device="cuda")(ys, n0s)
    torch.cuda.synchronize()
    short_soft = decode_qc_cuda.soft_launches
    if short_soft != ID_OUTER:
        raise AssertionError(f"kernel A's soft mode launched {short_soft} times")
    sf0, sf2 = (frame_errors(sdec, r, us) / ID_SHORT_BATCH for r in (s0, s2))
    if not sf2 <= sf0:
        raise AssertionError(f"short-code BICM-ID FER {sf2} above one-shot {sf0}")
    max_abs_diff(s2, make_bicm_id_receive(
        short, dataclasses.replace(ID_SHORT_CFG, implementation="torch"), natural,
        n_outer=ID_OUTER, device="cuda")(ys, n0s))
    log(f"[phase4g] BICM-ID {short.name} as natural 8PSK batch={ID_SHORT_BATCH} "
        f"snr={ID_SHORT_SNR}: one-shot FER {sf0:.4f}, {ID_OUTER} exchanges FER "
        f"{sf2:.4f}; kernel A soft launches={short_soft}; == the loop on the plain "
        "version (cuda)")
    waterfall_and_resume("phase4g", ["--family", "dvbs2", "--n", "16200", "--rate", "3/4",
                                     "--mod", "16apsk", "--id-outer", str(ID_OUTER),
                                     f"--snr={ID_SNR}", "--normalization", "0.85"],
                         decode_qc_long, "soft_launches")
    return rx, plain, y, n0, soft, fer0, fer, short_soft


def phase_bf16_modes_vs_plain() -> float:
    """Phase 3g: kernel A's other bf16 modes and kernel B's route in bf16
    against their plain versions on CUDA, bit-exact, posteriors included."""
    dev = torch.cuda.current_device()
    n_cases = 0
    code = wimax(576, "3/4B")
    tiles = {name: f"{tile_size(code, dev, 1000, m)}/{tile_size(code, dev, 1000, m, 2)}"
             for name, m in (("layered", 0), ("flooding", 1), ("scms", 5))}
    log(f"[phase3g] {code.name} batch=1000 codewords per block f32/bf16: {tiles}, "
        f"L={cuda_bp.lanes(code)}")
    for snr in (5.0, 2.0):
        llr = torch.from_numpy(numpy_llr(code, 1000, snr, SEED + 300)).cuda()
        for name, kw in BF16_A_MODES.items():
            cfg = DecoderConfig(max_iters=40, **BF16, **kw)
            decode_qc_cuda.bf16_launches = 0
            k = decode_qc_cuda(code, cfg, llr)
            torch.cuda.synchronize()
            if decode_qc_cuda.bf16_launches != 1:
                raise AssertionError(f"{name}: no bf16 launch")
            if cfg.soft_output and k.posteriors.dtype != torch.bfloat16:
                raise AssertionError(f"{name}: posteriors are {k.posteriors.dtype}")
            max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr))
            n_cases += 1
        log(f"[phase3g] {code.name} batch=1000 snr={snr} bf16 "
            f"{', '.join(BF16_A_MODES)}: bit-exact against the plain version (cuda)")
    b_code = nr_code(*B_MAIN)
    cfg = dataclasses.replace(NR_CFG, **BF16)
    for ci, snr in enumerate(B_SNRS[1]):
        llr = nr_numpy_llr(b_code, 101, snr, SEED + 301 + ci).cuda()
        decode_qc_cuda.bf16_launches = 0
        k = decode_qc_cuda(b_code, cfg, llr)
        torch.cuda.synchronize()
        if decode_qc_cuda.bf16_launches != 1:
            raise AssertionError("kernel B's route: no bf16 launch")
        max_abs_diff(k, decode_qc_cuda_plain(b_code, cfg, llr))
        n_cases += 1
        log(f"[phase3g] {b_code.name} (kernel B's route) bf16 snr={snr} {summary(k)}: "
            "bit-exact")
    log(f"[phase3g] {n_cases} cases bit-exact")
    return 0.0


def phase_bf16_semantics() -> None:
    """Phase 3h: at the reference's own bf16 points every frame converges
    and decodes the true info bits (tests/test_zlane.py:192-207,
    tests/test_bf16.py:26-42), through ``Decoder`` on the card."""
    code = dvbs2_ira_qc(16200, "8/9")
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, size=(16, code.k), dtype=np.uint8)
    c = ira_encode_numpy(code, u)
    sigma = 10 ** (-6.5 / 20)
    y = (1.0 - 2.0 * c.astype(np.float32)) + rng.normal(0, sigma, c.shape).astype(np.float32)
    cases = [(code, DecoderConfig(normalization=0.8, max_iters=25, **BF16),
              torch.from_numpy((2.0 * y / sigma**2).astype(np.float32)), u, "cuda_long")]
    code = wimax(576, "3/4B")
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(16, code.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(code), u)
    sigma = 10 ** (-5.5 / 20)
    y = (1.0 - 2.0 * c.astype(np.float32)) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    llr = torch.from_numpy((2.0 * y / sigma**2).astype(np.float32))
    for alg, alpha in (("min-sum", 0.75), ("sum-product", 1.0)):
        cases.append((code, DecoderConfig(algorithm=alg, normalization=alpha, **BF16),
                      llr, u, "cuda"))
    for code, cfg, llr, u, impl in cases:
        dec = Decoder(code, cfg, device="cuda")
        if dec.implementation != impl:
            raise AssertionError(f"{code.name} bf16 resolved to {dec.implementation}")
        res = dec(llr)
        if not bool(res.converged.all()):
            raise AssertionError(f"{code.name} bf16: a frame did not converge")
        if not np.array_equal(res.bits[:, :code.k].cpu().numpy(), u):
            raise AssertionError(f"{code.name} bf16: wrong info bits")
        log(f"[phase3h] {code.name} {cfg.algorithm} bf16 impl={dec.implementation}: "
            f"16 of 16 frames converged to the true info bits, iterations "
            f"{res.iterations.tolist()}")


def phase_bf16_main_paths(llr, u, nr_llrs, nr_u, dvb_llr, dvb_u):
    """Phase 4h: the main paths' Decoders in bf16 on their own LLRs: wimax
    576 r3/4B (kernel A, layered NMS and flooding sum-product), NR BG1
    Z=384 at 3-6 dB (kernel C, shared; sum-product and soft output at 5
    dB), DVB-S2 64800 r1/2 at 1.4 dB (kernel C in the placement its bf16
    fit picks, global, and forced into shared memory); each equal to its
    plain version on CUDA, bf16 posteriors included."""
    out = {"decs": {}, "launches": {}}
    code = wimax(576, "3/4B")
    for name, cfg in BF16_A_CFGS.items():
        dec = Decoder(code, cfg, device="cuda")
        if dec.implementation != "cuda":
            raise AssertionError(f"bf16 {name} resolved to {dec.implementation}")
        decode_qc_cuda.bf16_launches = 0
        res = dec(llr)
        torch.cuda.synchronize()
        out["launches"][f"a {name}"] = decode_qc_cuda.bf16_launches
        if decode_qc_cuda.bf16_launches < 1:
            raise AssertionError(f"the bf16 {name} Decoder launched no bf16 kernel")
        max_abs_diff(res, decode_qc_cuda_plain(code, cfg, llr))
        out["decs"][f"a {name}"] = dec
        log(f"[phase4h] Decoder {code.name} bf16 {name} impl={dec.implementation} "
            f"batch={BATCH} snr={SNR_DB} {gates(dec, res, u)} launches="
            f"{out['launches'][f'a {name}']}; == the plain version (cuda)")
    code = nr_code(384, 1)
    for name, cfg in BF16_NR_CFGS.items():
        dec = Decoder(code, cfg, device="cuda")
        if dec.implementation != "cuda_long" or placement(
                code, torch.cuda.current_device(), 2) != SHARED:
            raise AssertionError(f"NR bf16 {name} resolved to {dec.implementation}")
        llrs = nr_llrs if name == "min-sum" else {5.0: nr_llrs[5.0]}
        decode_qc_long.launches = 0
        decode_qc_long.bf16_launches = 0
        results = {snr: dec(x) for snr, x in llrs.items()}
        torch.cuda.synchronize()
        out["launches"][f"c {name}"] = decode_qc_long.bf16_launches
        if decode_qc_long.bf16_launches != len(llrs) or decode_qc_long.launches != len(llrs):
            raise AssertionError(f"NR bf16 {name}: launches {decode_qc_long.bf16_launches}")
        for snr, res in results.items():
            log(f"[phase4h] Decoder {code.name} bf16 {name} impl={dec.implementation} "
                f"(shared) batch={NR_BATCH} snr={snr} {gates(dec, res, nr_u)}")
        max_abs_diff(results[5.0], decode_qc_long_plain(code, cfg, nr_llrs[5.0]))
        out["decs"][f"c {name}"] = dec
        log(f"[phase4h] NR bf16 {name}: launches={out['launches'][f'c {name}']}; == the "
            "plain version (cuda) at 5 dB" + (", bf16 posteriors included"
                                             if cfg.soft_output else ""))
    code = dvbs2(64800, "1/2")
    where = placement(code, torch.cuda.current_device(), 2)
    if where != GLOBAL:
        raise AssertionError(f"bf16 DVB-S2 64800: placement {where}, not global")
    dec = Decoder(code, BF16_DVB_CFG, device="cuda")
    decode_qc_long.launches = 0
    decode_qc_long.global_launches = 0
    res = dec(dvb_llr)
    torch.cuda.synchronize()
    out["launches"]["c dvb"] = decode_qc_long.global_launches
    if (decode_qc_long.launches, decode_qc_long.global_launches) != (0, 1):
        raise AssertionError("the bf16 DVB-S2 Decoder did not launch the global mode")
    plain = decode_qc_long_plain(code, BF16_DVB_CFG, dvb_llr)
    max_abs_diff(res, plain)
    log(f"[phase4h] Decoder {code.name} bf16 impl={dec.implementation} (posterior in "
        f"global memory: {code.n * 2} B in shared memory would leave one block to an "
        f"SM) batch={DVB_BATCH} snr=1.4 lazy {gates(dec, res, dvb_u)}; == the lazy "
        "plain version (cuda)")
    decode_qc_long.launches = 0
    forced = decode_qc_long(code, BF16_DVB_CFG, dvb_llr, _place=SHARED)
    torch.cuda.synchronize()
    out["launches"]["c dvb shared"] = decode_qc_long.launches
    if decode_qc_long.launches != 1:
        raise AssertionError("the forced bf16 shared mode did not launch")
    max_abs_diff(forced, plain)
    log(f"[phase4h] {code.name} bf16 forced into shared memory {summary(forced)}; == the "
        "same plain version")
    out["decs"]["c dvb"] = dec
    return out


def phase_bf16_waterfall() -> dict:
    """Phase 4h (CLI): ``waterfall --msg-dtype bfloat16`` at one point of
    wimax 576 r1/2 layered min-sum beside the f32 point, the same seeds and
    frames."""
    fers = {}
    for dtype in ("float32", "bfloat16"):
        argv = ["waterfall", "--family", "wimax", "--n", "576", "--rate", "1/2",
                "--snr=1.5", "--batch", "4096", "--target-errors", "1000000",
                "--max-frames", "8192", "--max-iters", "30", "--msg-dtype", dtype,
                "--device", "cuda"]
        decode_qc_cuda.launches = 0
        decode_qc_cuda.bf16_launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli.main(argv) != 0:
                raise AssertionError("waterfall exited non-zero")
        line = buf.getvalue().strip().splitlines()[0]
        bf16_launches = decode_qc_cuda.bf16_launches
        if decode_qc_cuda.launches < 1 or (bf16_launches > 0) != (dtype == "bfloat16"):
            raise AssertionError(f"waterfall {dtype}: launches {decode_qc_cuda.launches}, "
                                 f"bf16 {bf16_launches}")
        fers[dtype] = float(line.split("FER=")[1].split()[0])
        log(f"[phase4h] waterfall --msg-dtype {dtype}: {line}")
    log(f"[phase4h] wimax 576 r1/2 layered MS at 1.5 dB, 8192 frames: FER f32 "
        f"{fers['float32']:.4e}, bf16 {fers['bfloat16']:.4e}")
    return fers


def acc_frames(enc, seed: int, snr: float, batch: int, k_msg: int, attach):
    """``k_msg`` message bits with their check attached (``attach``),
    encoded on the card, through BPSK/AWGN: (info bits, [batch, n] LLRs)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = attach(torch.randint(0, 2, (batch, k_msg), generator=gen, device="cuda",
                             dtype=torch.uint8))
    return u, transmit(gen, enc(u), snr)[0].contiguous()


def equal_accept(a, b) -> None:
    """The wrap's result equals the latch's: bits, converged, iterations
    and accepted."""
    for f in ("bits", "converged", "iterations", "accepted"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"the acceptance wrap and the latch differ in {f}")


def phase_acceptance() -> dict:
    """Phase 4i: BASELINE configs 1 and 1c through ``sim_step`` on kernel
    A's flooding sum-product mode (1c with CRC-16 and the acceptance wrap):
    config 1 shows undetected errors, 1c none and some CRC rejections; the
    wrap equals the torch path's in-loop latch on the card; the retry's
    share of the decode time."""
    code = regular(648)
    enc = Encoder(code, device="cuda")
    cfg1c = dataclasses.replace(ACC_CFG, crc="16")
    totals = {}
    for name, cfg in (("1", ACC_CFG), ("1c", cfg1c)):
        dec = Decoder(code, cfg, device="cuda")
        if dec.implementation != "cuda":
            raise AssertionError(f"config {name} resolved to {dec.implementation}")
        decode_qc_cuda.launches = 0
        stats = [sim_step(code, cfg, torch.Generator(device="cuda").manual_seed(
            SEED + 400 + i), ACC_SNR, ACC_BATCH, encode_fn=enc, decode_fn=dec)
            for i in range(ACC_STEPS)]
        torch.cuda.synchronize()
        tot = {f: sum(int(getattr(st, f)) for st in stats) for f in SimStats._fields}
        tot["launches"] = decode_qc_cuda.launches
        if tot["launches"] < ACC_STEPS:
            raise AssertionError(f"config {name}: {tot['launches']} kernel launches")
        totals[name] = tot
        log(f"[phase4i] config {name} ({code.name} k_info={code.k_info}, flooding SP, "
            f"{ACC_STEPS} x batch {ACC_BATCH}, {ACC_SNR} dB) impl={dec.implementation}: "
            + ", ".join(f"{k}={v}" for k, v in tot.items()))
        if name == "1c":
            dec1c = dec
    t1, t1c = totals["1"], totals["1c"]
    if not (t1["undetected_errors"] > 0 and t1["crc_rejected"] == 0):
        raise AssertionError("config 1 shows no undetected error")
    if not (t1c["undetected_errors"] == 0 and t1c["crc_rejected"] > 0
            and t1c["frame_errors"] >= t1c["crc_rejected"]):
        raise AssertionError("config 1c: the CRC missed a wrong codeword or caught none")
    # the wrap (kernel + ops/crc_accept.py) equals the torch path's latch
    latch = Decoder(code, cfg1c, device="cuda", implementation="torch")
    fail = accept_fail_fn(code, cfg1c)
    k_msg = code.k_info - CRC_POLYS["16"][0]
    attach = crc_attach_fn(k_msg, "16")
    rejected, worst = 0, None
    for i in range(ACC_STEPS):
        _, llr = acc_frames(enc, SEED + 500 + i, ACC_SNR, ACC_BATCH, k_msg, attach)
        equal_accept(dec1c(llr), latch(llr))
        k = decode_qc_cuda(code, ACC_CFG, llr)
        n_rej = int((k.converged & fail(k.bits)).sum())
        rejected += n_rej
        if worst is None or n_rej > worst[0]:
            worst = (n_rej, llr, k)
    log(f"[phase4i] config 1c: kernel + acceptance wrap == Decoder(torch)'s latch on "
        f"{ACC_STEPS} batches (bits, converged, iterations, accepted); the kernel "
        f"alone converged to {rejected} CRC-rejected codewords")
    # the retry's share of a batch's decode time, on the batch with the most
    # rejections
    n_rej, llr, k = worst
    bad = k.converged & fail(k.bits)
    cap = max(8, int(ACC_BATCH * cfg1c.triage_cap_frac))
    sel = torch.argsort((~bad).to(torch.uint8), stable=True)[:cap]
    retry_cfg = dataclasses.replace(cfg1c, implementation="torch")
    t = {"wrap": median_ms(lambda: dec1c(llr)),
         "kernel": median_ms(lambda: decode_qc_cuda(code, ACC_CFG, llr)),
         "retry": median_ms(lambda: decode_qc_cuda_plain(code, retry_cfg, llr[sel]))}
    t["share"] = (t["wrap"] - t["kernel"]) / t["wrap"]
    log(f"[phase4i] config 1c batch of {ACC_BATCH} with {n_rej} rejected frames: "
        f"kernel + wrap {t['wrap']:.4f} ms, kernel alone {t['kernel']:.4f} ms, the "
        f"retry of {cap} frames alone {t['retry']:.4f} ms; the acceptance's share "
        f"{t['share']:.3f}")
    return {"config1_undetected_errors": t1["undetected_errors"],
            "config1_frame_errors": t1["frame_errors"],
            "config1c_undetected_errors": t1c["undetected_errors"],
            "config1c_crc_rejected": t1c["crc_rejected"],
            "config1c_frame_errors": t1c["frame_errors"],
            "config1c_launches": t1c["launches"],
            "config1c_wrap_ms": t["wrap"], "config1c_kernel_ms": t["kernel"],
            "config1c_retry_ms": t["retry"], "config1c_retry_share": t["share"]}


def el_llr(code, batch: int, snr_db: float, seed: int) -> torch.Tensor:
    """[batch, n] float32 LLRs on the CPU of random codewords (the code's
    NumPy encoder: the oracle's own, else RU's) through BPSK/AWGN, noise
    from NumPy."""
    if not hasattr(code, "encode_numpy"):
        return torch.from_numpy(numpy_llr(code, batch, snr_db, seed))
    rng = np.random.default_rng(seed)
    c = code.encode_numpy(rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8))
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return torch.from_numpy((y * np.float32(2 / sigma**2)).astype(np.float32))


def phase_edgelist_vs_cpu() -> tuple[float, float]:
    """Phase 3k: the edge-list path on CUDA against the same function on
    the CPU.  Returns the largest difference of the held cases (0.0: any
    other raises) and sum-product's posterior difference against the CPU."""
    worst, n_cases = 0.0, 0
    for name, snrs in EL_CASES:
        code = dvbs2_oracle(16200, "1/2") if name == "oracle" else wimax(576, "3/4B")
        impl = "auto" if name == "oracle" else "edgelist"
        for si, snr in enumerate(snrs):
            llr = el_llr(code, EL_BATCH, snr, SEED + 300 + 2 * len(name) + si)
            for schedule in ("layered", "flooding"):
                for early_exit in exits(si == 0):
                    cfg = DecoderConfig(schedule=schedule, normalization=0.75,
                                        max_iters=EL_ITERS, early_exit=early_exit,
                                        soft_output=True, implementation=impl)
                    dec = Decoder(code, cfg, device="cuda")
                    if dec.implementation != "edgelist":
                        raise AssertionError(f"{code.name} resolved to {dec.implementation}")
                    res = dec(llr.cuda())
                    worst = max(worst, max_abs_diff(res, Decoder(code, cfg, device="cpu")(llr)))
                    n_cases += 1
                    log(f"[phase3k] {code.name} {schedule} snr={snr} early_exit={early_exit} "
                        f"{summary(res, EL_ITERS)}: cuda == cpu, posteriors included")
    code = dvbs2_oracle(16200, "1/2")
    llr = el_llr(code, EL_BATCH, EL_CASES[0][1][0], SEED + 320)
    sp = DecoderConfig(algorithm="sum-product", max_iters=EL_ITERS, soft_output=True)
    sp_post = sp_cpu_diff(Decoder(code, sp, device="cuda")(llr.cuda()),
                          Decoder(code, sp, device="cpu")(llr))
    log(f"[phase3k] {code.name} layered sum-product: cuda and cpu bits and converged "
        f"equal, iterations within 1; posteriors' max |diff| {sp_post:.4g}")
    bf16 = DecoderConfig(normalization=0.75, max_iters=EL_ITERS, soft_output=True,
                         msg_dtype="bfloat16")
    res = Decoder(code, bf16, device="cuda")(llr.cuda())
    worst = max(worst, max_abs_diff(res, Decoder(code, bf16, device="cpu")(llr)))
    if res.posteriors.dtype != torch.bfloat16:
        raise AssertionError("bf16 edge-list posteriors are not bf16")
    log(f"[phase3k] {code.name} layered bf16 {summary(res, EL_ITERS)}: cuda == cpu, posteriors "
        f"included; {n_cases + 2} cases")
    return worst, sp_post


def oracle_syndrome(oracle, qc):
    """[B, n] standard-order NumPy bits of ``oracle`` -> [B, m] syndrome,
    through ``qc``, the QC form of the same code, whose H is the oracle's
    under the row-residue and ``std_interleave`` permutations (the rows
    come out in the QC order)."""
    inv = np.argsort(std_interleave(oracle.n, oracle.k))
    return lambda bits: qc.syndrome(bits[:, inv])


def phase_oracle_main_path():
    """Phase 4n: BASELINE config 3's point on the standard-domain oracle
    through ``Decoder`` (auto: the edge list), with bench.py's gates; the
    same noisy frames, in the QC order, through dvbs2(64800, "1/2") on the
    global placement (csrc/bp_stream.cu): equal bits on every frame that
    both converge."""
    code = dvbs2_oracle(64800, "1/2")
    dec = Decoder(code, ORACLE_CFG, device="cuda")
    if dec.implementation != "edgelist":
        raise AssertionError(f"the oracle resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    u = torch.randint(0, 2, (DVB_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    cw = code.encode_fn()(u)
    qc = dvbs2(64800, "1/2")
    syndrome = oracle_syndrome(code, qc)
    if syndrome(cw[:64].cpu().numpy()).any():
        raise AssertionError("the oracle's encode_fn made a non-codeword")
    llr = transmit(gen, cw, ORACLE_SNR)[0].contiguous()
    torch.cuda.synchronize()
    res = dec(llr)
    torch.cuda.synchronize()
    log(f"[phase4n] Decoder impl={dec.implementation} {code.name} batch={DVB_BATCH} "
        f"snr={ORACLE_SNR} layered NMS 0.85 {gates(dec, res, u, syndrome)}")
    perm = torch.as_tensor(std_interleave(code.n, code.k), device="cuda")
    qc_dec = Decoder(qc, DVB_CFG, device="cuda")
    decode_qc_long.global_launches = 0
    qres = qc_dec(llr[:, torch.argsort(perm)].contiguous())
    torch.cuda.synchronize()
    if qc_dec.implementation != "cuda_long" or decode_qc_long.global_launches != 1:
        raise AssertionError("the QC form did not launch the global placement")
    both = res.converged & qres.converged
    if not torch.equal(res.bits[both], qres.bits[:, perm][both]):
        raise AssertionError("the oracle and bp_stream.cu differ on a frame both converged")
    counts = {"oracle_converged": int(res.converged.sum()),
              "qc_converged": int(qres.converged.sum()), "both_converged": int(both.sum())}
    log(f"[phase4n] the same frames through {qc.name} on bp_stream.cu (lazy): "
        f"converged {counts['qc_converged']} of {DVB_BATCH}, the oracle {counts['oracle_converged']}; "
        f"equal bits on the {counts['both_converged']} frames both converged")
    return dec, llr, counts


def tb_equal(a, b) -> None:
    for f in TB_FIELDS:
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"TBResult.{f} differs")


def tb_case(args, kw, seed, counter):
    """One transport format at TB_BATCH, TB_SNR: encode on the card, BPSK /
    AWGN, receive through the default decoder (a kernel) with the kernel's
    counter set to 0 just before, and through ``implementation="torch"``
    on CUDA; the two receives equal in every field, no accepted TB with a
    wrong payload.  Returns (transport, payload, llr, result, launches)."""
    fmt = plan_tb(*args, **kw)
    t = NRTransport(fmt, device="cuda")
    plain = NRTransport(fmt, device="cuda", decoder_config=DecoderConfig(
        normalization=0.75, implementation="torch"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    payload = torch.randint(0, 2, (TB_BATCH, fmt.a), generator=gen, device="cuda",
                            dtype=torch.int8)
    llr = transmit(gen, t.encode(payload), TB_SNR)[0].contiguous()
    torch.cuda.synchronize()
    counter.launches = 0
    res = t.receive(llr)
    torch.cuda.synchronize()
    launches = counter.launches
    if launches < 1:
        raise AssertionError(f"{fmt.describe()}: the receive launched no kernel")
    tb_equal(res, plain.receive(llr))
    wrong = res.tb_ok & (res.payload != payload.to(torch.uint8)).any(dim=-1)
    if wrong.any():
        raise AssertionError(f"{int(wrong.sum())} TBs accepted with a wrong payload")
    log(f"[phase4o] {fmt.describe()} impl={t.decoder.implementation} batch={TB_BATCH} "
        f"snr={TB_SNR}: tb_ok {int(res.tb_ok.sum())}, cb_ok {int(res.cb_ok.sum())} of "
        f"{res.cb_ok.numel()}, mean CB iterations {res.iterations.float().mean().item():.3f}, "
        f"launches={launches}; == the receive with implementation=\"torch\" in every "
        "field, no accepted TB with a wrong payload")
    return t, payload, llr, res, launches


def phase_transport():
    """Phase 4o: BASELINE config 4t on kernel C under the acceptance
    wrapper (CRC24B at span K'), and a small-Z block on kernel B's route."""
    t, payload, llr, res, launches = tb_case(*TB_ARGS, SEED + 8, decode_qc_long)
    if t.decoder.implementation != "cuda_long" or t.decoder.config.crc != "24B":
        raise AssertionError("config 4t is not on kernel C with CRC24B acceptance")
    small = tb_case(*TB_SMALL_ARGS, SEED + 9, decode_qc_cuda)[0]
    if small.decoder.implementation != "cuda" or small.fmt.z >= 64:
        raise AssertionError("the small-Z block is not on kernel B's route")
    return t, payload, llr, int(res.tb_ok.sum()), launches


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched that launch a device kernel (views
    and host scalars left out)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in NO_LAUNCH_OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the CUDA kernels it
    records (host-to-device copies among them, ``htod``) and the sum of
    their device times (ms), read from the profiler's raw events: building
    its event tree takes seconds at a hundred thousand kernels."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    return {"kernels": len(kernels), "htod": sum("HtoD" in e.name() for e in kernels),
            "kernel_ms": sum(e.duration_ns() for e in kernels) / 1e6}


def count_ops(fn) -> dict:
    """One call of ``fn``: the aten ops it dispatches that launch a device
    kernel (:class:`OpCount`) and, in another call, :func:`profile_call`'s
    counts."""
    with OpCount() as ops:
        fn()
    torch.cuda.synchronize()
    return {"ops": ops.n, **profile_call(fn)}


def phase_edgelist_times(dec, llr) -> dict:
    """The 64800 oracle's ``Decoder`` call (phase 4n's inputs): its time,
    the torch launches of one call per sweep, and the device's busy share
    (the profiled kernels' device time over the call's median time)."""
    res = dec(llr)
    sweeps = int(res.total_iters)
    ms = median_ms(lambda: dec(llr), 5)
    counts = count_ops(lambda: dec(llr))
    out = {"decoder_ms": ms, "sweeps": sweeps,
           "mean_iterations": res.iterations.float().mean().item(),
           "decoded_mbits": llr.shape[0] * dec.code.k_info / (ms * 1e-3) / 1e6,
           "torch_ops_per_sweep": counts["ops"] / sweeps,
           "cuda_kernels_per_sweep": counts["kernels"] / sweeps,
           "ms_per_sweep": ms / sweeps,
           "kernel_ms": counts["kernel_ms"], "busy_share": counts["kernel_ms"] / ms}
    log(f"[phase5] {dec.code.name} edge-list Decoder: {ms:.4f} ms per batch of "
        f"{llr.shape[0]} ({sweeps} sweeps, {out['ms_per_sweep']:.4f} ms a sweep) = "
        f"{out['decoded_mbits']:.1f} Mbit/s decoded info; {out['torch_ops_per_sweep']:.1f} "
        f"torch ops and {out['cuda_kernels_per_sweep']:.1f} CUDA kernels a sweep, their "
        f"device time {out['kernel_ms']:.4f} ms (busy share {out['busy_share']:.3f})")
    return out


def phase_transport_times(t, payload, llr) -> dict:
    """Config 4t: the receive alone, and encode + BPSK/AWGN + receive, as
    payload Mbit/s."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def chain():
        return t.receive(transmit(gen, t.encode(payload), TB_SNR)[0])

    out = {"receive_ms": median_ms(lambda: t.receive(llr), 5),
           "chain_ms": median_ms(chain, 5)}
    bits = payload.shape[0] * t.fmt.a
    for k in ("receive", "chain"):
        out[f"{k}_mbits"] = bits / (out[f"{k}_ms"] * 1e-3) / 1e6
    log(f"[phase5] config 4t ({t.fmt.describe()}, {payload.shape[0]} TBs): receive "
        f"{out['receive_ms']:.4f} ms = {out['receive_mbits']:.1f} Mbit/s payload; encode + "
        f"channel + receive {out['chain_ms']:.4f} ms = {out['chain_mbits']:.1f} Mbit/s")
    return out


def phase_legs() -> dict:
    """Phase 4j: the three legs of ``__graft_entry__.dryrun_multichip`` on one
    card through ``sim_step`` with the reference's configs (its 1-D mesh
    case: two SNR points): wimax 576 r1/2 with CRC-16 on kernel A, DVB-S2
    16200 r1/2 with post-decode outer BCH on kernel C, NR BG1 z=32
    rate-matched rv0 with CRC-16 on kernel B's route; then leg 2's code
    with the BCH in the decoder: kernel C + the wrap equals the latch."""
    legs = multichip_legs("cuda")
    out = {}
    for li, leg in enumerate(legs):
        name, impl = leg["name"], LEG_KERNELS[leg["name"]]
        kernel = decode_qc_long if impl == "cuda_long" else decode_qc_cuda
        if leg["decoder"].implementation != impl:
            raise AssertionError(f"leg {name} resolved to {leg['decoder'].implementation}")
        kernel.launches = 0
        snrs = leg["snr"]
        stats = [sim_step(leg["code"], leg["cfg"], torch.Generator(device="cuda").manual_seed(
            SEED + 600 + 10 * li + i), snr, leg["batch_per_device"],
            encode_fn=leg["encode_fn"], decode_fn=leg["decode_fn"], outer=leg["outer"])
            for i, snr in enumerate(snrs)]
        torch.cuda.synchronize()
        tot = {f: sum(int(getattr(st, f)) for st in stats) for f in SimStats._fields}
        tot["launches"] = kernel.launches
        if tot["frames"] != len(snrs) * leg["batch_per_device"] or tot["launches"] < len(snrs):
            raise AssertionError(f"leg {name}: {tot}")
        out[name] = tot
        log(f"[phase4j] leg[{name}] OK on one card: impl={impl} snr={list(snrs)} "
            + ", ".join(f"{k}={v}" for k, v in tot.items()))
    code2, outer2 = legs[1]["code"], legs[1]["outer"]
    _, m_f, t_f = outer2
    # leg 2 with the BCH in the decoder's acceptance: kernel C + wrap == latch,
    # on noisy true frames and forged ones (valid LDPC codewords whose BCH
    # field is broken), fewer and more than the wrap's cap of 8
    cfg2 = dataclasses.replace(legs[1]["cfg"], outer=outer2)
    wrap = Decoder(code2, cfg2, device="cuda")
    latch = Decoder(code2, cfg2, device="cuda", implementation="torch")
    k_msg = code2.k_info - bch_matrix(1, m_f, t_f).shape[1]
    attach = bch_attach_fn(k_msg, m_f, t_f)
    enc2 = legs[1]["encode_fn"]
    for n_forged in (6, 12):
        _, good = acc_frames(enc2, SEED + 700 + n_forged, 2.5, 24, k_msg, attach)
        u, _ = acc_frames(enc2, SEED + 710 + n_forged, 2.5, n_forged, k_msg, attach)
        u[:, 3] ^= 1  # a message bit: the BCH field no longer matches
        forged = (1.0 - 2.0 * enc2(u).to(torch.float32)) * 4.0
        llr = torch.cat([good, forged]).contiguous()
        decode_qc_long.launches = 0
        res = wrap(llr)
        torch.cuda.synchronize()
        if decode_qc_long.launches != 1 or bool(res.accepted[24:].any()):
            raise AssertionError("leg 2 wrap: a forged frame was accepted")
        equal_accept(res, latch(llr))
        log(f"[phase4j] leg dvbs2_16200_bch, BCH in the decoder: kernel C + wrap == "
            f"Decoder(torch)'s latch on 24 frames at 2.5 dB and {n_forged} forged ones "
            f"(accepted {int(res.accepted.sum())}, converged {int(res.converged.sum())})")
    return out


def c5_code(family: str):
    """Config 5's code of ``family`` and its encoder (the CLI's)."""
    if family == "nr_bg1_z64":
        code = nr_code(64, 1)
        return code, triangular_encode_fn(code)
    code = dvbs2(16200, "1/2")
    return code, ira_encode_fn(code)


def past_first_group(points) -> float:
    """Frames/s over a config-5 campaign's points after its first group
    (the first MP_SNR_SHARDS points, whose steps also carry each rank's
    first launches and first collective): ``points`` are (frames, wall_s)
    pairs."""
    later = points[MP_SNR_SHARDS:]
    return sum(f for f, _ in later) / sum(w for _, w in later)


def stats_fields(stats) -> dict:
    return {f: [int(x) for x in torch.as_tensor(getattr(stats, f)).reshape(-1).tolist()]
            for f in SimStats._fields}


def phase_nccl_world1() -> dict:
    """Phase 4p (a): ``make_sharded_campaign_step`` on a world-size-1 NCCL
    group on cuda:0, config 5's 8 points at the whole batch of 1024 on each
    family, equal to ``sim_step`` on position 0's generators in every
    field; then each family's campaign at world 1 as the CLI runs it
    (groups of 1 point, C5_BATCH frames a step, C5_TARGET / C5_MAX_FRAMES),
    its frames/s from the campaign's own wall times, and the step's
    collective (an all_reduce of [fields, 1] int64) timed alone."""
    world = pdist.init_process(0, 1, 0, 1, f"tcp://127.0.0.1:{pdist.free_port()}",
                               "nccl", "cuda")
    out = {"backend": world.backend}
    try:
        mesh = make_mesh()
        for family in C5_FAMILIES:
            code, enc = c5_code(family)
            dec = Decoder(code, C5_CFG, device="cuda")
            step = make_sharded_campaign_step(code, C5_CFG, mesh, C5_BATCH, len(C5_SNRS),
                                              encode_fn=enc, decode_fn=dec,
                                              device=world.device)
            decode_qc_long.launches = 0
            got = stats_fields(step(SEED, C5_SNRS))
            launches = decode_qc_long.launches
            want = {f: [] for f in SimStats._fields}
            for i, snr in enumerate(C5_SNRS):
                st = sim_step(code, C5_CFG, point_generator(SEED, 0, i, "cuda"), snr,
                              C5_BATCH, enc, dec)
                for f in SimStats._fields:
                    want[f].append(int(getattr(st, f)))
            if got != want or dec.implementation != "cuda_long" or launches < len(C5_SNRS):
                raise AssertionError(f"4p (a) {family}: step {got} != sim_step {want} "
                                     f"({dec.implementation}, {launches} launches)")
            log(f"[phase4p] (a) {family} NCCL world 1: step == sim_step on position 0's "
                f"generators, every field, {len(C5_SNRS)} points x {C5_BATCH} frames "
                f"(frame_errors {got['frame_errors']}, {launches} kernel C launches)")
            one = make_sharded_campaign_step(code, C5_CFG, mesh, C5_BATCH, 1,
                                             encode_fn=enc, decode_fn=dec,
                                             device=world.device)
            camp = WaterfallCampaign(
                CampaignConfig(snr_db=C5_SNRS, batch_per_step=C5_BATCH,
                               min_frame_errors=C5_TARGET, max_frames=C5_MAX_FRAMES,
                               seed=SEED),
                lambda seed, snr: SimStats(*(x.cpu().numpy() for x in one(seed, [snr]))),
                C5_BATCH)
            decode_qc_long.launches = 0
            camp.run()
            frames = sum(p.frames for p in camp.points)
            wall = sum(p.wall_s for p in camp.points)
            steady = past_first_group([(p.frames, p.wall_s) for p in camp.points])
            out[family] = {"frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
                           "steady_frames_per_s": steady,
                           "launches": decode_qc_long.launches,
                           "fer": [p.fer for p in camp.points]}
            log(f"[phase4p] (a) {family} campaign at world 1 (nccl): {frames} frames in "
                f"{wall:.3f} s = {frames / wall:.1f} frames/s ({steady:.1f} over the "
                f"points past the first group), {decode_qc_long.launches} kernel C launches")
        buf = torch.zeros((len(SimStats._fields), 1), dtype=torch.int64, device="cuda")
        out["collective_ms"] = median_ms(lambda: torch.distributed.all_reduce(buf), 20)
    finally:
        pdist.shutdown(world)
    return out


def phase_multichip_ranks(backend: str = "gloo") -> dict:
    """Phase 4p (b): ``dryrun_multichip(4)`` on ``spawn``'s 4 ranks of the one
    card (snr 2 x data 2, gloo, tensors on cuda:0): each rank's three legs
    on the kernel its ``Decoder`` resolves to (A, B's route, C), launched,
    and every rank's [4] stats equal to a recount in this process:
    ``sim_step`` on the seed rule's generator of every (position, point),
    summed over the data axis, every field."""
    t0 = time.time()
    reports = dryrun_multichip(MP_RANKS, backend=backend, device="cuda")
    spawn_s = time.time() - t0
    ready_s = max(r["ready_at"] for r in reports) - t0
    shape, axes, snr_axis, num_snr = multichip_mesh(MP_RANKS)
    sizes = dict(zip(axes, shape))
    out = {"spawn_s": spawn_s, "ready_s": ready_s,
           "collective_ms": [r["collective_ms"] for r in reports]}
    for li, leg in enumerate(multichip_legs("cuda")):
        snrs = leg_snrs(leg["snr"], num_snr)
        n_local = num_snr // sizes["snr"]
        want = {f: [0] * num_snr for f in SimStats._fields}
        for s in range(sizes["snr"]):
            for d in range(sizes["data"]):
                for i in range(n_local):
                    st = sim_step(leg["code"], leg["cfg"],
                                  point_generator(0, d * sizes["snr"] + s, i, "cuda"),
                                  snrs[s * n_local + i], leg["batch_per_device"],
                                  leg["encode_fn"], leg["decode_fn"], outer=leg["outer"])
                    for f in SimStats._fields:
                        want[f][s * n_local + i] += int(getattr(st, f))
        ranks = [r["legs"][li] for r in reports]
        for rank, got in enumerate(ranks):
            if got["name"] != leg["name"] or got["stats"] != want:
                raise AssertionError(f"4p (b) rank {rank} leg {leg['name']}: "
                                     f"{got['stats']} != recount {want}")
            if got["implementation"] != LEG_KERNELS[leg["name"]] or got["launches"] < 1:
                raise AssertionError(f"4p (b) rank {rank} leg {leg['name']} ran on "
                                     f"{got['implementation']}, {got['launches']} launches")
        out[leg["name"]] = {"launches": [g["launches"] for g in ranks],
                            "step_s": [g["step_s"] for g in ranks], "stats": want}
        log(f"[phase4p] (b) leg {leg['name']} on {MP_RANKS} {reports[0]['backend']} ranks "
            f"({ranks[0]['implementation']}, launches per rank "
            f"{[g['launches'] for g in ranks]}): every rank == the recount, every field "
            f"(frames {want['frames']}, frame_errors {want['frame_errors']})")
    return out


def torchrun_waterfall(family: str, tmp: str, backend: str = "gloo") -> dict:
    """Phase 4p (c): config 5's campaign of ``family`` through ``python -m
    torch.distributed.run --standalone --nproc-per-node 4 -m
    myldpccppapi_torch -- waterfall ... --snr-shards 2 --dist-backend
    gloo`` (the ``--`` keeps the launcher's parser off the command's
    options: it takes ``--n`` for an abbreviation of its own), then again
    from its checkpoint, which must do no new step (the same checkpoint
    and the same lines).  A rank that fails fails the run."""
    ck, report = os.path.join(tmp, f"{family}.ck.json"), os.path.join(tmp, f"{family}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MP_RANKS), "-m", "myldpccppapi_torch", "--", "waterfall",
           *C5_FAMILIES[family], "--snr", ",".join(map(str, C5_SNRS)),
           "--batch", str(C5_BATCH), "--normalization", str(C5_CFG.normalization),
           "--max-iters", str(C5_CFG.max_iters), "--target-errors", str(C5_TARGET),
           "--max-frames", str(C5_MAX_FRAMES), "--snr-shards", str(MP_SNR_SHARDS),
           "--dist-backend", backend, "--seed", str(SEED), "--checkpoint", ck,
           "--out", report]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=MP_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"4p (c) {family}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(ck) as f:
            state = json.load(f)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("snr=")]
        runs.append((lines, state, seconds))
    (lines, state, seconds), (lines2, state2, seconds2) = runs
    if len(lines) != len(C5_SNRS):
        raise AssertionError(f"4p (c) {family}: rank 0 printed {len(lines)} points")
    if lines2 != lines or state2 != state:
        raise AssertionError(f"4p (c) {family}: the resume ran new steps "
                             f"({state['steps_done']} -> {state2['steps_done']})")
    with open(report) as f:
        points = json.load(f)["points"]
    frames = sum(p["frames"] for p in points)
    wall = sum(p["wall_s"] for p in points)
    steady = past_first_group([(p["frames"], p["wall_s"]) for p in points])
    for line in lines:
        log(f"[phase4p] (c) {family} waterfall {line}")
    log(f"[phase4p] (c) {family}: {MP_RANKS} ranks (snr {MP_SNR_SHARDS} x data "
        f"{MP_RANKS // MP_SNR_SHARDS}, {backend}), {sum(state['steps_done'])} point-steps, "
        f"{frames} frames in {wall:.3f} s of steps = {frames / wall:.1f} frames/s "
        f"({steady:.1f} past the first group); the command {seconds:.1f} s; its "
        f"resume {seconds2:.1f} s, 0 new steps, same lines")
    return {"frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
            "steady_frames_per_s": steady, "command_s": seconds, "resume_s": seconds2,
            "lines": lines, "fer": [p["fer"] for p in points]}


def phase_multiprocess() -> dict:
    """Phase 4p: (a) NCCL at world 1, (b) the dry run's legs on 4 gloo ranks
    of the one card, (c) config 5 through the CLI under torch.distributed.run."""
    out = {"world1": phase_nccl_world1(), "ranks": phase_multichip_ranks()}
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = {family: torchrun_waterfall(family, tmp) for family in C5_FAMILIES}
    return out


def per_layer_alphas(code) -> tuple:
    return tuple(float(x) for x in np.round(np.linspace(0.65, 0.85, code.m_b), 3))


def hold_cases(tag, code, modes, snrs, max_iters, seed, counter) -> tuple:
    """Kernel A against its plain version on ``code`` in every mode of
    ``modes`` at each SNR of ``snrs`` (nearly every frame converges at the
    first, most run out at the second), early exit on, and off at the
    first: the kernel at batch 101 (a ragged tile) bit-exact against the
    plain version on CUDA; at the first SNR, early exit on, the f32 modes at
    batch 16 against the plain version on the CPU (sum-product to equal
    bits and converged flags, iterations within 1) where n <= 1024.
    ``counter`` names the launch counter each case must raise by one.
    Returns the largest difference (0.0: any other raises),
    sum-product's largest posterior difference against the CPU and the
    number of cases."""
    worst = 0.0
    sp_cpu = 0.0
    n_cases = 0
    for si, snr in enumerate(snrs):
        llr_cpu = torch.from_numpy(numpy_llr(code, 101, snr, seed + si))
        llr_gpu = llr_cpu.cuda()
        cpu16 = llr_cpu[:16].contiguous()
        shown = {}
        for name, kw in modes.items():
            if kw.get("normalization", 1.0) is None:
                kw = dict(kw, normalization=per_layer_alphas(code))
            for early_exit in exits(si == 0):
                cfg = DecoderConfig(max_iters=max_iters, early_exit=early_exit, **kw)
                before = getattr(decode_qc_cuda, counter)
                k = decode_qc_cuda(code, cfg, llr_gpu)
                if getattr(decode_qc_cuda, counter) != before + 1:
                    raise AssertionError(f"{tag} {name}: {counter} did not count the launch")
                worst = max(worst, max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_gpu)))
                if (si == 0 and early_exit and code.n <= 1024
                        and cfg.msg_dtype == "float32"):
                    k16 = decode_qc_cuda(code, cfg, cpu16.cuda())
                    p16 = decode_qc_cuda_plain(code, cfg, cpu16)
                    if cfg.algorithm == "sum-product":
                        sp_cpu = max(sp_cpu, sp_cpu_diff(k16, p16))
                    else:
                        max_abs_diff(k16, p16)
                n_cases += 1
                if early_exit:
                    shown[name] = k
        log(f"[{tag}] {code.name} snr={snr} tiles "
            + "/".join(str(tile_size(code, torch.cuda.current_device(), 101, m))
                       for m in (0, 1, 5))
            + f" (layered/flooding/scms) L={cuda_bp.lanes(code)} conv "
            + " ".join(f"{n.replace(' ', '_')}={r.converged.float().mean().item():.3f}"
                       for n, r in shown.items())
            + f": {len(exits(si == 0)) * len(modes)} cases kernel == plain (cuda"
            + ("; cpu, sum-product within its tolerance)" if si == 0 and code.n <= 1024
               else ")"))
    return worst, sp_cpu, n_cases


def phase_xor_vs_plain() -> tuple[float, float]:
    """Phase 3i: kernel A's xor group (RS-LDPC) in every mode against its
    plain version; returns the largest difference and sum-product's
    largest posterior difference against the CPU."""
    worst = sp_cpu = 0.0
    n_cases = 0
    for ci, (s_, gamma, rho, snrs) in enumerate(RS_CASES):
        code = rs_ldpc(s=s_, gamma=gamma, rho=rho)
        impl = Decoder(code, RS_CFG, device="cuda").implementation
        if impl != "cuda":
            raise AssertionError(f"{code.name}: resolved to {impl}")
        w, sp, n = hold_cases("phase3i", code, XOR_MODES, snrs, RS_CFG.max_iters,
                              SEED + 700 + 10 * ci, "xor_launches")
        worst, sp_cpu, n_cases = max(worst, w), max(sp_cpu, sp), n_cases + n
    log(f"[phase3i] {n_cases} cases bit-exact against the plain version on CUDA "
        "(posteriors included); against the CPU every f32 min-sum case "
        "bit-exact, sum-product with equal bits and converged flags, iterations "
        f"within 1 (largest posterior difference {sp_cpu})")
    return worst, sp_cpu


def multi_edge_codes() -> list:
    """Phase 3j's codes: wimax 576 r1/2 (z = 24) with extra circulants in
    the information columns of two layers, and with extra circulants in
    five of layer 2's seven columns, so that ten of its twelve circulants
    sit in multi-edge cells (the parity part untouched, so RU encodes)."""
    base = wimax(576, "1/2").base
    two = ((0, 1, (int(base[0, 1]) + 5) % 24), (1, 5, (int(base[1, 5]) + 7) % 24))
    most = tuple((2, j, (int(base[2, j]) + 3 + j) % 24) for j in (3, 4, 5, 7, 11))
    return [QCCode(name="wimax576r12_extra2", base=base, z=24, extra_blocks=two),
            QCCode(name="wimax576r12_extra_most", base=base, z=24, extra_blocks=most)]


def phase_multi_edge_vs_plain():
    """Phase 3j: kernel A's multi-edge cells in every mode against its
    plain version; then ``Decoder`` on the code with the most cells at
    batch 1000, 5 dB (the entry's shape).  Returns the largest difference,
    that Decoder, its LLRs and its launches."""
    worst = 0.0
    n_cases = 0
    codes = multi_edge_codes()
    for ci, code in enumerate(codes):
        impl = Decoder(code, ME_CFG, device="cuda").implementation
        if impl != "cuda" or cuda_bp.group_slots(code) == 0:
            raise AssertionError(f"{code.name}: resolved to {impl}")
        w, _, n = hold_cases("phase3j", code, ME_MODES, ME_SNRS, ME_CFG.max_iters,
                             SEED + 750 + 10 * ci, "multi_edge_launches")
        worst, n_cases = max(worst, w), n_cases + n
    log(f"[phase3j] {n_cases} cases bit-exact against the plain version on CUDA "
        "(posteriors included); the f32 min-sum cases against the CPU too")
    code = codes[-1]
    dec = Decoder(code, ME_CFG, device="cuda")
    llr = torch.from_numpy(numpy_llr(code, ME_BATCH, 5.0, SEED + 790)).cuda()
    decode_qc_cuda.launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    launches = decode_qc_cuda.launches
    if launches < 1 or decode_qc_cuda.multi_edge_launches < 1:
        raise AssertionError("the multi-edge Decoder launched no kernel")
    max_abs_diff(res, decode_qc_cuda_plain(code, ME_CFG, llr))
    log(f"[phase3j] Decoder impl={dec.implementation} {code.name} "
        f"({cuda_bp.group_slots(code)} delta-table rows) batch={ME_BATCH} snr=5.0 "
        f"{summary(res)} launches={launches}; == plain (cuda)")
    return worst, dec, llr, launches


def stream_round_trip(tag, coder, n_codewords: int, snr_db: float) -> tuple[int, dict]:
    """``coder``'s byte stream through encode, ``test`` at ``snr_db`` and a
    TDMPCL decode on the card: the decoded bytes must equal the source.
    Returns the decode's kernel launches and its stats."""
    src, prior, post = codec_stream(coder, n_codewords, snr_db)
    cw = unpack_bits_np(prior).reshape(-1, coder.code.n)
    if coder.code.syndrome(cw).any():
        raise AssertionError(f"{tag}: the encoded stream holds a non-codeword")
    decode_qc_cuda.launches = 0
    out, stats = coder.decode(post, len(src), "TDMPCL", return_stats=True)
    torch.cuda.synchronize()
    launches = decode_qc_cuda.launches
    if launches < 1:
        raise AssertionError(f"{tag}: the Coder TDMPCL decode launched no kernel")
    if bytes(out) != src:
        raise AssertionError(f"{tag}: the decoded bytes differ from the source")
    log(f"[phase4k] {tag}: {len(src)} bytes, {len(cw)} codewords at {snr_db} dB, "
        f"mean_iters={stats['mean_iters']:.3f}, launches={launches}: the decoded "
        "bytes equal the source")
    return launches, stats


def phase_rs_main_path():
    """Phase 4k: the RS-LDPC main path through ``Decoder`` and the byte
    stream through ``make_codec``; returns the Decoder, its LLRs, its
    launches and the Coder's."""
    code = rs_ldpc()
    dec = Decoder(code, RS_CFG, device="cuda")
    if dec.implementation != "cuda":
        raise AssertionError(f"RS-LDPC main path resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 800)
    u = torch.randint(0, 2, (RS_BATCH, code.k_info), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr, _ = transmit(gen, Encoder(code, device="cuda")(u), RS_SNR)
    llr = llr.contiguous()
    torch.cuda.synchronize()
    decode_qc_cuda.launches = 0
    decode_qc_cuda.xor_launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    launches = decode_qc_cuda.launches
    if launches < 1 or decode_qc_cuda.xor_launches != launches:
        raise AssertionError(f"RS-LDPC Decoder: {launches} launches, "
                             f"{decode_qc_cuda.xor_launches} in the xor group")
    log(f"[phase4k] Decoder impl={dec.implementation} {code.name} (n={code.n}, "
        f"k={code.k_info}) {shape(code, RS_BATCH)} "
        f"batch={RS_BATCH} snr={RS_SNR} {gates(dec, res, u)} launches={launches}")
    max_abs_diff(res, decode_qc_cuda_plain(code, RS_CFG, llr))
    log("[phase4k] Decoder(cuda) == the plain version on the same LLRs (cuda)")
    coder_launches, _ = stream_round_trip(
        "make_codec('rs_ldpc') TDMPCL", make_codec("rs_ldpc", device="cuda"),
        RS_STREAM_CODEWORDS, RS_STREAM_SNR)
    crc_coder = make_codec("wimax", 576, "1/2", crc="16", device="cuda")
    crc_launches, stats = stream_round_trip(
        "make_codec('wimax', 576, '1/2', crc='16') TDMPCL", crc_coder, 2048, SNR_DB)
    if not stats["accepted"].all() or stats["crc_rejected"]:
        raise AssertionError("the CRC-16 stream: a frame was not accepted")
    return dec, llr, launches, coder_launches, crc_launches


def phase_wifi_main_path():
    """Phase 4l: BASELINE config 2 through make_codec("wifi", 1944, "5/6")'s
    code on kernel A's cyclic layered mode; returns the Decoder, its LLRs
    and its launches."""
    code = make_codec("wifi", 1944, "5/6", device="cuda").code
    dec = Decoder(code, WIFI_CFG, device="cuda")
    if dec.implementation != "cuda":
        raise AssertionError(f"config 2 resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 900)
    u = torch.randint(0, 2, (WIFI_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr, _ = transmit(gen, Encoder(code, device="cuda")(u), WIFI_SNR)
    llr = llr.contiguous()
    torch.cuda.synchronize()
    decode_qc_cuda.launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    launches = decode_qc_cuda.launches
    if launches < 1:
        raise AssertionError("config 2 launched no kernel")
    log(f"[phase4l] Decoder impl={dec.implementation} {code.name} batch={WIFI_BATCH} "
        f"snr={WIFI_SNR} {gates(dec, res, u)} launches={launches}")
    return dec, llr, launches


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def phase_op_rate() -> dict:
    """Phase 6: kernel E (csrc/op_rate.cu) against its plain version on
    CUDA at a small depth, every body bit-exact but mufu (within
    MUFU_ATOL); then the calibrated f32 instruction and special-function
    result rates (into RATES, for bound()), each no higher than the card's
    issue ceiling plus RATE_SLACK; then the kernel's and the plain
    version's times at E_DEPTH (fma4).  Returns E's record."""
    dev = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1000)
    x = torch.randn(n_elements(dev), generator=gen, device="cuda")
    mufu_err = 0.0
    for body in BODIES:
        k = op_rate(x, body, E_CHECK_DEPTH)
        p = op_rate_plain(x, body, E_CHECK_DEPTH)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        if body == "mufu":
            mufu_err = err
            if not err <= MUFU_ATOL:
                raise AssertionError(f"op_rate mufu: kernel != plain (max abs {err} "
                                     f"> {MUFU_ATOL})")
        elif not torch.equal(k, p):
            raise AssertionError(f"op_rate {body}: kernel != plain (max abs {err})")
    log(f"[phase6] op_rate: {len(BODIES)} bodies x {x.numel()} elements x "
        f"{E_CHECK_DEPTH} iterations: kernel == plain (cuda), bit-exact but mufu "
        f"(max abs {mufu_err:.3e}, tolerance {MUFU_ATOL})")
    op_rate.launches = 0
    rates = calibrate(device="cuda", seed=SEED)
    torch.cuda.synchronize()
    launches = op_rate.launches
    if launches < 1:
        raise AssertionError("the calibration launched no kernel")
    for name, r in rates["bodies"].items():
        log(f"[phase6] {name}: {r['rate']:.6e} per s ({r['lo']} -> {r['hi']} "
            f"iterations: {r['t_lo_ms']:.4f} -> {r['t_hi_ms']:.4f} ms)")
    clock = max_sm_clock_hz()
    ceiling = ceilings(dev, clock)
    for key, name in (("f32_ops_per_s", "f32"), ("sfu_per_s", "mufu")):
        if rates[key] > ceiling[name] * (1 + RATE_SLACK):
            raise AssertionError(f"calibrated {key} {rates[key]:.4e} exceeds the "
                                 f"card's issue ceiling {ceiling[name]:.4e} by more "
                                 f"than {RATE_SLACK:.0%}: the loop was optimised away")
    RATES["f32"] = rates["f32_ops_per_s"]
    RATES["sfu"] = rates["sfu_per_s"]
    log(f"[phase6] calibrated: f32 {RATES['f32']:.6e} instructions/s (fma4), special "
        f"functions {RATES['sfu']:.6e} results/s (mufu), the decoders' phi "
        f"{rates['phi_per_s']:.6e} results/s (sfu); issue ceilings at "
        f"{clock / 1e6:.0f} MHz: f32 {ceiling['f32']:.6e}, special functions "
        f"{ceiling['mufu']:.6e}; the data sheet's: f32 {PEAK_F32_PER_S:.6e} (a "
        f"multiply-add as two), special functions {PEAK_SFU_PER_S:.6e}; "
        f"launches={launches}")
    ms = median_ms(lambda: op_rate(x, "fma4", E_DEPTH))
    plain_ms = median_ms(lambda: op_rate_plain(x, "fma4", E_DEPTH), 1)
    # fma4's operations are FP32 instructions (a mul and an add, kept apart)
    t_ops = BODIES["fma4"][1] * E_DEPTH * x.numel() / ceiling["f32"]
    t_bytes = 2 * 4 * x.numel() / PEAK_BYTES_PER_S
    log(f"[phase6] op_rate fma4 at {E_DEPTH} iterations: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {1e3 * max(t_ops, t_bytes):.4f} ms at the f32 "
        f"issue ceiling")
    return {"name": "op_rate", "route": "cuda",
            "source": "myldpccppapi_torch/csrc/op_rate.cu",
            "replaces": "benchmarks/roofline.py:123", "launches": launches,
            # mufu's: every other body is bit-exact
            "max_abs_err": mufu_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # no single PyTorch call computes E's loop
            "library_ms": None,
            "f32_ops_per_s": RATES["f32"], "sfu_per_s": RATES["sfu"],
            "phi_per_s": rates["phi_per_s"], "sm_clock_hz": clock,
            "f32_issue_ceiling": ceiling["f32"], "sfu_issue_ceiling": ceiling["mufu"],
            "f32_ops_per_s_datasheet": PEAK_F32_PER_S,
            "sfu_per_s_datasheet": PEAK_SFU_PER_S,
            "body_rates": {n: r["rate"] for n, r in rates["bodies"].items()}}


def bound(code, cfg, llr, res) -> tuple[float, str]:
    """The least time the card could take for one decode of ``llr``: the
    largest of its bytes (each LLR read once, each output -- bits,
    converged, iterations and, with soft output, posteriors -- written
    once) over the HBM rate, its f32 operations (OPS_PER_EDGE_SWEEP of the
    config's mode per Tanner-graph edge and sweep, over the sweeps this
    run's frames ran: ``iterations`` each with early exit, else every sweep)
    over the f32 rate, and, for sum-product, its special-function results
    over the SFU rate.  The rates are phase 6's calibrated ones (RATES).
    bf16 messages do the same operations
    on the same f32 LLRs and write their posteriors at 2 B.  Returns (ms,
    "bytes" or "operations")."""
    batch = llr.shape[0]
    item = 2 if cfg.msg_dtype == "bfloat16" else 4  # the posterior output's
    nbytes = batch * code.n * (4 + 1) + batch * (1 + 4)
    if cfg.soft_output:
        nbytes += batch * code.n * item
    sweeps = (int(res.iterations.sum()) if cfg.early_exit
              else batch * cfg.max_iters)
    if cfg.self_correction:
        key = "scms"
    else:
        key = cfg.schedule
        if cfg.algorithm == "sum-product":
            key = f"sp {cfg.schedule}"
    edge_sweeps = sweeps * code.num_edges
    t_ops = edge_sweeps * OPS_PER_EDGE_SWEEP[key] / RATES["f32"]
    if cfg.algorithm == "sum-product":
        t_ops = max(t_ops, edge_sweeps * OPS_SFU_PER_EDGE_SWEEP / RATES["sfu"])
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def streamed_floor(code, cfg, llr, res) -> dict:
    """The global placement's own floor: the device-memory bytes its design
    streams for this decode (the stage plan's P columns and R records of
    every sweep each codeword ran, ``cuda_stream.stream_bytes``; the LLRs
    read and copied into the P scratch; the outputs written) over the HBM
    rate.  ``bound`` counts the state as on chip; this counts it as the
    kernel keeps it."""
    item = msg_dtype(cfg).itemsize
    per_sweep = sum(cuda_stream.stream_bytes(code, item, cfg.algorithm == "sum-product").values())
    batch = llr.shape[0]
    sweeps = int(res.iterations.sum()) if cfg.early_exit else batch * cfg.max_iters
    nbytes = (sweeps * per_sweep + batch * code.n * (4 + item + 1) + batch * (1 + 4)
              + (batch * code.n * item if cfg.soft_output else 0))
    return {"streamed_floor": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "bytes_per_codeword_sweep": per_sweep,
            "blocks_per_sm": blocks_per_sm(code, cfg, GLOBAL)}


def median_ms(fn, reps: int = 7, warm: bool = True) -> float:
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_times(dec, llr, kernel, plain, cfg, plain_reps: int = 7, tag: str = ""):
    code = dec.code
    out = {
        "kernel": median_ms(lambda: kernel(code, cfg, llr)),
        "plain": median_ms(lambda: plain(code, cfg, llr), plain_reps),
        "decoder": median_ms(lambda: dec(llr)),
    }
    res = kernel(code, cfg, llr)
    out["bound"], out["bound_by"] = bound(code, cfg, llr, res)
    if kernel is decode_qc_long and placement(
            code, torch.cuda.current_device(), msg_dtype(cfg).itemsize) == GLOBAL:
        out.update(streamed_floor(code, cfg, llr, res))
        log(f"[phase5] {code.name}{tag} streamed floor: {out['streamed_floor']:.4f} ms "
            f"({out['bytes_per_codeword_sweep']} B per codeword and sweep, "
            f"{out['blocks_per_sm']} blocks to an SM)")
    for name in ("kernel", "plain", "decoder", "bound"):
        ms = out[name]
        mbits = llr.shape[0] * code.k_info / (ms * 1e-3) / 1e6
        log(f"[phase5] {code.name}{tag} {name}: {ms:.4f} ms per batch of "
            f"{llr.shape[0]} = {mbits:.1f} Mbit/s decoded info"
            + (f" (bound by {out['bound_by']})" if name == "bound" else ""))
    return out


def triage_times(dec, llr) -> dict:
    """The main path's ``Decoder`` call (two-phase triage) split into its
    two kernel launches: the fast pass over the batch, and the straggler
    pass over the cap of frames with those that failed the fast pass
    first, each at the tile the wrapper picks for its batch."""
    code, cfg = dec.code, dec.config
    single = dataclasses.replace(cfg, triage_iters=0)
    fast = dataclasses.replace(single, max_iters=cfg.triage_iters)
    bad = ~decode_qc_cuda(code, fast, llr).ok
    cap = max(8, int(llr.shape[0] * cfg.triage_cap_frac))
    sel = llr[torch.argsort((~bad).to(torch.uint8), stable=True)[:cap]].contiguous()
    out = {"fast": median_ms(lambda: decode_qc_cuda(code, fast, llr)),
           "straggler": median_ms(lambda: decode_qc_cuda(code, single, sel)),
           "failures": int(bad.sum()), "cap": cap}
    log(f"[phase5] {code.name} Decoder passes: fast ({cfg.triage_iters} sweeps, "
        f"batch {llr.shape[0]}, {shape(code, llr.shape[0])}) {out['fast']:.4f} ms; "
        f"straggler ({out['failures']} failed the fast pass, batch {cap}, "
        f"{shape(code, cap)}) {out['straggler']:.4f} ms")
    return out


def receive_times(tag, dec, mod, y, n0, derate):
    """A receive path's times: the demap alone, the decode (kernel, plain
    version, Decoder, bound) of its LLRs, and demap + decode together."""
    demap_ms = median_ms(lambda: demap_llr(y, n0, mod))
    llr = derate(demap_llr(y, n0, mod))
    out = phase_times(dec, llr, decode_qc_long, decode_qc_long_plain, dec.config,
                      plain_reps=1, tag=tag)
    out["demap"] = demap_ms
    out["receive"] = median_ms(lambda: dec(derate(demap_llr(y, n0, mod))))
    log(f"[phase5] {dec.code.name}{tag} demap ({mod.name}, {y.numel()} symbols): "
        f"{demap_ms:.4f} ms; demap + decode: {out['receive']:.4f} ms")
    return out


def long_sweep_fields(code, cfg, llr) -> dict:
    """Kernel C's (bp_long.cu) lone block per sweep on the first codeword of
    ``llr`` (early exit off: 30 sweeps against 1, CUDA events).  The log
    line adds the scratch layout's R bytes per codeword, which a sweep past
    the first reads and writes (min-sum records, or sum-product's per-edge
    messages); they are the library's layout, not a measurement."""
    x = llr[:1].contiguous()
    no_exit = dataclasses.replace(cfg, early_exit=False)
    full = median_ms(lambda: decode_qc_long(code, no_exit, x))
    one = median_ms(lambda: decode_qc_long(code, dataclasses.replace(no_exit, max_iters=1), x))
    out = {"lone_sweep_us": 1e3 * (full - one) / (no_exit.max_iters - 1)}
    layout = scratch_bytes(code, cfg.algorithm == "sum-product", msg_dtype(cfg).itemsize)
    log(f"[phase5] {code.name} {cfg.algorithm} {cfg.msg_dtype}"
        f"{' soft' if cfg.soft_output else ''}: lone block {out['lone_sweep_us']:.2f} us per "
        f"sweep; R scratch layout {layout} B per codeword")
    return out


def phase_dvbs2_times(dvb_dec, dvb_llr):
    """The DVB-S2 64800 main path in lazy and exact mode; then the kernel
    on dvbs2(16200, "1/2") at the same batch, posterior in shared and in
    global memory."""
    times = {}
    for mode in ("lazy", "exact"):
        cfg = dataclasses.replace(DVB_CFG, syndrome_mode=mode)
        dec = dvb_dec if mode == "lazy" else Decoder(dvb_dec.code, cfg, device="cuda")
        times[mode] = phase_times(dec, dvb_llr, decode_qc_long,
                                  decode_qc_long_plain, cfg, plain_reps=1,
                                  tag=f" {mode}")
    code = dvbs2(16200, "1/2")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    u = torch.randint(0, 2, (DVB_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr = transmit(gen, ira_encode_fn(code)(u), 1.5)[0].contiguous()
    for force in (False, True):
        ms = median_ms(lambda: decode_qc_long(code, DVB_CFG, llr, _place=GLOBAL if force else 0))
        res = decode_qc_long(code, DVB_CFG, llr, _place=GLOBAL if force else 0)
        log(f"[phase5] {code.name} lazy kernel, posterior in "
            f"{'global' if force else 'shared'} memory: {ms:.4f} ms per batch of "
            f"{DVB_BATCH} at 1.5 dB ({summary(res)}, mean iterations "
            f"{res.iterations.float().mean().item():.3f})")
    return times


def phase_bf16_times(decs, llr, nr_llr, dvb_llr) -> dict:
    """Phase 5 for bf16: each bf16 main path's kernel, plain version and
    Decoder (one timed repeat of the plain versions after a warm-up), the
    other modes' kernels, and DVB-S2 64800 in both placements."""
    wim, nr, dvb = wimax(576, "3/4B"), nr_code(384, 1), dvbs2(64800, "1/2")
    out = {
        "a": phase_times(decs["a layered"], llr, decode_qc_cuda, decode_qc_cuda_plain,
                         BF16_A_CFGS["layered"], plain_reps=1, tag=" bf16"),
        "a sp flooding": median_ms(lambda: decode_qc_cuda(
            wim, BF16_A_CFGS["sp flooding"], llr)),
        "nr": phase_times(decs["c min-sum"], nr_llr, decode_qc_long,
                          decode_qc_long_plain, BF16_NR_CFGS["min-sum"], plain_reps=1,
                          tag=" bf16"),
        "nr sp": median_ms(lambda: decode_qc_long(nr, BF16_NR_CFGS["sum-product"], nr_llr)),
        "nr soft": median_ms(lambda: decode_qc_long(nr, BF16_NR_CFGS["soft"], nr_llr)),
        "dvb": phase_times(decs["c dvb"], dvb_llr, decode_qc_long, decode_qc_long_plain,
                           BF16_DVB_CFG, plain_reps=1, tag=" bf16 lazy (global)"),
    }
    out["dvb shared"] = median_ms(lambda: decode_qc_long(
        dvb, BF16_DVB_CFG, dvb_llr, _place=SHARED))
    log(f"[phase5] bf16 kernels: wimax 576 flooding SP {out['a sp flooding']:.4f} ms; "
        f"NR sum-product {out['nr sp']:.4f} ms, soft output {out['nr soft']:.4f} ms; "
        f"DVB-S2 64800 lazy in global memory {out['dvb']['kernel']:.4f} ms, forced "
        f"into shared memory {out['dvb shared']:.4f} ms")
    return out


def stored_weights(name: str) -> LearnedWeights:
    """A schedule the reference trained, from benchmarks/learned_weights_*.json."""
    with open(WEIGHTS_DIR / f"learned_weights_{name}.json") as f:
        d = json.load(f)
    return LearnedWeights(alpha=np.asarray(d["alpha"], np.float32),
                          beta=np.asarray(d["beta"], np.float32),
                          losses=(d["final_loss"],))


def all_zero_llr_spread(code, batch: int, lo: float, hi: float, seed: int) -> np.ndarray:
    """All-zero-codeword LLRs (2y/sigma^2), per-frame SNR uniform over [lo,
    hi] dB, noise from numpy: the trainer's batch distribution."""
    rng = np.random.default_rng(seed)
    snr = rng.uniform(lo, hi, size=(batch, 1))
    sigma = 10.0 ** (-snr / 20.0)
    y = 1.0 + sigma * rng.standard_normal((batch, code.n))
    return (2.0 * y / sigma**2).astype(np.float32)


def unrolled_pass(run, alpha, llr, device) -> tuple:
    """One forward and gradient of the unrolled decoder on ``device``:
    (posteriors, loss, d loss / d alpha) on the CPU."""
    a = torch.tensor(alpha, device=device, requires_grad=True)
    x = torch.from_numpy(llr).to(device)
    posts = run({"alpha": a, "beta": torch.zeros_like(a)}, x)
    loss = soft_ber_loss(posts, torch.zeros_like(x))
    loss.backward()
    return posts.detach().cpu(), float(loss.detach()), a.grad.cpu()


def phase_learned(llr, u):
    """Phase 4q: (a) ``train_nms`` on the card at the reference's training
    point, cut to LEARN_STEPS steps; (b) one unrolled forward and gradient
    on the card against the CPU; (c) the trained and the stored tied
    schedules through ``Decoder`` on kernel A at the bench point (phase 4's
    LLRs, triage 5), each equal to ``Decoder(implementation="torch")``;
    (d) the stored NR BG2 schedule on kernel C, equal to its plain version;
    (e) the stored per-iteration schedule through ``"auto"`` on the card:
    the torch path, equal to the CPU (:func:`torch_route_case`).  Returns
    the numbers of the kernels line and phase 5, and (e)'s case."""
    code = wimax(576, "3/4B")
    run = make_unrolled(code, LEARN_KW["n_iters"])
    held = all_zero_llr_spread(code, LEARN_HELD_OUT, *LEARN_KW["snr_db"], SEED + 900)
    init_alpha = np.full((1, code.m_b), 0.75, np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lw = train_nms(code, steps=LEARN_STEPS, seed=SEED, device="cuda", **LEARN_KW)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / LEARN_STEPS
    losses = np.asarray(lw.losses)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train_nms: a loss is not finite: {losses}")
    if not ((lw.alpha >= 0.05).all() and (lw.alpha <= 1.0).all()
            and (lw.beta == 0.0).all()):
        raise AssertionError(f"train_nms: weights outside their clip range "
                             f"{lw.alpha} {lw.beta}")
    # (b) the trained weights' forward and gradient, card against CPU, on
    # the held-out batch's first 256 frames; the loss falls on all of it
    few = held[:256]
    post_g, loss_g, grad_g = unrolled_pass(run, lw.alpha, few, "cuda")
    post_c, loss_c, grad_c = unrolled_pass(run, lw.alpha, few, "cpu")
    if not torch.equal(post_g, post_c):
        raise AssertionError("unrolled posteriors: the card differs from the CPU")
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        raise AssertionError(f"unrolled loss: {loss_g} on the card, {loss_c} on the CPU")
    # the tests' tolerance: rtol 1e-4 plus atol 1e-5 of the largest gradient
    grad_err = float((grad_g - grad_c).abs().max())
    if not ((grad_g - grad_c).abs()
            <= 1e-5 * grad_c.abs().max() + 1e-4 * grad_c.abs()).all():
        raise AssertionError(f"unrolled gradient: max |card - cpu| {grad_err}")
    held_losses = [unrolled_pass(run, a, held, "cuda")[1] for a in (init_alpha, lw.alpha)]
    if not held_losses[1] < held_losses[0]:
        raise AssertionError(f"train_nms: the held-out loss did not fall {held_losses}")
    log(f"[phase4q] train_nms {code.name} {LEARN_STEPS} steps of batch "
        f"{LEARN_KW['batch']} on the card: {step_ms:.1f} ms a step; step losses "
        f"first ten {losses[:10].mean():.5f}, last ten {losses[-10:].mean():.5f}; "
        f"held-out loss ({LEARN_HELD_OUT} frames) {held_losses[0]:.5f} at alpha 0.75 -> "
        f"{held_losses[1]:.5f}; alpha {np.round(lw.alpha[0], 4).tolist()}")
    log(f"[phase4q] unrolled forward + gradient, card == CPU: posteriors equal, loss "
        f"{loss_g:.7f} vs {loss_c:.7f}, gradient max |diff| {grad_err:.3e} "
        f"(of max {float(grad_c.abs().max()):.3e})")
    # (c) tied schedules on kernel A at the bench point
    tied = {}
    for name, w in (("trained", lw), ("stored", stored_weights("wimax576_r34B_tied"))):
        cfg = w.decoder_config(BENCH_CFG, per_layer=True)
        dec = Decoder(code, cfg, device="cuda")
        if dec.implementation != "cuda":
            raise AssertionError(f"the {name} tied schedule resolved to {dec.implementation}")
        decode_qc_cuda.launches = 0
        res = dec(llr)
        torch.cuda.synchronize()
        launches = decode_qc_cuda.launches
        if launches < 1:
            raise AssertionError(f"the {name} tied schedule launched no kernel")
        max_abs_diff(res, Decoder(code, cfg, device="cuda", implementation="torch")(llr))
        tied[name] = {"dec": dec, "launches": launches,
                      "mean_iterations": res.iterations.float().mean().item()}
        log(f"[phase4q] Decoder {name} tied schedule impl={dec.implementation} "
            f"batch={BATCH} snr={SNR_DB} {gates(dec, res, u)} launches={launches}; "
            "== Decoder(torch)")
    # (d) the stored NR BG2 schedule on kernel C
    nr = nr_code(384, 2)
    cfg_nr = stored_weights("nr_bg2_z384_tied").decoder_config(
        DecoderConfig(max_iters=LEARN_NR_ITERS), per_layer=True)
    dec_nr = Decoder(nr, cfg_nr, device="cuda")
    if dec_nr.implementation != "cuda_long":
        raise AssertionError(f"the NR schedule resolved to {dec_nr.implementation}")
    # the schedule's own channel (benchmarks/learned_nms.py:159-200): the
    # whole codeword through BPSK/AWGN, no puncturing or rate matching
    gen = torch.Generator(device="cuda").manual_seed(SEED + 910)
    u_nr = torch.randint(0, 2, (LEARN_NR_BATCH, nr.k), generator=gen, device="cuda",
                         dtype=torch.uint8)
    x, _ = transmit(gen, triangular_encode_fn(nr)(u_nr), LEARN_NR_SNR)
    x = x.contiguous()
    decode_qc_long.launches = 0
    res = dec_nr(x)
    torch.cuda.synchronize()
    nr_launches = decode_qc_long.launches
    if nr_launches < 1:
        raise AssertionError("the NR schedule launched no kernel")
    max_abs_diff(res, decode_qc_long_plain(nr, cfg_nr, x))
    scalar = Decoder(nr, DecoderConfig(normalization=0.75, max_iters=LEARN_NR_ITERS),
                     device="cuda")(x)
    log(f"[phase4q] Decoder {nr.name} stored tied schedule impl={dec_nr.implementation} "
        f"batch={LEARN_NR_BATCH} snr={LEARN_NR_SNR} {summary(res, LEARN_NR_ITERS)} "
        f"launches={nr_launches}; == the plain version (cuda); alpha 0.75: "
        f"{summary(scalar, LEARN_NR_ITERS)}")
    # (e) the stored per-iteration schedule: "auto" on the card takes the
    # torch path, as the reference's takes jnp
    r12 = wimax(576, "1/2")
    cfg_iter = stored_weights("wimax576_r12_T10").decoder_config(
        DecoderConfig(max_iters=12, soft_output=True))
    x = torch.from_numpy(numpy_llr(r12, LEARN_ITER_BATCH, LEARN_ITER_SNR, SEED + 920))
    iter_case = torch_route_case("phase4q", "stored per-iteration schedule (10 rows, "
                                 "12 sweeps, soft output)", r12, cfg_iter, x, LEARN_ITER_BATCH)
    return {"step_ms": step_ms, "losses_first10": float(losses[:10].mean()),
            "losses_last10": float(losses[-10:].mean()), "held_out": held_losses,
            "grad_err": grad_err, "tied": tied, "nr_launches": nr_launches,
            "iter_case": iter_case}


def phase_gdbf(llr, u, rs_dec, rs_llr):
    """Phase 4r: GDBF at phase 4's LLRs without the perturbation, card ==
    CPU in every field; the default noisy GDBF through ``Decoder`` at two
    SNRs (converged frames hold a zero syndrome); one RS-LDPC batch (phase
    4k's LLRs); the ``Coder`` BF byte stream on the card.  Returns the
    bench-code ``Decoder``, the noisy runs' FERs and the noiseless
    comparison's largest difference (0.0: any other raises)."""
    code = wimax(576, "3/4B")
    cfg0 = GDBFConfig(noise_scale=0.0)
    got = decode_gdbf(code, cfg0, llr)
    worst = max_abs_diff(got, decode_gdbf(code, cfg0, llr.cpu()))
    log(f"[phase4r] GDBF {code.name} noise_scale=0 batch={BATCH} snr={SNR_DB}: "
        f"{summary(got, 100)}; card == CPU")
    dec = Decoder(code, GDBFConfig(), device="cuda")
    if dec.implementation != "gdbf":
        raise AssertionError(f"GDBFConfig resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 950)
    enc = Encoder(code, device="cuda")
    fers = {}
    for snr in GDBF_SNRS:
        u2 = torch.randint(0, 2, (BATCH, code.k), generator=gen, device="cuda",
                           dtype=torch.uint8)
        x, _ = transmit(gen, enc(u2), snr)
        res = dec(x)
        conv = res.converged.cpu().numpy()
        if code.syndrome(res.bits.cpu().numpy()[conv]).any():
            raise AssertionError("GDBF: a converged frame has a nonzero syndrome")
        fers[snr] = {"fer": (dec.info_bits(res) != u2).any(dim=1).float().mean().item(),
                     "mean_iterations": res.iterations.float().mean().item(),
                     "converged": float(conv.mean())}
        log(f"[phase4r] Decoder GDBF (noise 0.6) {code.name} batch={BATCH} snr={snr}: "
            f"FER={fers[snr]['fer']:.4e} conv={fers[snr]['converged']:.4f} "
            f"mean_iters={fers[snr]['mean_iterations']:.3f}")
    # RS-LDPC: phase 4k's batch at 6.5 dB, and one at GDBF_RS_SNR where
    # bit flipping converges
    rs = rs_dec.code
    rs_dec_bf = Decoder(rs, GDBFConfig(), device="cuda")
    u_rs = torch.randint(0, 2, (rs_llr.shape[0], rs.k_info), generator=gen,
                         device="cuda", dtype=torch.uint8)
    high, _ = transmit(gen, Encoder(rs, device="cuda")(u_rs), GDBF_RS_SNR)
    for snr, x in ((RS_SNR, rs_llr), (GDBF_RS_SNR, high.contiguous())):
        res = rs_dec_bf(x)
        conv = res.converged.cpu().numpy()
        if rs.syndrome(res.bits.cpu().numpy()[conv]).any():
            raise AssertionError("GDBF RS-LDPC: a converged frame has a nonzero syndrome")
        log(f"[phase4r] Decoder GDBF {rs.name} (n={rs.n}) batch={x.shape[0]} "
            f"snr={snr}: {summary(res, 100)}")
    coder = Coder(288, 576, "1/2", device="cuda")
    coder.for_encoder()
    coder.for_decoder(BATCH)
    src = bytes((ord("a") + i % 26) for i in range(BF_CODEWORDS * coder._kb))
    post = coder.test(coder.encode(src), BF_SIGMA, seed=SEED)
    out, stats = coder.decode(post, len(src), "BF", return_stats=True)
    if bytes(out) != src:
        raise AssertionError("the Coder BF stream: the decoded bytes differ")
    log(f"[phase4r] Coder BF round trip on the card: {len(src)} bytes, "
        f"{BF_CODEWORDS} codewords at sigma {BF_SIGMA}, mean_iters="
        f"{stats['mean_iters']:.3f}: the decoded bytes equal the source")
    return dec, fers, worst


def reports_equal(a, b, what: str) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = (np.array_equal(x, y) if isinstance(x, np.ndarray) or isinstance(y, np.ndarray)
                else x == y)
        if not same:
            raise AssertionError(f"{what}: ImpulseReport.{f.name} differs")


def phase_probe(dec, llr) -> dict:
    """Phase 4s: CLI ``probe`` at its defaults on the card (kernel A), its
    report equal to the CPU's; ``impulse_probe`` at nr_code(384, 1) on
    kernel C equal to the same probe on the torch path of the card; one
    ``Decoder`` call inside ``profiling.trace``, whose trace names the
    kernel."""
    buf = io.StringIO()
    decode_qc_cuda.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["probe"])
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches = decode_qc_cuda.launches
    if rc != 0 or launches < 1:
        raise AssertionError(f"CLI probe: rc={rc}, {launches} launches")
    code = wimax(576, "1/2")
    card = impulse_probe(code, max_pair_patterns=2048, device="cuda")
    reports_equal(card, impulse_probe(code, max_pair_patterns=2048, device="cpu"),
                  "probe, card vs CPU")
    if f"probes={card.probes} " not in buf.getvalue():
        raise AssertionError(f"CLI probe printed {buf.getvalue()!r}")
    for line in buf.getvalue().splitlines():
        log(f"[phase4s] CLI probe: {line}")
    log(f"[phase4s] CLI probe on the card: {probe_s:.2f} s, {launches} kernel A launches; "
        "its report == the CPU's in every field")
    nr = nr_code(384, 1)
    decode_qc_long.launches = 0
    t0 = time.perf_counter()
    got = impulse_probe(nr, max_pair_patterns=PROBE_NR_PAIRS, device="cuda")
    torch.cuda.synchronize()
    nr_s = time.perf_counter() - t0
    nr_launches = decode_qc_long.launches
    if nr_launches < 1:
        raise AssertionError("the NR probe launched no kernel C")
    plain = DecoderConfig(schedule="layered", normalization=0.9, max_iters=60,
                          implementation="torch")
    reports_equal(got, impulse_probe(nr, plain, max_pair_patterns=PROBE_NR_PAIRS,
                                     device="cuda"), "NR probe, kernel C vs torch")
    log(f"[phase4s] impulse_probe {nr.name}: {got.probes} probes, min_weight="
        f"{got.min_weight}, breaches={got.breaches}, trapped={len(got.trapped)}, "
        f"{nr_s:.2f} s, {nr_launches} kernel C launches; == the torch path on the card")
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            dec(llr)
            torch.cuda.synchronize()
        names = os.listdir(tmp)
        text = "".join(open(os.path.join(tmp, n)).read() for n in names)
    if len(names) != 1 or "bp_layered_kernel" not in text:
        raise AssertionError(f"profiling.trace wrote {names}, kernel named: "
                             f"{'bp_layered_kernel' in text}")
    log(f"[phase4s] profiling.trace around one Decoder call wrote {names[0]} "
        f"({len(text)} bytes), naming bp_layered_kernel")
    return {"probe_s": probe_s, "launches": launches, "nr_probe_s": nr_s,
            "nr_launches": nr_launches}


def phase_native_bench(stream, native_s) -> dict:
    """Phase 4t (not BASELINE config 4t, which is phase 4o): the port's
    native host library (built in phase 2, in ``native_s`` g++ seconds) on
    the card's host: ``Coder`` decode type ``CPU`` (its C++ golden) round
    trips phase 4's stream and equals the NumPy golden on its first
    codewords; kernel A without triage equals the C++ layered golden at the
    bench point's first 256 frames; then CLI ``bench``'s ``measure()`` at
    full size, its record logged, its gates held.  Returns the record and
    kernel A's launches in the bench's run."""
    coder, src, post = stream
    code = coder.code
    t0 = time.perf_counter()
    out, stats = coder.decode(post, len(src), "CPU", return_stats=True)
    cpu_s = time.perf_counter() - t0
    conv = stats["converged"]
    kb = code.k // 8
    words = np.frombuffer(src, np.uint8).reshape(-1, kb)
    if not np.array_equal(out.reshape(-1, kb)[conv], words[conv]) or conv.mean() < 0.9:
        raise AssertionError(f"Coder CPU round trip: {conv.mean():.4f} converged, "
                             "or a converged codeword decoded wrong")
    err = int(np.sum(np.frombuffer(src, np.uint8) != out))
    built = f"g++ {native_s:.2f} s in phase 2" if native_s is not None else "prebuilt"
    log(f"[phase4t] native library {native.build()[0].name} ({built}); Coder CPU "
        f"round trip: {len(src)} bytes, {len(conv)} codewords in "
        f"{cpu_s:.3f} s, converged {conv.mean():.4f}, mean_iters "
        f"{stats['mean_iters']:.3f}, ErrNum={err}; every converged codeword's bytes "
        "equal the source")
    head = post.reshape(-1, code.n)[:NATIVE_NUMPY_FRAMES]
    nb, nc, ni = native.decode_golden_native(code, head, max_iters=coder.max_iters)
    if not (np.array_equal(nc, conv[:NATIVE_NUMPY_FRAMES])
            and np.array_equal(ni, stats["iterations"][:NATIVE_NUMPY_FRAMES])):
        raise AssertionError("Coder CPU differs from the native golden it runs")
    # in f32 the NumPy golden adds in the C++ golden's order: equal in every
    # field of every frame; in f64 (its default) a frame at the cap may
    # converge on one side only, so there the bits of the frames both
    # converge must agree and the others are counted
    f32 = golden.decode_golden(code, head, max_iters=coder.max_iters, dtype=np.float32)
    for name, got, want in zip(("bits", "converged", "iterations"), (nb, nc, ni), f32):
        if not np.array_equal(got, want):
            raise AssertionError(f"Coder CPU != the f32 NumPy golden: {name}")
    gb, gc, gi = golden.decode_golden(code, head, max_iters=coder.max_iters)
    both = nc & gc
    if not np.array_equal(nb[both], gb[both]):
        raise AssertionError("Coder CPU != the f64 NumPy golden on converged frames")
    apart = int(np.sum((nc != gc) | (ni != gi)))
    log(f"[phase4t] Coder CPU == the f32 NumPy golden on the stream's first "
        f"{NATIVE_NUMPY_FRAMES} codewords ({int(nc.sum())} converged) in every field; "
        f"against the f64 one: bits equal on the {int(both.sum())} both converge, "
        f"{apart} frames apart in converged or iterations")

    bench_code = wimax(576, "3/4B")
    _, (llr,) = bench.stage(bench_code, torch.device("cuda"), bench.BATCH, 1, bench.SEED)
    llr = llr[:NATIVE_LAYERED_FRAMES].contiguous()
    cfg = dataclasses.replace(bench.CONFIG, triage_iters=0)
    dec = Decoder(bench_code, cfg, device="cuda")
    if dec.implementation != "cuda":
        raise AssertionError(f"the bench point resolved to {dec.implementation}")
    res = dec(llr)
    want = native.decode_golden_layered_native(
        bench_code, llr.cpu().numpy(), max_iters=cfg.max_iters,
        normalization=cfg.normalization)
    for name, got, w in zip(("bits", "converged", "iterations"),
                            (res.bits, res.converged, res.iterations), want):
        if not np.array_equal(got.cpu().numpy(), w):
            raise AssertionError(f"kernel A != the native layered golden: {name}")
    log(f"[phase4t] kernel A (no triage) == the native layered golden at the bench "
        f"point's first {NATIVE_LAYERED_FRAMES} frames ({int(want[1].sum())} converged, "
        f"mean iterations {want[2].mean():.3f}): bits, converged, iterations")

    decode_qc_cuda.launches = 0
    record = bench.measure()
    torch.cuda.synchronize()
    launches = decode_qc_cuda.launches
    if launches < 1 or not record["implementation"].startswith("cuda"):
        raise AssertionError(f"bench: {launches} kernel A launches, "
                             f"implementation {record['implementation']}")
    log(json.dumps({"bench": record}))
    log(f"[phase4t] bench: {record['value']:.1f} Mbit/s, {record['batch_ms']:.4f} ms "
        f"a batch, {record['vs_baseline']:.1f}x the native golden's "
        f"{record['cpu_baseline_mbits']:.3f} Mbit/s; {launches} kernel A launches")
    return {"record": record, "launches": launches}


def reset_launches() -> None:
    decode_qc_cuda.launches = 0
    decode_qc_long.launches = 0
    decode_qc_long.global_launches = 0


def port_launches() -> int:
    """The port's decode-kernel launches since :func:`reset_launches`."""
    return (decode_qc_cuda.launches + decode_qc_long.launches
            + decode_qc_long.global_launches)


def torch_route_case(tag, what, code, cfg, llr, cpu_frames):
    """One request that no kernel serves, through ``Decoder`` (auto) on the
    card: it must resolve to ``"torch"``, launch none of the port's
    kernels, and on the batch's first ``cpu_frames`` frames equal the same
    ``Decoder`` on the CPU in every field, posteriors included
    (sum-product at a converging point: :func:`sp_cpu_diff`, its largest
    posterior difference logged).  Returns the Decoder, the batch on the
    card, its result and that posterior difference."""
    dec = Decoder(code, cfg, device="cuda")
    if dec.implementation != "torch":
        raise AssertionError(f"{tag} {code.name} {what} resolved to {dec.implementation}")
    x = llr.to("cuda").contiguous()
    reset_launches()
    res = dec(x)
    got = dec(x[:cpu_frames])
    torch.cuda.synchronize()
    if port_launches():
        raise AssertionError(f"{tag} {code.name} {what}: the torch route launched a kernel")
    want = Decoder(code, cfg, device="cpu")(x[:cpu_frames].cpu())
    if cfg.algorithm == "sum-product":
        if not bool(want.converged.all()):
            raise AssertionError(f"{tag} {code.name} {what}: not a converging point")
        post = sp_cpu_diff(got, want)
        held = f"equal bits and converged flags (posteriors within {post:.3g})"
    else:
        post = max_abs_diff(got, want)
        held = "equal in every field"
    log(f"[{tag}] Decoder {code.name} {what} impl={dec.implementation} batch={x.shape[0]} "
        f"{summary(res, cfg.max_iters)} launches=0; its first {cpu_frames} frames "
        f"{held} on the CPU")
    return dec, x, res, post


def torch_route_times(tag, dec, x, res, reps: int = TR_REPS) -> dict:
    """A torch-route ``Decoder`` on the card (``res``: its result on ``x``,
    which warmed it up): the median of ``reps`` CUDA-event-timed calls, and
    in one more call (:func:`profile_call`) the CUDA kernels a sweep, the
    host-to-device copies and the kernels' device time over the call's (the
    busy share).  Its torch ops are not counted on the card: a dispatch
    mode slows every op many times over, and the count is the CPU's."""
    sweeps = int(res.total_iters)
    ms = median_ms(lambda: dec(x), reps, warm=False)
    counts = profile_call(lambda: dec(x))
    out = {"ms": ms, "sweeps": sweeps, "ms_per_sweep": ms / sweeps,
           "mean_iterations": res.iterations.float().mean().item(),
           "cuda_kernels_per_sweep": counts["kernels"] / sweeps,
           "htod_per_call": counts["htod"], "kernel_ms": counts["kernel_ms"],
           "busy_share": counts["kernel_ms"] / ms,
           "decoded_mbits": x.shape[0] * dec.code.k_info / (ms * 1e-3) / 1e6}
    log(f"[{tag}] {dec.code.name} torch route: {ms:.4f} ms per batch of {x.shape[0]} "
        f"(median of {reps}; {sweeps} sweeps, {out['ms_per_sweep']:.4f} ms a sweep) = "
        f"{out['decoded_mbits']:.1f} Mbit/s; {out['cuda_kernels_per_sweep']:.1f} CUDA "
        f"kernels a sweep, {counts['htod']} host-to-device copies a call, device time "
        f"{counts['kernel_ms']:.4f} ms (busy share {out['busy_share']:.3f})")
    return out


def codec_stream(coder, n_codewords: int, snr_db: float):
    """``coder``'s byte stream of ``n_codewords`` codewords, encoded and
    through ``test`` at ``snr_db``: (source bytes, codeword bytes, soft
    stream)."""
    coder.for_encoder()
    coder.for_decoder(2048)
    src = bytes((ord("a") + i % 26) for i in range(n_codewords * coder._kb))
    prior = coder.encode(src)
    return src, prior, coder.test(prior, 10 ** (-snr_db / 20), seed=SEED)


def stream_decode(tag, coder, src, post, de_type, impl, warned=None):
    """``coder.decode`` of the soft stream by ``de_type`` on the card: its
    Decoder must resolve to ``impl`` and launch a kernel exactly when
    ``impl`` names one, the warning ``warned`` must be raised (or none),
    and every converged codeword's bytes must equal the source.  Returns
    (decoded bytes, stats, kernel launches)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reset_launches()
        out, stats = coder.decode(post, len(src), de_type, return_stats=True)
        torch.cuda.synchronize()
    launches = port_launches()
    texts = [str(w.message) for w in caught]
    got = coder._decoders[de_type].implementation
    if got != impl or (launches > 0) != (impl != "torch"):
        raise AssertionError(f"{tag} {de_type}: resolved to {got}, {launches} launches")
    if (warned is None and texts) or (warned is not None and not any(warned in t for t in texts)):
        raise AssertionError(f"{tag} {de_type}: warnings {texts}")
    conv = stats["converged"]
    kb = coder._kb
    words = np.frombuffer(src, np.uint8).reshape(-1, kb)
    if not conv.any() or not np.array_equal(out.reshape(-1, kb)[conv], words[conv]):
        raise AssertionError(f"{tag} {de_type}: a converged codeword decoded wrong")
    log(f"[{tag}] Coder {de_type} {coder.code.name}: {len(src)} bytes, impl={got}, "
        f"launches={launches}, {int(conv.sum())} of {len(conv)} converged, every one "
        f"byte-equal to the source, mean_iters={stats['mean_iters']:.3f}"
        + (f"; warned: {texts[0][:70]}..." if texts else ""))
    return out, stats, launches


def phase_torch_route(nr_llrs, iter_case):
    """Phase 4u: the four classes that no kernel serves and the reference
    sends to its jnp path, through the normal entry points on the card at
    full width: (a) NR BG1 Z=384 flooding, SCMS and flooding sum-product,
    and its byte stream with SCMS and MSCL; (b) DVB-S2 16200 and 64800
    flooding; (c) the stored per-iteration schedule (phase 4q (e)'s case,
    timed here); (d) rs_ldpc_from_n(8192) layered and flooding, and its
    Coder MSCL stream; (e) soft output on nr_code(32, 1); (f) one CLI
    ``waterfall`` point of NR flooding.  Returns the record and the MSCL
    stream's kernel-C launches."""
    from myldpccppapi_torch.codes.rs_ldpc import rs_ldpc_from_n

    rec = {}
    tag = "phase4u"
    # (a) NR BG1 Z=384: the Decoder, then the byte stream
    nr = nr_code(384, 1)
    for name, cfg in TR_NR_CFGS.items():
        case = torch_route_case(tag, name, nr, cfg, nr_llrs[TR_NR_SNR], TR_CPU_FRAMES)
        rec[f"nr_bg1_z384 {name}"] = {**torch_route_times(tag, *case[:3]),
                                      "cpu_posterior_max_abs_err": case[3]}
    coder = make_codec("nr", z=384, device="cuda")
    src, _, post = codec_stream(coder, TR_STREAM_CODEWORDS, TR_STREAM_SNR)
    out, stats, _ = stream_decode(tag, coder, src, post, "SCMS", "torch")
    cpu = make_codec("nr", z=384, device="cpu")
    m = TR_CPU_FRAMES
    out_cpu, stats_cpu = cpu.decode(post[:m * nr.n], m * coder._kb, "SCMS",
                                    return_stats=True)
    if not (np.array_equal(out[:m * coder._kb], out_cpu)
            and np.array_equal(stats["iterations"][:m], stats_cpu["iterations"])):
        raise AssertionError("Coder SCMS on the card differs from the CPU decode")
    log(f"[{tag}] Coder SCMS: its first {m} codewords equal to the CPU decode")
    _, _, mscl_launches = stream_decode(tag, coder, src, post, "MSCL", "cuda_long",
                                        warned="LAYERED long-code kernel")
    # (b) DVB-S2 flooding
    for n, snr, reps, frames in TR_DVB_CASES:
        code = dvbs2(n, "1/2")
        case = torch_route_case(tag, f"flooding {snr} dB", code, TR_DVB_CFG,
                                dvbs2_llr(code, TR_DVB_BATCH, snr, SEED + 1100 + n), frames)
        rec[f"dvbs2_{n} flooding"] = torch_route_times(tag, *case[:3], reps=reps)
    # (c) the stored per-iteration schedule (phase 4q (e) held it)
    rec["wimax576_r12 per-iteration T10"] = torch_route_times(tag, *iter_case[:3])
    # (d) RS-LDPC n=8192: the Decoder, then Coder("MSCL")
    rs = rs_ldpc_from_n(TR_RS_N)
    rs_llr = torch.from_numpy(numpy_llr(rs, TR_RS_BATCH, TR_RS_SNR, SEED + 1200))
    for name, cfg in TR_RS_CFGS.items():
        case = torch_route_case(tag, name, rs, cfg, rs_llr, TR_CPU_FRAMES)
        rec[f"rs_ldpc_{TR_RS_N} {name}"] = torch_route_times(tag, *case[:3])
    rs_coder = make_codec("rs_ldpc", TR_RS_N, device="cuda")
    src, _, post = codec_stream(rs_coder, TR_RS_STREAM_CODEWORDS, TR_RS_SNR)
    stream_decode(tag, rs_coder, src, post, "MSCL", "torch",
                  warned="torch flooding path on the card")
    # (e) soft output on nr_code(32, 1)
    small = nr_code(TR_SOFT_Z, 1)
    case = torch_route_case(tag, "soft output", small,
                            dataclasses.replace(NR_CFG, soft_output=True),
                            nr_numpy_llr(small, TR_SOFT_BATCH, TR_SOFT_SNR, SEED + 1300),
                            TR_CPU_FRAMES)
    rec[f"nr_bg1_z{TR_SOFT_Z} soft output"] = torch_route_times(tag, *case[:3])
    # (f) one waterfall point through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["waterfall", "--family", "nr", "--z", "384", "--schedule", "flooding",
                "--normalization", "0.8", "--snr", str(TR_NR_SNR), "--batch", str(NR_BATCH),
                "--max-frames", str(NR_BATCH), "--max-iters", "30",
                "--out", os.path.join(tmp, "wf.csv"), "--device", "cuda"]
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if cli.main(argv) != 0:
                raise AssertionError("the NR flooding waterfall exited non-zero")
        wall = time.perf_counter() - t0
        if port_launches():
            raise AssertionError("the NR flooding waterfall launched a kernel")
    for line in buf.getvalue().strip().splitlines():
        log(f"[{tag}] waterfall {line}")
    rec["waterfall_nr_flooding_s"] = wall
    log(f"[{tag}] CLI waterfall --family nr --z 384 --schedule flooding: one point of "
        f"{NR_BATCH} frames in {wall:.2f} s, no kernel launched")
    return rec, mscl_launches


def learned_times(dec_scalar, tied, llr) -> dict:
    """Phase 5: the bench point's ``Decoder`` with the trained and stored
    tied schedules against the 0.75 scalar's (phase 4's), ms and mean
    iterations."""
    out = {"scalar": {"ms": median_ms(lambda: dec_scalar(llr)),
                      "mean_iterations": dec_scalar(llr).iterations.float().mean().item()}}
    for name, t in tied.items():
        out[name] = {"ms": median_ms(lambda: t["dec"](llr)),
                     "mean_iterations": t["mean_iterations"]}
    for name, t in out.items():
        log(f"[phase5] learned {name} Decoder (bench point, triage 5): {t['ms']:.4f} ms, "
            f"mean iterations {t['mean_iterations']:.4f}")
    return out


def gdbf_times(dec, llr) -> dict:
    """Phase 5: GDBF's ``Decoder`` on phase 4's LLRs (noise 0.6): ms per
    batch and per iteration, torch ops and CUDA kernels per iteration."""
    res = dec(llr)
    iters = int(res.total_iters)
    ms = median_ms(lambda: dec(llr), 5)
    counts = count_ops(lambda: dec(llr))
    out = {"ms": ms, "iterations": iters, "ms_per_iteration": ms / iters,
           "torch_ops_per_iteration": counts["ops"] / iters,
           "cuda_kernels_per_iteration": counts["kernels"] / iters,
           "kernel_ms": counts["kernel_ms"], "busy_share": counts["kernel_ms"] / ms,
           "converged": res.converged.float().mean().item()}
    log(f"[phase5] GDBF Decoder {dec.code.name} batch {llr.shape[0]} at {SNR_DB} dB: "
        f"{ms:.4f} ms ({iters} iterations, {out['ms_per_iteration']:.4f} ms each); "
        f"{out['torch_ops_per_iteration']:.1f} torch ops and "
        f"{out['cuda_kernels_per_iteration']:.1f} CUDA kernels an iteration, their device "
        f"time {out['kernel_ms']:.4f} ms (busy share {out['busy_share']:.3f})")
    return out


def check_long_scratch_layout() -> None:
    """Hold the shared placement's scratch, as the library sizes it
    (``ldpc_bp_long_scratch_bytes``), against the record codec that kernels
    A and D share (``cuda_stream.record_words``): ``[m_b, record words, z]``
    32-bit words under min-sum, ``[num_blocks, z]`` messages under
    sum-product, for the codes kernel C serves, in f32 and bf16."""
    for code in (nr_code(384, 1), dvbs2(16200, "1/2"), dvbs2(16200, "3/4")):
        for item in (4, 2):
            want = {False: code.m_b * cuda_stream.record_words(code.max_row_degree, item)
                    * code.z * 4, True: code.num_blocks * code.z * item}
            for sp, w in want.items():
                got = scratch_bytes(code, sp, item)
                if got != w:
                    raise RuntimeError(f"bp_long scratch of {code.name} (sum-product "
                                       f"{sp}, {item} B): {got} B, the codec's {w} B")
            log(f"[phase2] bp_long scratch of {code.name}, {item} B messages: min-sum "
                f"{want[False]} B, sum-product {want[True]} B per codeword, as the codec")


def ptxas_lines() -> list:
    """The decode kernels (bp_layered.cu, bp_long.cu, bp_stream.cu) as ptxas
    reported them at the build: each instantiation's (mangled template
    arguments) registers, shared memory and spills."""
    out, name = [], None
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry function" in line:
            name = next((f"{k}<{line.split(k)[1].split(chr(39))[0]}>"
                         for k in ("bp_layered_kernel", "bp_long_kernel", "bp_stream_kernel")
                         if k in line),
                        None)
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[phase1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul

    lib_path, seconds = _build.build()
    for step, s in seconds.items():
        log(f"[phase2] built {step} in {s:.2f} s")
    _build.load()
    log(f"[phase2] loaded {lib_path.name}")
    for line in ptxas_lines():
        log(f"[phase2] ptxas {line}")
    native_path, native_s = native.build()
    native.load()
    log(f"[phase2] native host library {native_path.name}: "
        + (f"built with g++ in {native_s:.2f} s" if native_s is not None
           else "built before this run"))
    check_long_scratch_layout()

    t0 = time.perf_counter()

    def phase(fn, *args):
        out = fn(*args)
        log(f"[time] {fn.__name__} done at {time.perf_counter() - t0:.1f} s")
        return out

    op_rate_entry = phase(phase_op_rate)
    worst = phase(phase_kernel_vs_plain)
    worst_modes, sp_cpu_post = phase(phase_modes_vs_plain)
    worst_b, b_dec, b_llr, b_launches = phase(phase_route_b_vs_plain)
    worst_xor, xor_sp_cpu = phase(phase_xor_vs_plain)
    worst_me, me_dec, me_llr, me_launches = phase(phase_multi_edge_vs_plain)
    worst_long = phase(phase_long_kernel_vs_plain)
    worst_shared, worst_global = phase(phase_dvbs2_kernel_vs_plain)
    worst_c_modes, c_sp_cpu_post = phase(phase_long_modes_vs_plain)
    worst_el, el_sp_cpu_post = phase(phase_edgelist_vs_cpu)
    dec, llr, u, launches, coder_launches, stream = phase(phase_main_path)
    flood_decs, flood_launches, mode_coder_launches = phase(
        phase_flooding_main_path, llr, u, stream)
    rs_dec, rs_llr, rs_launches, rs_coder_launches, crc_coder_launches = phase(
        phase_rs_main_path)
    wifi_dec, wifi_llr, wifi_launches = phase(phase_wifi_main_path)
    nr_dec, nr_llrs, nr_launches, sp_dec, sp_launches, nr_soft_dec, nr_u = phase(
        phase_nr_main_path)
    nr_llr = nr_llrs[5.0]
    dvb_dec, dvb_llr, dvb_launches, dvb_soft_dec, dvb_soft_launches, dvb_u = phase(
        phase_dvbs2_main_path)
    m3 = phase(phase_3m_main_path)
    m4 = phase(phase_4m_main_path)
    bicm = phase(phase_bicm_id)
    phase(phase_bf16_modes_vs_plain)
    phase(phase_bf16_semantics)
    bf16 = phase(phase_bf16_main_paths, llr, u, nr_llrs, nr_u, dvb_llr, dvb_u)
    bf16_fers = phase(phase_bf16_waterfall)
    acceptance = phase(phase_acceptance)
    legs = phase(phase_legs)
    oracle_dec, oracle_llr, oracle_counts = phase(phase_oracle_main_path)
    tb, tb_payload, tb_llr, tb_ok, tb_launches = phase(phase_transport)
    learned = phase(phase_learned, llr, u)
    gdbf_dec, gdbf_fers, gdbf_worst = phase(phase_gdbf, llr, u, rs_dec, rs_llr)
    probe = phase(phase_probe, dec, llr)
    nat = phase(phase_native_bench, stream, native_s)
    torch_route, nr_mscl_launches = phase(phase_torch_route, nr_llrs, learned["iter_case"])
    mp = phase(phase_multiprocess)
    times = phase_times(dec, llr, decode_qc_cuda, decode_qc_cuda_plain,
                        dataclasses.replace(BENCH_CFG, triage_iters=0))
    passes = triage_times(dec, llr)
    mode_times = {group: phase_times(d, llr, decode_qc_cuda, decode_qc_cuda_plain,
                                     MODE_CFGS[group], plain_reps=1, tag=f" {group}")
                  for group, d in flood_decs.items()}
    b_times = phase_times(b_dec, b_llr, decode_qc_cuda, decode_qc_cuda_plain,
                          NR_CFG, plain_reps=1, tag=" kernel B route")
    rs_times = phase_times(rs_dec, rs_llr, decode_qc_cuda, decode_qc_cuda_plain,
                           RS_CFG, plain_reps=1, tag=" xor")
    me_times = phase_times(me_dec, me_llr, decode_qc_cuda, decode_qc_cuda_plain,
                           ME_CFG, plain_reps=1, tag=" multi-edge")
    wifi_times = phase_times(wifi_dec, wifi_llr, decode_qc_cuda, decode_qc_cuda_plain,
                             WIFI_CFG, plain_reps=1, tag=" config 2")
    nr_times = phase_times(nr_dec, nr_llr, decode_qc_long,
                           decode_qc_long_plain, NR_CFG)
    dvb_all_times = phase_dvbs2_times(dvb_dec, dvb_llr)
    dvb_times, dvb_exact_times = dvb_all_times["lazy"], dvb_all_times["exact"]
    sp_times = phase_times(sp_dec, nr_llr, decode_qc_long, decode_qc_long_plain,
                           NR_SP_CFG, plain_reps=1, tag=" sum-product")
    soft_times = phase_times(nr_soft_dec, nr_llr, decode_qc_long, decode_qc_long_plain,
                             nr_soft_dec.config, plain_reps=1, tag=" soft output")
    dvb_soft_times = phase_times(dvb_soft_dec, dvb_llr, decode_qc_long,
                                 decode_qc_long_plain, dvb_soft_dec.config,
                                 plain_reps=1, tag=" lazy soft output")
    m3_dec, m3_mod, m3_y, m3_n0, _ = m3
    m3_times = receive_times(" 3m", m3_dec, m3_mod, m3_y, m3_n0, lambda x: x)
    m4_dec, m4_mod, m4_y, m4_n0, m4_e, _ = m4
    m4_times = receive_times(
        " 4m", m4_dec, m4_mod, m4_y, m4_n0,
        lambda x: rate_match_llr(m4_dec.code, x, m4_e).contiguous())
    rx, rx_plain, id_y, id_n0 = bicm[:4]
    id_ms = median_ms(lambda: rx(id_y, id_n0))
    id_plain_ms = median_ms(lambda: rx_plain(id_y, id_n0), 1)
    log(f"[phase5] BICM-ID step ({ID_OUTER} exchanges, dvbs2ira_n16200_r34 as "
        f"16apsk, batch {ID_BATCH}, {ID_SNR} dB): {id_ms:.4f} ms, on the plain "
        f"version {id_plain_ms:.4f} ms")
    bf16_times = phase_bf16_times(bf16["decs"], llr, nr_llr, dvb_llr)
    nr = nr_code(384, 1)
    sweeps = {name: long_sweep_fields(nr, cfg, nr_llr) for name, cfg in (
        ("min-sum", NR_CFG), ("sum-product", NR_SP_CFG), ("soft", nr_soft_dec.config),
        ("bf16", BF16_NR_CFGS["min-sum"]))}
    el_times = phase_edgelist_times(oracle_dec, oracle_llr)
    tb_times = phase_transport_times(tb, tb_payload, tb_llr)
    log(f"[phase5] train_nms step (wimax 576 r3/4B, {LEARN_KW['n_iters']} sweeps, batch "
        f"{LEARN_KW['batch']}): {learned['step_ms']:.2f} ms")
    learn_times = learned_times(dec, learned["tied"], llr)
    gdbf_t = gdbf_times(gdbf_dec, llr)
    log(f"[phase5] CLI probe (wimax 576 r1/2, {probe['launches']} launches): "
        f"{probe['probe_s']:.3f} s; NR BG1 Z=384 probe {probe['nr_probe_s']:.3f} s")
    for family in C5_FAMILIES:
        w1, cli4 = mp["world1"][family], mp["cli"][family]
        log(f"[phase5] config 5 {family} campaign: {w1['frames_per_s']:.1f} frames/s at "
            f"world 1 (nccl, its step warm), {cli4['frames_per_s']:.1f} at {MP_RANKS} "
            f"ranks on the card (gloo, the CLI); over the points past the first "
            f"group {w1['steady_frames_per_s']:.1f} and {cli4['steady_frames_per_s']:.1f}")
    log(f"[phase5] the step's collective: {mp['world1']['collective_ms']:.4f} ms at world 1 "
        f"(nccl); at {MP_RANKS} gloo ranks on the card "
        f"{[round(x, 4) for x in mp['ranks']['collective_ms']]} ms per rank")
    log(f"[phase5] spawn + init of {MP_RANKS} ranks: {mp['ranks']['ready_s']:.2f} s to the "
        f"last rank's legs, {mp['ranks']['spawn_s']:.2f} s for the whole dry run")
    log(f"[time] phase 5 done at {time.perf_counter() - t0:.1f} s")

    # the edge-list path runs torch ops, no kernel of its own: its record
    log(json.dumps({"edgelist": {
        "source": "myldpccppapi_torch/ops/bp_edgelist.py",
        "replaces": "myldpccppapi_tpu/ops/bp_edgelist.py:133 (XLA gathers and scatters)",
        "cuda_vs_cpu_max_abs_err": worst_el, "sp_cpu_posterior_max_abs_err": el_sp_cpu_post,
        **oracle_counts, **el_times}}))
    # GDBF and the trainer run torch ops, no kernel of their own: their records
    log(json.dumps({"gdbf": {
        "source": "myldpccppapi_torch/ops/bitflip.py",
        "replaces": "myldpccppapi_tpu/ops/bitflip.py:57 (XLA ops)",
        "noiseless_cuda_vs_cpu_max_abs_err": gdbf_worst,
        "fer": {str(k): v for k, v in gdbf_fers.items()}, **gdbf_t}}))
    log(json.dumps({"train_nms": {
        "source": "myldpccppapi_torch/ops/learned.py",
        "replaces": "myldpccppapi_tpu/ops/learned.py:169 (jax.grad + optax)",
        "steps": LEARN_STEPS, "step_ms": learned["step_ms"],
        "losses_first10": learned["losses_first10"],
        "losses_last10": learned["losses_last10"],
        "held_out_loss_init_trained": learned["held_out"],
        "grad_cuda_vs_cpu_max_abs_err": learned["grad_err"],
        "decoder_ms": {k: v["ms"] for k, v in learn_times.items()},
        "decoder_mean_iterations": {k: v["mean_iterations"]
                                    for k, v in learn_times.items()}}}))
    # the torch route runs torch ops, no kernel of its own: its record
    log(json.dumps({"torch_route": {
        "source": "myldpccppapi_torch/ops/bp.py",
        "replaces": "myldpccppapi_tpu/decoder.py:25-102 (the jnp route: XLA ops)",
        **torch_route}}))
    log(smi)

    def entry(name, source, replaces, launches, worst, t, **extra):
        return {"name": name, "route": "cuda",
                "source": f"myldpccppapi_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **extra,
                "max_abs_err": worst, "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["bound_by"],
                # no single PyTorch call computes a BP decode
                "library_ms": None}

    kernel_a = "myldpccppapi_tpu/ops/pallas_bp.py:249"
    kernel_c = "myldpccppapi_tpu/ops/pallas_zlane.py:205"
    kernel_d = "myldpccppapi_tpu/ops/pallas_stream.py:120"
    print(json.dumps({"kernels": [
        entry("bp_layered", "bp_layered.cu", kernel_a,
              launches, worst, times, decoder_ms=times["decoder"],
              fast_pass_ms=passes["fast"], straggler_pass_ms=passes["straggler"],
              coder_launches=coder_launches,
              acceptance_leg_wimax576_crc16=legs["wimax576_crc16"],
              crc16_stream_coder_launches=crc_coder_launches,
              config2_launches=wifi_launches, config2_ms=wifi_times["kernel"],
              config2_plain_ms=wifi_times["plain"],
              config2_decoder_ms=wifi_times["decoder"],
              config2_bound_ms=wifi_times["bound"],
              # phase 4p (b): leg 1 on each of the 4 gloo ranks of the card
              multichip_4_ranks_launches=mp["ranks"]["wimax576_crc16"]["launches"],
              # phase 4q (c): the tied learned schedules at the bench point;
              # phase 4s: the CLI probe
              learned_tied_launches={k: v["launches"] for k, v in learned["tied"].items()},
              learned_tied_decoder_ms={k: v["ms"] for k, v in learn_times.items()},
              probe_launches=probe["launches"], probe_s=probe["probe_s"],
              # phase 4t: CLI bench's measure() (its warm-up and timed calls)
              bench_launches=nat["launches"], bench_mbits=nat["record"]["value"],
              bench_batch_ms=nat["record"]["batch_ms"],
              bench_vs_native_golden=nat["record"]["vs_baseline"]),
        # kernel A's xor group (RS-LDPC, phase 4k) and multi-edge cells (3j)
        entry("bp_layered_xor", "bp_layered.cu", kernel_a, rs_launches, worst_xor,
              rs_times, coder_launches=rs_coder_launches,
              cpu_posterior_max_abs_err=xor_sp_cpu),
        entry("bp_layered_multi_edge", "bp_layered.cu", kernel_a, me_launches,
              worst_me, me_times),
        # kernel A's modes in the same source, each on its phase-4d path
        entry("bp_layered_flooding", "bp_layered.cu", kernel_a,
              flood_launches["flooding"], worst_modes["flooding"],
              mode_times["flooding"],
              coder_launches=mode_coder_launches["MSCL"]),
        entry("bp_layered_scms", "bp_layered.cu", kernel_a,
              flood_launches["scms"], worst_modes["scms"], mode_times["scms"],
              coder_launches=mode_coder_launches["SCMS"]),
        entry("bp_layered_sum_product", "bp_layered.cu", kernel_a,
              flood_launches["sp"], worst_modes["sp"], mode_times["sp"],
              cpu_posterior_max_abs_err=sp_cpu_post, **acceptance),
        entry("bp_layered_soft_output", "bp_layered.cu", kernel_a,
              flood_launches["soft"], worst_modes["soft"], mode_times["soft"],
              bicm_id_launches=bicm[7]),
        # kernel B's table-driven route through the same kernel
        entry("bp_layered_route_b", "bp_layered.cu",
              "myldpccppapi_tpu/ops/pallas_bp.py:410", b_launches, worst_b,
              b_times, acceptance_leg_nr_bg1_z32_rm_crc16=legs["nr_bg1_z32_rm_crc16"],
              multichip_4_ranks_launches=mp["ranks"]["nr_bg1_z32_rm_crc16"]["launches"]),
        entry("bp_long", "bp_long.cu", kernel_c, nr_launches,
              max(worst_long, worst_shared), nr_times, **sweeps["min-sum"],
              m4_launches=m4[-1], m4_demap_ms=m4_times["demap"],
              m4_receive_ms=m4_times["receive"],
              acceptance_leg_dvbs2_16200_bch=legs["dvbs2_16200_bch"],
              # BASELINE config 4t (phase 4o): the transport's receive
              config4t_launches=tb_launches, config4t_tb_ok=tb_ok,
              config4t_tbs=TB_BATCH, config4t_ms=tb_times["receive_ms"],
              config4t_payload_mbits=tb_times["receive_mbits"],
              config4t_chain_ms=tb_times["chain_ms"],
              config4t_chain_payload_mbits=tb_times["chain_mbits"],
              # phase 4p: leg 2 on each of the 4 gloo ranks (b); BASELINE
              # config 5's campaigns at world 1 (nccl, a) and through the
              # CLI on 4 ranks of the card (c)
              multichip_4_ranks_launches=mp["ranks"]["dvbs2_16200_bch"]["launches"],
              config5_world1_launches={f: mp["world1"][f]["launches"] for f in C5_FAMILIES},
              config5_world1_frames_per_s={f: mp["world1"][f]["frames_per_s"]
                                           for f in C5_FAMILIES},
              config5_world1_steady_frames_per_s={f: mp["world1"][f]["steady_frames_per_s"]
                                                  for f in C5_FAMILIES},
              config5_4_ranks_frames_per_s={f: mp["cli"][f]["frames_per_s"]
                                            for f in C5_FAMILIES},
              config5_4_ranks_steady_frames_per_s={f: mp["cli"][f]["steady_frames_per_s"]
                                                   for f in C5_FAMILIES},
              collective_ms_world1_nccl=mp["world1"]["collective_ms"],
              collective_ms_4_ranks_gloo=mp["ranks"]["collective_ms"],
              # phase 4q (d): the stored NR BG2 Z=384 tied schedule; phase
              # 4s: the NR probe
              learned_nr_bg2_launches=learned["nr_launches"],
              probe_nr_launches=probe["nr_launches"],
              # phase 4u: Coder("MSCL") on NR BG1 Z=384, its layered substitution
              mscl_nr_coder_launches=nr_mscl_launches),
        # the global placement (kernel D's port) on the DVB-S2 64800 path
        entry("bp_stream", "bp_stream.cu", kernel_d, dvb_launches,
              worst_global, dvb_times, exact_ms=dvb_exact_times["kernel"],
              m3_launches=m3[-1],
              m3_demap_ms=m3_times["demap"], m3_decode_ms=m3_times["kernel"],
              m3_plain_ms=m3_times["plain"], m3_bound_ms=m3_times["bound"],
              m3_receive_ms=m3_times["receive"]),
        # kernel C's sum-product and soft-output modes, each on its main path
        entry("bp_long_sum_product", "bp_long.cu", kernel_c, sp_launches,
              worst_c_modes["sp"], sp_times, cpu_posterior_max_abs_err=c_sp_cpu_post,
              **sweeps["sum-product"]),
        entry("bp_long_soft_output", "bp_long.cu", kernel_c, bicm[4],
              worst_c_modes["soft"], soft_times, **sweeps["soft"], bicm_id_ms=id_ms,
              bicm_id_plain_ms=id_plain_ms, bicm_id_fer=[bicm[5], bicm[6]]),
        entry("bp_stream_soft_output", "bp_stream.cu", kernel_d,
              dvb_soft_launches, worst_c_modes["soft"], dvb_soft_times),
        # bf16 messages (phases 3g, 3h, 4h): kernel C at NR BG1 Z=384 (its
        # forced shared placement at DVB-S2 64800 as dvb_shared_* fields),
        # C's global placement on the DVB-S2 64800 main path, kernel A at
        # wimax 576 r3/4B
        entry("bp_long_bf16", "bp_long.cu", kernel_c, bf16["launches"]["c min-sum"],
              0.0, bf16_times["nr"], **sweeps["bf16"],
              sp_launches=bf16["launches"]["c sum-product"],
              sp_ms=bf16_times["nr sp"], soft_launches=bf16["launches"]["c soft"],
              soft_ms=bf16_times["nr soft"],
              dvb_shared_forced_launches=bf16["launches"]["c dvb shared"],
              dvb_shared_ms=bf16_times["dvb shared"]),
        entry("bp_stream_bf16", "bp_stream.cu", kernel_d,
              bf16["launches"]["c dvb"], 0.0, bf16_times["dvb"]),
        entry("bp_layered_bf16", "bp_layered.cu", kernel_a,
              bf16["launches"]["a layered"], 0.0, bf16_times["a"],
              sp_flooding_launches=bf16["launches"]["a sp flooding"],
              sp_flooding_ms=bf16_times["a sp flooding"],
              waterfall_fer_f32=bf16_fers["float32"],
              waterfall_fer_bf16=bf16_fers["bfloat16"]),
        # kernel E: the calibration whose rates set every bound_ms above
        op_rate_entry,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
