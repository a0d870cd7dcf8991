#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, with one Hopper card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

0. device: print ``nvidia-smi``'s name and power limit; stop if
   ``torch.cuda.is_available()`` is false;
1. build: compile the CUDA kernels from ``vectorwave_tpu_torch/kernels/csrc``
   (one nvcc per source, all started together); every registered wavelet's
   filters ship in the package (``wavelets/_filter_table.py``), so none is
   generated at run time;
2. kernels against their plain PyTorch versions on the card (db4, 6 levels):
   analysis, synthesis and denoise (none/soft/hard) at 128x65536 periodic,
   3x5000 zero and 2x300 periodic in float32, and once in bfloat16; the
   denoise also at haar J=1 and J=10 (a row of 700, shorter than the span),
   sym8 J=4, db20 J=7, db4 J=1 and J=9, each in float32 and bfloat16; the
   exact fp64 analysis and synthesis at the same three shapes, with a lo
   word, from a first level above 1, with the levels split over two
   launches (sym8, 10 levels), and with levels too deep for shared memory
   read straight from device memory (db38, 9 levels), on odd rows (each
   after the first off 16 bytes) and from levels 9 and 10 (strides of 256
   and 512); the symmetric
   synthesis kernel (forward and adjoint) and the analysis kernel with a
   head splice, at db4 J=6 and sym8 J=4 128x65536, db4 J=6 3x5000, haar J=4,
   a long filter that needs a smaller tile (db36 J=8), and once in bfloat16,
   on odd rows in float32 and bfloat16, and on rows one sample longer than
   the two splices (db4 J=6 2x442, sym8 J=4 2x226), the adjoint also on the
   cotangent's interior and at strides 256 and 512 (haar J=10, sym8 J=9);
   the cascade pair (``run_analysis_mxu`` / ``run_synthesis_mxu``) in each
   edge mode (periodic, zero, and the analysis's per-level mirror) at db4
   J=6 and sym8 J=4 128x65536, db4 J=6 3x5000, db4 J=6 2x300 and sym8 J=4
   2x150 (N shorter than the span; the mirror's window outlasts the
   signal), haar J=5, db36 J=8 (the mirror at its 9088 tile, where the
   second block's window starts before the signal) and once in bfloat16;
   the library's launch tiles: the cascade pair's, the denoise's, the exact
   pair's and the symmetric pair's serve every shape the gates send
   (filter lengths 1-128, J 1-10, every first level of an exact plan, every
   registered wavelet's symmetric ops); the 2-D analysis
   and synthesis level kernels, every band, in each edge
   mode (periodic, zero, symmetric with the inverse's per-filter offsets),
   at levels 1 and 4 of db4 and 1 and 6 of sym8 at 8x2048x2048, at db4 level
   3 on 3x200x328, haar level 5 on 1x24x40, db20 level 4 on 2x1024x1024,
   every db4 level 1-6 on 2x1000x1030, haar level 10 and db20 level 6 (its
   deepest); the filter-bank pair (``bank_analysis`` / ``bank_synthesis``)
   in both edge modes with random dense taps (3 planes of 1, 37 and 300
   taps) at 3x5000 and 2x301, periodic at 2x150 (the span outlasts the
   signal) and once in bfloat16, an à trous pair at spacing 16, a span of
   30000 (one synthesis window buffer), the sym8 packet trees of depth 4
   (30 planes) and 5 (62 planes), the depth-4 tree at 64x16384 (a ragged
   last tile) and in bfloat16, the DTCWT's composed planes (both trees, 5
   levels), and the identity <A x, y> = <x, A^T y> for each edge; the
   CWT's kernel-direct tier: the bank analysis on the tier's dense taps
   (morl, ascending scales to h = 2048) against its plain version at
   1x2^20, 128x65536, a ragged 3x5000, 2x300 (the span past the row) and
   mexh, ``cwt`` under ``backend='kernel'`` (the tier on every scale to
   h = 2048, supports that wrap past the row included) against the FFT
   path within 2e-5 of the largest coefficient, and its gradient (one bank synthesis launch on the dense
   taps) against autograd through the plain version; the
   streaming modes: the analysis kernel's external edge (alone and with the
   head splice) and the denoise kernel's stream mode (none, soft, hard) at
   db4 J=6 128x65536 and 128x8192 (the streaming path's blocks) with a
   halo of the span, 3x5000 with a short halo,
   2x300 (shorter than the span), sym8 J=4 8x65536 with a long halo, db36
   J=8 (span 18105, longer than the tile; the analysis only, the denoise's
   windows do not fit) and the analysis in bfloat16; the tiled tier's
   edges: the synthesis kernel's external right halo and the exact pair's
   halos (a raw left halo for the analysis, (hi, lo) right halos for the
   synthesis) at db4 J=6 128x65536 with a halo of the span (441), 3x5000
   with a short halo, 2x300 (shorter than the span), the exact pair on a
   split plan (sym8 J=10, two launches on [halo | x]) and the synthesis in
   bfloat16;
2b. the MODWT core's mirrored test cases (``tools/mirror_cases.py``): the
   kernel-reaching cases of the JAX package's ``test_pallas_kernels.py``,
   ``test_fused_denoise.py``, ``test_fused_roundtrip.py``,
   ``test_tolerance_routing.py``, the property sweep's 24 MODWT
   configurations and the symmetric interior NRMSE guard at N = 257, at
   those tests' shapes and seeds, each through the public entry points
   under ``auto`` and under ``backend='kernel'`` and held against the plain
   route on the card (2e-5 in float32; 1e-13 on the exact tier's hi + lo,
   its round trip within 1e-10 RMSE; the NRMSE within 10% of the committed
   baseline); each direction's launches held to the gate
   (``multilevel._kernel_eligible``), and ``backend='kernel'`` refusing
   exactly where the kernels cannot serve; one line a case, the launches by
   kernel and a summary line of the cases by route and the worst error
   against each bound;
2c. the other kernel families' mirrored test cases
   (``tools/mirror_cases.family_cases``): the kernel-reaching cases of the
   JAX package's ``test_bank_kernel.py``, ``test_packets.py``,
   ``test_dtcwt.py``, ``test_cwt_kernel_direct.py``,
   ``test_dtcwt_shrink.py``, ``test_modwt2_pallas.py``,
   ``test_modwt2_fast.py``, ``test_twodim.py``, ``test_swt2.py``,
   ``test_symmetric_kernel.py``, ``test_denoise_swt.py``,
   ``test_exact_mode.py`` and ``test_baseline_configs.py`` (config #4), at
   those tests' shapes and seeds, each through the public entry points
   under ``auto`` and under ``backend='kernel'`` and held against the plain
   route on the card at the JAX tests' float32 bounds (the bank 2e-5, the
   dual tree 3e-5, the 2-D levels 2e-5 and round trips 5e-5, the symmetric
   pair 5e-6, the CWT 2e-5 of the largest coefficient, gradients 5e-6 of
   the largest entry); each direction's launches held to its family's
   router (by count where it fixes one), and ``backend='kernel'`` refusing
   exactly where the kernels' windows cannot serve; printed as phase 2b's;
2d. the streaming and parallel tiers' mirrored test cases
   (``tools/mirror_cases.tier_cases``): the kernel-reaching cases of the
   JAX package's ``test_streaming.py``, ``test_streaming_denoise_kernel.py``,
   ``test_sliding.py``, ``test_native_ingest.py``, ``test_parallel.py``,
   ``test_tiled2d.py`` and ``test_tiled_exact.py`` at those tests' shapes
   and seeds (float32), each through the public entry points under ``auto``
   and under ``backend='kernel'``: block streams (one external-edge
   analysis launch a block where ``stream.use_stream_kernel`` routes it)
   held to the whole-signal plain transform, the streaming denoiser's
   kernel tier (one stream-mode denoise launch a step, one a multi-block
   call) held to its plain versions (a class to the plain tier, 5e-5), the
   sliding window and the ingest (a cascade launch a window or a drain,
   ``_kernel_eligible``), the tiled pair on virtual shards of the card (one
   external-halo launch each way where ``tiled._resolve_tiled_backend``
   takes the kernel route; ``kernel`` refuses the symmetric boundary by
   design) held to the plain route and to one device, the sharded exact
   tier (its launch plan's count each way; hi + lo within 1e-13, round trip
   within 1e-10 RMSE) and the 2-D tiling's gathered image (``levels``
   launches each way where ``modwt2_kernel_eligible`` admits it); printed
   as phase 2b's;
2e. the CWT family's mirrored test cases (``tools/mirror_cases.analysis_cases``):
   the kernel-reaching cases of the JAX package's ``test_cwt.py``,
   ``test_variance_xwt.py`` and ``test_finance.py`` at those tests' shapes
   and seeds (float32), each through the public entry points under
   ``auto`` and under ``backend='kernel'``: ``cwt`` of a real wavelet,
   periodic, 60 scales 2-256 on 1024 samples, then ``icwt`` or a band
   reconstruction (under ``auto`` the FFT path, no launch; under
   ``kernel`` the bank analysis on all 60 scales, the 9 whose support
   wraps past N among them, one launch a chunk), the
   wavelet variance, covariance and correlation (one cascade analysis
   launch a transform), the variance stream on the kernel step (one
   external-edge launch a block), ``wavelet_sharpe_ratio`` and
   ``analyze_market`` (one fused denoise launch) and
   ``calculate_wavelet_indicators`` (one cascade analysis launch; its
   momentum within 5e-5), each launch held to its router's count and mode
   and each output to the plain route within 2e-5 of its largest value;
   printed as phase 2b's;
2f. the 1-D analysis modules' mirrored test cases
   (``tools/mirror_cases.decimated_cases``): the kernel-reaching cases of
   the JAX package's ``test_longmemory.py`` and ``test_block_fdr.py`` at
   those tests' shapes and seeds (float32), each through the public entry
   points under ``auto`` and under ``backend='kernel'``:
   ``hurst_exponent`` (one cascade analysis launch, through the wavelet
   variance), ``denoise_block`` (one cascade analysis and one synthesis
   launch, held within 1e-4 of its largest value), ``denoise_multilevel``
   with the universal rule (one fused denoise launch) and with FDR (one
   cascade analysis and one synthesis launch, held on its own
   thresholds), each launch held to its router's count; printed as phase
   2b's;
2g. the mirrored test cases of the 2-D trees, the solvers and the
   infrastructure (``tools/mirror_cases.solver_cases``): the
   kernel-reaching cases of the JAX package's ``test_sparse.py``,
   ``test_deconvolve.py``, ``test_infrastructure.py``,
   ``test_examples_and_fixtures.py`` and ``test_packets2d.py`` at those
   tests' shapes and seeds (float32), each through the public entry points
   under ``auto`` and under ``backend='kernel'``: ``bpdn`` and
   ``sparse_recover`` (a cascade analysis for the first coefficients, a
   synthesis and an analysis a FISTA step, a synthesis at the end; held
   within 1e-4 of the largest value, a solve's float32 drift), ``inpaint2``
   (the 2-D pair for the probe, the first analysis and the end),
   ``deconvolve`` and ``deconvolve2`` (the pair once each way, the 2-D
   probe one more), ``cost_model.calibrate`` (eleven round trips),
   ``modwt_based_icwt`` (the cascade analysis; under ``kernel`` the bank for
   the CWT), the tick denoise (one fused denoise launch), a kernel-tier
   stream checkpointed with ``np.savez`` (one external-edge launch a block,
   the restored block equal bit for bit) and ``denoise2``; each launch held
   to its router's count; printed as phase 2b's; then
   ``circular_convolve_modwt`` of the ops facade on the card (db4 on 256
   samples, the FFT route by the card's gate) against ``atrous_convolve``;
3. the main path through the public entry points at 128x65536 float32:
   ``modwt_multilevel`` -> ``imodwt_multilevel`` at every precision tier,
   ``modwt_roundtrip_fused`` and ``denoise_multilevel``, with the launch
   counters reset just before and read just after; then the gradients of
   analysis and synthesis against plain autograd, and a small input against
   the float64 plain cascade on the CPU; then the exact path, with its own
   reset and reading of the counters: ``precision='exact'`` and
   ``tolerance=1e-10`` round trips (RMSE of hi + lo against x <= 1e-10), the
   exact symmetric analysis against the float64 plain cascade on the CPU,
   and an input that requires grad, which must raise; then the probe's path
   (``tools/perf_probe_mxu.py``): ``run_analysis_mxu`` -> ``run_synthesis_mxu``
   db4 J=6 periodic at each precision, each round trip with its own reset
   and reading of the counters (one launch each way, RMSE <= 3e-7); then the
   symmetric path, with its own reset and reading of the counters: the db4
   J=6 symmetric round trip at 128x65536 (exactly one mirror-mode analysis
   and one symmetric synthesis launch, and no zero-mode analysis launch in
   the whole symmetric path) against the plain cascade on the card,
   ``swt_denoise`` sym8 J=4 soft universal at 128x65536 (both kernels) and
   1x16384 (the mirror analysis alone: a symmetric synthesis of fewer than
   2^23 samples is plain) against the plain path, the symmetric gradients of both directions against plain
   autograd (their backward launches the synthesis kernel and the adjoint),
   and a short input against the float64 plain cascade on the CPU; then,
   outside that count, the synthesis kernel forced at 1x16384 against the
   plain synthesis; then the
   gradient of the fused denoise (db4 J=6 soft at 128x65536, in x and in
   the thresholds) against plain autograd, with its own reset and reading of
   the counters (two analysis launches and one synthesis launch), and
   ``denoise_multilevel`` on an input that requires grad; then the 2-D path
   at 8x2048x2048, each public call with its own reset and reading of the
   counters (one 2-D kernel launch per level and direction):
   ``modwt2_multilevel`` -> ``imodwt2_multilevel`` db4 J=4 and J=6 periodic
   (every band against the plain path, the round trip against x within
   5e-5), db4 J=4 zero and sym8 J=4 symmetric round trips and ``denoise2``
   db4 J=4 universal soft against the plain path, a small input in each edge
   mode against the float64 plain cascade on the CPU, and a 2-D input that
   requires grad, which must raise; then the packet and dual-tree path, each
   public call with its own reset and reading of the counters, at 64x16384
   and 128x65536 float32: ``modwpt`` -> ``imodwpt`` sym8 depth 4 on the
   whole-tree route (one bank launch each way) and on the per-level route
   (one per level), every level against the plain route, the round trip
   against x, and under the default backend; a gradient through ``modwpt``
   on each route against the plain route; ``wpt`` -> ``iwpt`` (sym8, bior4.4
   and coif3; no kernel); ``dtcwt`` -> ``idtcwt`` sym8 5 levels on the
   whole-tree route, the per-stage route and under the default backend
   against the plain route; ``denoise_packet`` depth 4 and ``dtcwt_denoise``
   at 8x16384 against their plain routes; a small input against the float64
   plain cascade on the CPU; then the CWT path, each public call with its
   own reset and reading of the counters: ``cwt`` -> ``icwt`` morl periodic
   at config #5's single-card shape (one 2^20-sample row, 64 scales
   geomspace(2, 4096)) and at 128x65536 with 32 scales geomspace(2, 64),
   ``auto`` taking the kernel-direct tier for a whole call (one bank
   analysis launch, its output seen as [B, S, N]) or the FFT path, against
   the plain route; the equalized ``icwt`` of two in-band tones (float64
   normalised RMSE <= 1e-8, the float32 figure printed); the gradient
   through ``cwt``; 16 scales within the cap at 128x65536 on the tier under
   ``auto`` (one bank launch, no copy; its gradient one bank synthesis
   launch); ``modwt_based_icwt`` at 128x65536 (its first
   call calibrates on the card; every call one cascade synthesis launch);
   the zero-boundary rows at 8192 and 32768 samples, cmor and
   ``analytic=True`` on the FFT path, each also on 2x4096 against float64
   on the CPU; then the tiled CWT: ``cwt_tiled`` at config #5 over 4 and 8
   virtual shards of the card, zero and periodic, and ``cwt_tiled_2d`` on a
   2x4 host x chip mesh of the card, each within 2e-5 of the largest
   coefficient of the single-card ``cwt`` (no kernel launch); then what is
   built on the CWT, each call with its own reset and reading of the
   counters: ``wavelet_coherence`` (32 scales x 32768; 2048 samples against
   float64 on the CPU), ``extract_ridge`` (32 x 65536, the blocked Viterbi;
   on a 4096 cut the path's score against the CPU float64 Viterbi's),
   ``synchrosqueeze`` -> ``isst`` (32 x 16384: the scatter-add against the
   masked sum per bin, two in-band tones recovered), ``significant_power``
   (levels against float64 on the CPU) and ``coherence_significance`` (64
   surrogates, repeatable) at 32 x 32768, ``matching_pursuit`` (8 x 16384,
   mexh, 16 scales, 32 steps: planted atoms found), ``wavelet_sharpe_ratio``
   at 1x10240 and 512x4096 (one fused denoise launch, against the plain
   route), ``analyze_market`` on 10240 prices (one fused denoise launch),
   ``analyze_volatility``, ``crash_asymmetry`` and
   ``calculate_wavelet_indicators`` (one analysis launch) against float64 on
   the CPU, and ``analyze_ticks_incremental`` over 4096 ticks (the Haar
   detail against its closed form); then the streaming path, db4 J=6, 128 streams x
   8 blocks x 8192 float32, each block with its own reset and reading of the
   counters: ``StreamingTransform`` with the zero, symmetric and periodic
   boundaries (one analysis launch a block, the symmetric first block's with
   the head splice) against the plain whole-signal transform (each block's
   own for periodic), ``streaming_denoise_block_kernel`` (one denoise launch a block)
   against its plain version, ``streaming_denoise_blocks_kernel`` with the 8
   blocks (one launch, equal bit for bit to the 8 single steps),
   ``StreamingDenoiser`` under auto, ``SlidingStreamingTransform`` (512, one
   level, with no launch) and ``StreamIngest`` (512-tick frames, hop 407, on
   the C++ ring, 4 levels: one cascade analysis launch a drain) against the
   direct transform; then the tiled path, every mesh
   virtual shards on this card, each public call with its own reset and
   reading of the counters: ``modwt_multilevel_tiled`` ->
   ``imodwt_multilevel_tiled`` db4 J=6 at 128x65536 over 4 and 8 shards
   (one external-edge analysis launch and one external-halo synthesis
   launch for all shards, every plane within 2e-5 of the untiled
   ``modwt_multilevel``, round-trip RMSE <= 3e-7) and the exact tiled round
   trip on the same shape (one launch each way, RMSE of hi + lo <= 1e-10);
   the reference's fault shape (db4 J=8, 2x1024 over 8 shards: the periodic
   halo wraps twice) and a hop chain three shards deep (db20 J=6 over 64
   shards of 1024) against the untiled plain transform; config #4
   (``modwt_multilevel_sharded_batch`` 256x16384 db4 J=4 on a one-card mesh,
   equal to ``modwt_multilevel``); ``modwt_multilevel_multihost`` on a 2x4
   mesh; ``modwt2_multilevel_tiled`` -> ``imodwt2_multilevel_tiled`` db4 J=4
   at 8x2048x2048 over 4 row shards (the plain route) within 5e-5 of
   ``modwt2_multilevel``; the symmetric tiled round trip at 8x65536 (the
   plain route) against the untiled plain path; then the multi-process run
   of the host x chip layout: two ranks on this card over Gloo (children
   that re-run this script with ``--rank-worker``, a ``file://`` store in a
   temporary directory), each a row of four virtual shards of the card
   (``make_multihost_mesh(devices=[cuda:0] * 4)``, a ``{"host": 2, "chip":
   4}`` mesh) and rows 64r .. 64r+63 of a seeded 128x65536 batch, periodic,
   zero and symmetric, each direction with its own reset and reading of the
   counters in the rank (one external-edge analysis and one external-halo
   synthesis launch for periodic and zero, none for symmetric), every plane
   and the inverse of the same planes within 2e-5 of the one-process plain
   cascade, the periodic round trip's RMSE <= 3e-7, and no
   ``torch.distributed`` call during the transforms (the module's functions
   wrapped with counters after the mesh's one ``all_gather_object``); then,
   in the same ranks, the signal axis across them: ``make_mesh({"signal":
   8}, devices=[cuda:0] * 4)``, each rank all 128 rows and its 32768
   samples (``local_index``), config #2 periodic, zero and symmetric through
   ``modwt_multilevel_tiled`` -> ``imodwt_multilevel_tiled`` (one
   external-edge analysis and one external-halo synthesis launch a rank for
   periodic and zero, none for symmetric; every plane and the inverse within
   2e-5 of the one-process plain cascade, the periodic RMSE <= 3e-7), the
   tiled exact round trip (one launch each way, RMSE of hi + lo <= 1e-10)
   and ``cwt_tiled`` at config #5 (within 2e-5 of the largest coefficient of
   the one-card ``cwt``), each transform's ``batch_isend_irecv`` calls and
   bytes held to the halo arithmetic and to the exchange module's count, the
   halos staged through pinned host memory (Gloo); then an NCCL world of
   one, whose ``make_multihost_mesh()`` is ``{"host": 1,
   "chip": 1}`` and whose round trip equals the one-process facade bit for
   bit; a rank that fails, prints no result or runs past 120 s fails the
   phase, with its stderr's tail;
4. timing with CUDA events (3 warm-ups, median of 20 runs) of each kernel
   beside its plain version and one PyTorch library call that computes the
   same function (``F.conv1d`` with the composite filters; not for the
   denoise; ``F.conv2d`` with the outer products of a level's taps for the
   2-D kernels, which are timed at every level 1-6, with the sums of levels
   1-4 and 1-6 beside their bounds; the cascade analysis also in mirror
   mode), with the least time the card could take (bytes over 3.35 TB/s
   or operations over the peak rate, the larger), and of the public entry
   points (the 2-D ones, the fused denoise's backward and the probe's round
   trip at each precision included); the symmetric synthesis also at sym8
   J=4 (config #3's depth); the bank kernels at the sym8 depth-4
   tree and at one level-4 pair as ``modwpt`` calls it, for 64x16384 and
   128x65536, and ``dtcwt``'s whole-tree bank at 64x16384, and every route of ``modwpt`` + ``imodwpt`` (depths 2-5)
   and ``dtcwt`` + ``idtcwt`` at both shapes and at 1x1024 (the dual tree
   also at 64x65536), and the two denoisers at 8x16384; the external edge
   (library call: ``F.conv1d`` of the composite filters on ``[halo | x]``)
   and the stream mode at 128x65536, the streaming rows at 128 x 8 x 8192
   (block streaming zero and symmetric, the denoiser a step a block and 8
   blocks a launch), the sliding window's time a sample and the ring's and
   ``StreamIngest``'s Mticks/s (host clock); the external right halo
   (library call: ``F.conv1d`` of the composite filters on ``[plane |
   halo]``) and the exact pair's halos (the fp64 convolution) at 128x65536
   with a halo of the span, and the tiled round trip over 4 and 8 shards and
   the tiled exact round trip beside the untiled round trip; the CWT
   path's calls (config #5 and 128x65536 under ``auto``, the plain route and
   ``backend='kernel'``, ``icwt``, ``modwt_based_icwt``, the zero-boundary,
   cmor and analytic rows), the FFT path beside ``bench_full.py``'s floor
   model, ``auto`` against the plain route at config #5 and 128x65536 in
   three interleaved runs each (``auto`` at most 3% slower), the gate
   sweep on whole calls (16 scales with h from cap / 8 to each candidate
   cap 8 ... 512, the tier against the plain route five times in turns at
   1x2^20 and 128x65536, from which ``cwt.AUTO_KERNEL_DIRECT_MAX_HALF`` is
   set)
   and the bank pair on the tier's dense taps (config #5 under ``kernel``,
   config #5's scales and 16 scales at 128x65536 to the cap) beside their
   bound and ``F.conv1d`` with the scales as output channels; the tiled
   CWT's and the paths built on the CWT's calls of phase 3; the
   default-depth, analysis, optimisation and 2-D tree calls of phase 3
   (CUDA events and the host clock, with each call's launches); each rank's
   round trip of its 64 rows, alone on the card and with both ranks at once,
   and the NCCL world of one's (CUDA events in the rank, during phase 3),
   beside the one-process 2x4 mesh's and the untiled round trip at
   128x65536 and 64x65536.

5. the examples: every ``examples/torch/*.py`` on the card in this process
   (``runpy``, ``sys.argv = [name]``; ``multihost_demo`` in its
   single-process form), each with the launch counters set to 0 just before
   and read just after, printed as ``example <name>: <s> s, launches
   {...}``.  The 37 with a recording of their JAX counterpart
   (``tests/torch_examples_expected/``) are held to it by
   ``tools/example_figures.py``; the parallel tier's three print parity
   figures, held to float32's 1e-5.  An example that raises, a figure that
   misses, or an example of :data:`EXAMPLE_KERNELS` that launches none of a
   kernel named there fails the phase.  Its launches join the kernels' line.

Phase 3 ends with the default-depth MODWT and the 1-D analysis modules
(``analysis_path``), then the sparse solvers, the deconvolutions, the block
denoise, the decimated 2-D trees and the infrastructure
(``optimize_path``): ``inpaint`` db8 J=8 on 1x2^20 with 30% missing and 200
FISTA steps, ``bpdn`` db4 at 128x65536 (100 steps) and ``sparse_recover``
with a circular blur on 8x65536 (100 steps), each one cascade synthesis and
one cascade analysis launch a step beside the first analysis and the final
synthesis, against the same solve on the plain route; ``deconvolve`` sym8 at
128x65536 (31-tap blur, the cascade pair once each way) and ``deconvolve2``
sym8 at 8x2048x2048 (one 2-D launch a level each way and one for the noise
probe), in soft mode against the plain route; ``denoise_block`` db4 at
128x65536 (one launch each way) against the plain route; ``wpt2`` ->
``iwpt2``, ``best_basis_denoise2`` and ``denoise_packet2`` (256x256 and
8x2048x2048), ``dtcwt2`` -> ``idtcwt2`` (512x512 and 8x2048x2048) and
``dtcwt2_denoise``, with no launch, against an identity, a noise reduction
or float64 on the CPU at a 64x64 cut; ``inpaint2`` db4 J=4 on 1x512x512 (80
steps; its launches printed: the 2-D pair for the probe, the first analysis
and the last synthesis, each step's gradient on the plain 2-D cascade);
``cost_model.calibrate()`` on the card with the estimate before and after
(its store in a temporary directory), ``get_performance_info()``, a
``throughput_meter`` around a round trip and a ``profiler_trace``.

The last two lines are a JSON object with one entry per kernel (beside
the contract's keys, ``mirror_launches``: its launches in phases 2b, 2c,
2d, 2e, 2f and 2g) and the device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH, N, LEVELS, WAVELET = 128, 65536, 6, "db4"
#: float32 kernel vs plain version: both compute in fp32 and differ only in
#: summation order and fused multiply-adds, a few ulps of values of order 1.
TOL_F32 = 2e-5
#: bfloat16: both round the same fp32 values to bfloat16, so they may differ
#: by one bfloat16 ulp, at most 2^-7 of the largest output.
BF16_ULP = 2.0**-7
#: public round trip against x (the float32 tier's contract at this shape)
RT_RMSE, RT_MAX = 3e-7, 3e-6
#: exact kernels vs their plain versions, on hi + lo: both compute in fp64
#: and differ only in fused multiply-adds, for unit-variance data.
TOL_EXACT = 1e-13
#: the exact tier's round trip (BASELINE.json's parity bar), and its
#: symmetric and tiled transforms against the float64 plain cascade.
EXACT_RMSE, EXACT_SYM = 1e-10, 1e-12
#: swt_denoise, kernel path against plain path: soft shrinkage is continuous,
#: so thresholds a few ulps apart move the output by a few ulps of its scale.
TOL_SWT = 1e-4
#: the fused denoise's threshold gradient, a sum over 65536 samples per
#: signal and level: relative to its largest value.
TOL_DTH = 1e-3
#: the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s and
#: fp32 / fp64 FLOP/s outside the tensor cores, an FMA counted as 2 FLOP.
HBM_BPS, FP32_FLOPS, FP64_FLOPS = 3.35e12, 67e12, 34e12

KERNELS = {
    "modwt_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_analysis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:688",
    ),
    "modwt_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:910",
    ),
    "modwt_denoise": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_denoise.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:1338",
    ),
    "modwt_exact_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_exact_analysis.cu",
        "vectorwave_tpu/kernels/modwt_exact.py:241",
    ),
    "modwt_exact_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_exact_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_exact.py:386",
    ),
    "modwt_symmetric_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_symmetric_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_symmetric.py:261",
    ),
    "modwt_symmetric_adjoint": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_symmetric_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_symmetric.py:186",
    ),
    "modwt2_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt2_analysis.cu",
        "vectorwave_tpu/kernels/modwt2_pallas.py:161",
    ),
    "modwt2_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt2_synthesis.cu",
        "vectorwave_tpu/kernels/modwt2_pallas.py:423",
    ),
    "modwt_mxu_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_analysis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:267",
    ),
    "modwt_mxu_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:407",
    ),
    "modwt_bank_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_bank_analysis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:688",
    ),
    "modwt_bank_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_bank_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:910",
    ),
    # the streaming modes: rows of their own, each counted under its own
    # entry of the launch counters
    "modwt_analysis_external": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_analysis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:688",
    ),
    "modwt_denoise_stream": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_denoise.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:1338",
    ),
    # the tiled tier's external halos: rows of their own, each counted under
    # its own entry of the launch counters
    "modwt_synthesis_external": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:910",
    ),
    "modwt_exact_analysis_halo": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_exact_analysis.cu",
        "vectorwave_tpu/kernels/modwt_exact.py:241",
    ),
    "modwt_exact_synthesis_halo": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_exact_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_exact.py:386",
    ),
}
#: each mode's row and the kernel it launches (``modwt_composite.LAUNCHES``
#: counts a mode's launches under the mode's own entry)
MODE_OF = {"modwt_analysis_external": "modwt_analysis",
           "modwt_synthesis_external": "modwt_synthesis",
           "modwt_denoise_stream": "modwt_denoise",
           "modwt_exact_analysis_halo": "modwt_exact_analysis",
           "modwt_exact_synthesis_halo": "modwt_exact_synthesis"}
MAIN_PATH = ("modwt_analysis", "modwt_synthesis", "modwt_denoise")
EXACT_PATH = ("modwt_exact_analysis", "modwt_exact_synthesis")
SYMMETRIC_PATH = ("modwt_mxu_analysis", "modwt_symmetric_synthesis",
                  "modwt_symmetric_adjoint")
MXU_PATH = ("modwt_mxu_analysis", "modwt_mxu_synthesis")
BANK_PATH = ("modwt_bank_analysis", "modwt_bank_synthesis")
BF16_ROWS = (MAIN_PATH + ("modwt_symmetric_synthesis", "modwt_symmetric_adjoint") + MXU_PATH
             + BANK_PATH + ("modwt_analysis_external", "modwt_synthesis_external"))
#: the packet and dual-tree path: sym8, packet depth 4, 5 DTCWT levels, at the
#: batch shape of the JAX package's bench rows and at the main path's
PACKET_WAVELET, PACKET_DEPTH, DTCWT_LEVELS = "sym8", 4, 5
PACKET_SHAPES = ((64, 16384), (BATCH, N))
#: bank routes against the plain route: the whole tree composes up to 5
#: stages into one fp32 filter (3e-5, the JAX package's DTCWT kernel bound)
TOL_DTCWT = 3e-5
#: a gradient through the bank against the plain route, of its largest entry
TOL_BANK_GRAD = 5e-6
#: the adjoint identity, relative
TOL_ADJOINT = 1e-5
#: the tile tools/perf_probe_mxu.py passes the TPU pair; a layout hint that
#: the port's wrappers accept and ignore
PROBE_TILE = 8192
TWOD_PATH = ("modwt2_analysis", "modwt2_synthesis")
#: the 2-D path's images (the TPU bench's 2-D shape) and its round-trip bound
#: (the JAX package's 2-D kernel test bound, tests/test_modwt2_pallas.py).
IMG = (8, 2048, 2048)
RT2_MAX = 5e-5
#: the streaming path (the JAX package's bench rows, bench_full.py:230-268):
#: 128 streams x 8 blocks x 8192 samples, db4 J=6, float32; the sliding
#: window and the ingest frames of bench_full.py:333-380 (512 samples, the
#: ingest's hop 407 = 512 - (L-1)(2^4-1), so 4 levels)
STREAM_B, STREAM_NBLK, STREAM_BLK = 128, 8, 8192
SLIDE_BUFFER, INGEST_LEVELS = 512, 4
#: the tiled path: virtual shards of the main path's signals on one card
TILED_SHARDS = (4, 8)
#: the multi-process run of the host x chip layout: MP_RANKS ranks on this
#: card over Gloo (NCCL takes one rank a card), each a row of MP_CHIPS
#: virtual shards and BATCH // MP_RANKS rows of the seeded global batch; a
#: child past MP_TIMEOUT seconds is killed and fails the phase
MP_RANKS, MP_CHIPS, MP_TIMEOUT, MP_SEED = 2, 4, 120, SEED + 19
MP_BOUNDARIES = ("periodic", "zero", "symmetric")
RANK_WORKER = "--rank-worker"
#: torch.distributed's functions that talk to another rank
COLLECTIVES = (
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce", "all_to_all",
    "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "irecv", "isend", "monitored_barrier", "recv",
    "recv_object_list", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "send", "send_object_list",
)
#: the CWT path: config #5's single-card shape (bench_full.py:206-209: morl,
#: 64 scales geomspace(2, 4096), one 2^20-sample float32 signal, periodic) and
#: the main path's batch with the TPU bench's 32 scales geomspace(2, 64)
#: (bench_full.py:138-145, whose 8192- and 32768-sample rows run the zero
#: boundary)
CWT_WAVELET, CFG5_N = "morl", 1 << 20
CFG5_SCALES = tuple(np.geomspace(2.0, 4096.0, 64).tolist())
MAIN_SCALES = tuple(np.geomspace(2.0, 64.0, 32).tolist())
#: the kernel-direct tier against its plain version and the FFT path, of the
#: largest coefficient (the JAX package's bound, tests/test_cwt_kernel_direct.py)
TOL_CWT = 2e-5
#: the equalized icwt's normalised RMSE on in-band tones in float64 (the JAX
#: package's bound, tests/test_cwt.py)
ICWT_NRMSE_F64 = 1e-8
#: what is built on the CWT, float32 on the card against float64 on the CPU
#: (a small input): coherence and the volatility and indicator series are
#: ratios of float32 FFT sums, a few float32 ulps apart, of their largest value
TOL_XWT = 1e-4
#: the ridge's path score, relative: the card's float32 Viterbi against the
#: CPU's float64 one on the same field
TOL_RIDGE = 1e-5
#: the significance levels are computed in float64 on the card
TOL_LEVELS = 1e-10
#: Sharpe ratios and crash asymmetry of the kernel route against the plain
#: route, relative (a mean over a std of outputs 2e-5 apart)
TOL_SHARPE = 1e-4
#: isst of two in-band tones away from the edges, beyond icwt's error on the
#: same CWT (the JAX package's bound, tests/test_sst.py)
SST_OVER_ICWT = 0.02
#: wavelet coherence, float32 on the card against float64 on the CPU, of its
#: largest value (1): a ratio of smoothed powers, whose float32 rounding grows
#: where the powers are small (9e-5 at 2048 samples on the CPU)
TOL_COH = 1e-3
#: the gate sweep's candidate caps on the half-support (morl: h = 4 s)
CWT_GATE_CAPS = (8, 16, 32, 64, 128, 256, 512)
#: how much slower than the plain route ``auto``'s cwt may be at config #5
#: and the main batch (timing noise between two runs of one route)
AUTO_SLOWER = 0.03
AUTO_PAIRS = 10
#: runs of each route at each candidate cap of the gate sweep
SWEEP_RUNS = 5
#: the default-depth MODWT calls (no levels: max_levels stops at 9) and db4
#: J=10, which the gate refused while it asked for the fused denoise's room
DEFAULT_DEPTH_CASES = (("db4", None), ("sym8", None), ("db4", 10))
#: the TPU bench's long row (BENCH_BEYOND.json: wavelet_variance and
#: multifractal_spectrum at 1M samples) and the variance step's position
LONG_N, VAR_STEP = 1 << 20, 40000
#: the analysis modules on the card against the plain route or float64 on the
#: CPU: float32 sums of up to 65536 terms, relative to the value
TOL_VAR = 1e-4
EWT_BOUNDS = (0.05, 0.15, 0.35)
#: cwt2's grid: scales 2.5-30 (the in-band round trip's of tests/test_cwt2.py)
#: and 8 angles over [0, pi)
CWT2_SCALES_256 = tuple(np.geomspace(2.5, 30.0, 8).tolist())
CWT2_SCALES_1K = tuple(np.geomspace(2.5, 30.0, 16).tolist())
CWT2_ANGLES = tuple(np.linspace(0.0, math.pi, 8, endpoint=False).tolist())
#: the sparse solvers, the deconvolutions and the 2-D trees: the TPU bench's
#: inpaint row (tools/perf_beyond2.py:168-181: db8, 2^20 samples, 30% missing,
#: 200 steps), the main path's batch for bpdn, the deconvolution and the
#: block denoise, a 31-tap blur, 8x65536 for sparse_recover and the 2-D
#: inpaint of tests/test_sparse.py at 512x512
OPT_LONG, OPT_MISSING, OPT_STEPS = 1 << 20, 0.3, 200
OPT_BPDN_STEPS, OPT_BLUR_TAPS = 100, 31
OPT_2D_LEVELS, OPT_2D_STEPS = 4, 80
#: a FISTA solve on the kernels against the same solve on the plain route,
#: of the largest value: both run K steps of a nonexpansive float32 iteration
#: whose gradient differs between the routes by float32 rounding (2e-5 a
#: pass); momentum may amplify it a few times over the steps
TOL_FISTA_CARD = 1e-4
#: a one-pass pipeline (deconvolution in soft mode) on the kernels against
#: the plain route, of the largest value
TOL_F32_REL = 2e-5
#: block shrinkage's factor is 1 - c / S_b, S_b a float32 sum over a window:
#: the routes' planes 2e-5 apart move it by a few float32 ulps of S_b
TOL_BLOCK_CARD = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def gap_thresholds(planes, levels):
    """[B, J] thresholds, each in the widest gap between consecutive sorted
    |d| values between the 50th and 95th percentile of its (signal, level):
    fp32 summation-order differences between two implementations cannot
    then flip a hard-threshold decision."""
    cols = []
    for j in range(levels):
        s = torch.sort(planes[j].abs().float(), dim=-1).values
        n = s.shape[-1]
        lo, hi = n // 2, max(int(0.95 * n), n // 2 + 2)
        i = torch.argmax(s[:, lo + 1 : hi] - s[:, lo : hi - 1], dim=-1, keepdim=True) + lo
        cols.append((torch.gather(s, 1, i) + torch.gather(s, 1, i + 1)) / 2)
    return torch.cat(cols, dim=1).contiguous()


def max_err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def pair_err(got, want) -> float:
    """Max |hi + lo - (hi' + lo')| over plane pairs, combined in float64."""
    return max((g[0].double() + g[1].double() - w[0].double() - w[1].double())
               .abs().max().item() for g, w in zip(got, want))


def composite_bank(filters, levels, device, dtype):
    """The [J+1, span+1] causal composite filters, reversed for conv1d (a
    correlation), as one tensor."""
    import numpy as np
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    comps = mc.composite_plane_filters(np.array(filters[0]), np.array(filters[1]), levels)
    k = max(len(c) for c in comps)
    bank = np.zeros((len(comps), k))
    for i, c in enumerate(comps):
        bank[i, k - len(c):] = c[::-1]
    return torch.tensor(bank, dtype=dtype, device=device)


def symmetric_bank(filters, ops, device):
    """The rebased composed symmetric filters [J+1, K] (zero-padded to one
    length) and G: out[t] = sum_p sum_tau f'_p[tau] plane_p[t + tau - G]."""
    from vectorwave_tpu_torch.kernels.modwt_symmetric import _rebase, plane_filters

    dense, g, d_max = _rebase(plane_filters(filters, ops))
    k = max(len(f) for f in dense)
    bank = torch.zeros(len(dense), k, device=device)
    for i, f in enumerate(dense):
        bank[i, : len(f)] = torch.tensor(f, device=device)
    return bank, g, d_max


class routed:
    """Run the packet or dual-tree entry points on one named route: ``tree``
    (the whole tree in one bank launch: backend ``kernel``), ``level`` (one
    bank pair per level: backend ``auto`` with the whole-tree route switched
    off), ``plain`` (backend ``torch``) or ``default`` (backend ``auto`` as
    the package ships: it chooses between the two bank routes)."""

    def __init__(self, route: str):
        self.route = route

    def __enter__(self):
        import vectorwave_tpu_torch as vt
        from vectorwave_tpu_torch.transforms import dtcwt as td
        from vectorwave_tpu_torch.transforms import packets as tp

        self.saved = (tp.AUTO_TREE_MAX_WORK, td.AUTO_WHOLE_TREE_MAX_WORK)
        vt.set_backend({"tree": "kernel", "plain": "torch"}.get(self.route, "auto"))
        if self.route == "level":
            tp.AUTO_TREE_MAX_WORK, td.AUTO_WHOLE_TREE_MAX_WORK = 0, 0

    def __exit__(self, *exc):
        import vectorwave_tpu_torch as vt
        from vectorwave_tpu_torch.transforms import dtcwt as td
        from vectorwave_tpu_torch.transforms import packets as tp

        tp.AUTO_TREE_MAX_WORK, td.AUTO_WHOLE_TREE_MAX_WORK = self.saved
        vt.set_backend("auto")


def bank_kernels_against_plain(dev, gen, worst, worst_bf16):
    """Phase 2 for the filter-bank pair: each kernel against its plain
    version, and the adjoint identity for each edge."""
    import numpy as np
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.transforms import dtcwt as td
    from vectorwave_tpu_torch.transforms import packets as tp

    rng = np.random.default_rng(SEED)
    # random dense taps, scaled so that the outputs are of the order of x
    random_dense = tuple(tuple((rng.standard_normal(k) / math.sqrt(k)).tolist())
                         for k in (1, 37, 300))
    # a span past the widest that takes two synthesis window buffers: one
    far = np.zeros(30001)
    far[[0, 3, 30000]] = rng.standard_normal(3) / math.sqrt(3)
    wide = (tuple(far.tolist()), tuple((rng.standard_normal(13) / math.sqrt(13)).tolist()))
    assert mb.synthesis_stages(30000) == 1 and mb.synthesis_stages(300) == 2
    w = vt.wavelet(PACKET_WAVELET)
    pair16 = tp._pair_dense(w.dec_lo / math.sqrt(2.0), w.dec_hi / math.sqrt(2.0), 16)
    dual, _ = td._dual_tree_bank(w, DTCWT_LEVELS)
    dual_half, _ = td._dual_tree_bank(w, DTCWT_LEVELS, 0.5)
    # (label, analysis taps, synthesis taps or None for the same, planes the
    #  synthesis reads (a slice of the analysis output), batch, n, edges, dtype)
    cases = [
        ("random taps 1/37/300", random_dense, None, slice(None), 3, 5000,
         ("periodic", "zero"), torch.float32),
        ("random taps 1/37/300", random_dense, None, slice(None), 2, 301,
         ("periodic", "zero"), torch.float32),
        ("random taps 1/37/300, span >= N", random_dense, None, slice(None), 2, 150,
         ("periodic",), torch.float32),
        ("random taps 1/37/300", random_dense, None, slice(None), 3, 5000,
         ("periodic",), torch.bfloat16),
        ("sym8 pair at spacing 16", pair16, None, slice(None), 4, 4096,
         ("periodic", "zero"), torch.float32),
        ("span 30000, one synthesis buffer", wide, None, slice(None), 2, 4096,
         ("periodic", "zero"), torch.float32),
    ]
    for depth in (PACKET_DEPTH, 5):
        cases.append((f"sym8 depth-{depth} tree ({(2 << depth) - 2} planes)",
                      tp._tree_dense(w, depth, dec=True), tp._tree_dense(w, depth, dec=False),
                      slice(-(1 << depth), None), 2, 8192, ("periodic", "zero"),
                      torch.float32))
    # the packet path's shape (the last of 8 tiles a row holds 256 outputs)
    # and the tree in bfloat16
    tree4 = (tp._tree_dense(w, PACKET_DEPTH, dec=True), tp._tree_dense(w, PACKET_DEPTH, False))
    cases += [(f"sym8 depth-{PACKET_DEPTH} tree", *tree4, slice(-(1 << PACKET_DEPTH), None),
               *PACKET_SHAPES[0], ("periodic",), torch.float32),
              (f"sym8 depth-{PACKET_DEPTH} tree", *tree4, slice(-(1 << PACKET_DEPTH), None),
               2, 8192, ("periodic",), torch.bfloat16)]
    cases.append((f"sym8 dual tree, {DTCWT_LEVELS} levels ({len(dual)} planes)", dual,
                  dual_half, slice(None), 2, 8192, ("periodic",), torch.float32))
    for label, dense, dense_syn, pick, b, n, edges, dtype in cases:
        dense_syn = dense if dense_syn is None else dense_syn
        for edge in edges:
            periodic = edge == "periodic"
            x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
            before = dict(mc.LAUNCHES)
            want = mb.bank_analysis_plain(x, dense, periodic)
            got = mb.bank_analysis(x, dense, periodic)
            planes = tuple(want[pick])
            y_want = mb.bank_synthesis_plain(planes, dense_syn, periodic)
            y_got = mb.bank_synthesis(planes, dense_syn, periodic)
            torch.cuda.synchronize()
            launched = {k: mc.LAUNCHES[k] - before[k] for k in BANK_PATH}
            check(launched == dict.fromkeys(BANK_PATH, 1),
                  f"a CUDA tensor launches the bank kernels: {launched}")
            tag = f"{label} {b}x{n} {edge} {str(dtype)[6:]}"
            for kname, g, p in (("modwt_bank_analysis", got, want),
                                ("modwt_bank_synthesis", (y_got,), (y_want,))):
                err = max(max_err(a, c) for a, c in zip(g, p))
                if dtype == torch.float32:
                    tol = TOL_F32
                    worst[kname] = max(worst[kname], err)
                else:
                    tol = BF16_ULP * max(c.float().abs().max().item() for c in p)
                    worst_bf16[kname] = max(worst_bf16[kname], err)
                check(err <= tol, f"{kname} {tag}: max |kernel - plain| {err:.3e} <= "
                                  f"{tol:.3e}")
            if dtype == torch.float32 and dense_syn is dense:
                # <A x, y> = <x, A^T y>, both sides from the kernels, in float64
                ys = [torch.randn(b, n, device=dev, generator=gen) for _ in dense]
                lhs = sum((a.double() * c.double()).sum() for a, c in zip(got, ys)).item()
                rhs = (x.double() * mb.bank_synthesis(tuple(ys), dense, periodic).double()
                       ).sum().item()
                rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
                check(rel <= TOL_ADJOINT, f"adjoint identity {tag}: |<Ax,y> - <x,A'y>| "
                                          f"{rel:.3e} <= {TOL_ADJOINT:.0e} relative")


def packet_path(dev, gen):
    """Phase 3 for the packet and dual-tree family.  Returns the bank kernels'
    launches, summed over the public calls (each with its own reset)."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    total = dict.fromkeys(BANK_PATH, 0)

    def counted(label, expect, fn):
        """Run fn with the counters set to 0 just before and read just after;
        ``expect`` None accepts any count above 0 of both bank kernels."""
        mc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == expect if expect is not None else
              (set(got) <= set(BANK_PATH) and len(got) >= 1), f"{label}: launches {got}")
        for k in BANK_PATH:
            total[k] += got.get(k, 0)
        return out

    name, depth, levels = PACKET_WAVELET, PACKET_DEPTH, DTCWT_LEVELS

    def coeffs(res):
        return (*res.highpasses, res.lowpass_a, res.lowpass_b)

    for b, n in PACKET_SHAPES:
        x = torch.randn(b, n, device=dev, generator=gen)
        scale = x.abs().max().item()
        with routed("plain"):
            ref = counted(f"modwpt plain route {b}x{n}", {},
                          lambda: vt.modwpt(x, name, depth))
        for route, each in (("tree", 1), ("level", depth), ("default", None)):
            with routed(route):
                tree = counted(f"modwpt {name} depth {depth} {b}x{n}, {route} route",
                               None if each is None else {"modwt_bank_analysis": each},
                               lambda: vt.modwpt(x, name, depth))
                y = counted(f"imodwpt {name} depth {depth} {b}x{n}, {route} route",
                            None if each is None else {"modwt_bank_synthesis": each},
                            lambda: vt.imodwpt(tree, name))
            err = max(max_err(g, r) for g, r in zip(tree.levels, ref.levels))
            check(tree.leaves.shape == (b, 1 << depth, n) and err <= TOL_F32
                  and max_err(y, x) <= TOL_F32 * scale,
                  f"modwpt {b}x{n} {route} route: every level vs plain route {err:.3e} <= "
                  f"{TOL_F32:.0e}, round trip {max_err(y, x):.3e} <= {TOL_F32 * scale:.3e}")
            del tree, y
        del ref
        for wname in (name, "bior4.4", "coif3") if b == PACKET_SHAPES[0][0] else (name,):
            y = counted(f"wpt -> iwpt {wname} depth {depth} {b}x{n} (no kernel)", {},
                        lambda: vt.iwpt(vt.wpt(x, wname, depth), wname))
            check(y.device == x.device and max_err(y, x) <= TOL_F32 * scale,
                  f"wpt round trip {wname} {b}x{n} on {y.device}: {max_err(y, x):.3e} <= "
                  f"{TOL_F32 * scale:.3e}")
        with routed("plain"):
            ref = counted(f"dtcwt plain route {b}x{n}", {},
                          lambda: vt.dtcwt(x, name, levels=levels))
        for route, each in (("tree", 1), ("level", 2 * levels), ("default", None)):
            with routed(route):
                res = counted(f"dtcwt {name} {levels} levels {b}x{n}, {route} route",
                              None if each is None else {"modwt_bank_analysis": each},
                              lambda: vt.dtcwt(x, name, levels=levels))
                y = counted(f"idtcwt {name} {levels} levels {b}x{n}, {route} route",
                            None if each is None else {"modwt_bank_synthesis": each},
                            lambda: vt.idtcwt(res, name))
            err = max((g - r).abs().max().item() for g, r in zip(coeffs(res), coeffs(ref)))
            check(res.highpasses[0].dtype == torch.complex64 and err <= TOL_DTCWT
                  and max_err(y, x) <= TOL_DTCWT * scale,
                  f"dtcwt {b}x{n} {route} route: coefficients vs plain route {err:.3e} <= "
                  f"{TOL_DTCWT:.0e}, round trip {max_err(y, x):.3e} <= "
                  f"{TOL_DTCWT * scale:.3e}")
            del res, y
        del ref

    b, n = PACKET_SHAPES[0]
    xg = torch.randn(b, n, device=dev, generator=gen).requires_grad_(True)
    grads = {}
    for route, expect in (("plain", {}),
                          ("tree", {"modwt_bank_analysis": 1, "modwt_bank_synthesis": 1}),
                          ("level", {"modwt_bank_analysis": depth,
                                     "modwt_bank_synthesis": depth})):
        with routed(route):
            grads[route] = counted(
                f"gradient through modwpt {b}x{n}, {route} route", expect,
                lambda: torch.autograd.grad(
                    (vt.modwpt(xg, name, depth).leaves ** 2).sum(), xg)[0])
    top = grads["plain"].abs().max().item()
    for route in ("tree", "level"):
        err = max_err(grads[route], grads["plain"])
        check(err <= TOL_BANK_GRAD * top,
              f"gradient through modwpt, {route} route vs plain route: {err:.3e} <= "
              f"{TOL_BANK_GRAD * top:.3e}")

    t = torch.arange(16384, device=dev, dtype=torch.float32)
    noisy = (torch.sin(2 * math.pi * 0.41 * t) + torch.sin(2 * math.pi * t / 64.0)
             + 0.3 * torch.randn(8, 16384, device=dev, generator=gen)).contiguous()
    for label, fn in (
        (f"denoise_packet {name} depth {depth}", lambda: vt.denoise_packet(noisy, name, depth)),
        (f"dtcwt_denoise {name} {levels} levels",
         lambda: vt.dtcwt_denoise(noisy, name, levels=levels)),
    ):
        got = counted(f"{label} 8x16384", None, fn)
        with routed("plain"):
            want = fn()
        check(got.shape == noisy.shape and bool(torch.isfinite(got).all())
              and max_err(got, want) <= TOL_SWT,
              f"{label} 8x16384 vs plain route: {max_err(got, want):.3e} <= {TOL_SWT:.0e}")

    small = torch.randn(4, 1024, device=dev, generator=gen)
    with routed("plain"):
        ref_tree = vt.modwpt(small.cpu().double(), name, 3)
        ref_res = vt.dtcwt(small.cpu().double(), name, levels=3)
    for route in ("tree", "level"):
        with routed(route):
            tree = vt.modwpt(small, name, 3)
            res = vt.dtcwt(small, name, levels=3)
        err = max(max_err(g.cpu(), r) for g, r in zip(tree.levels, ref_tree.levels))
        err_d = max((g.cpu() - r).abs().max().item()
                    for g, r in zip(coeffs(res), coeffs(ref_res)))
        check(err <= TOL_F32 and err_d <= TOL_DTCWT,
              f"4x1024 {route} route vs float64 CPU cascade: modwpt {err:.3e}, dtcwt "
              f"{err_d:.3e}")
    print(f"  launches during the packet and dual-tree path: {total}", flush=True)
    for k in BANK_PATH:
        check(total[k] > 0, f"{k} launched {total[k]} times")
    return total


def bank_timing(dev, gen):
    """Phase 4 for the filter-bank pair and the entry points above it.
    Returns ({kernel: (ms, plain ms, library ms)}, {kernel: (bound ms, by)},
    {kernel: [the other timed cases]}) with the depth-4 tree at the main
    path's shape as each kernel's row."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.transforms import dtcwt as td
    from vectorwave_tpu_torch.transforms import packets as tp

    w = vt.wavelet(PACKET_WAVELET)
    depth = PACKET_DEPTH
    low, high = w.dec_lo / math.sqrt(2.0), w.dec_hi / math.sqrt(2.0)
    spacing = 1 << (depth - 1)
    tree_a, tree_s = tp._tree_dense(w, depth, dec=True), tp._tree_dense(w, depth, dec=False)
    pair = tp._pair_dense(low, high, spacing)

    def weight(dense):
        """[P, span+1] taps (zero-padded to one length) on the card."""
        k = max(len(f) for f in dense)
        bank = torch.zeros(len(dense), k, device=dev)
        for i, f in enumerate(dense):
            bank[i, : len(f)] = torch.tensor(f, device=dev)
        return bank

    dual_a = td._dual_tree_bank(w, DTCWT_LEVELS)[0]
    dual_s = td._dual_tree_bank(w, DTCWT_LEVELS, 0.5)[0]
    ms_of, bound, cases = {}, {}, {k: [] for k in BANK_PATH}
    for b, n in PACKET_SHAPES:
        for label, dense_a, dense_s, rows, dil in (
            (f"sym8 depth-{depth} tree", tree_a, tree_s, b, 1),
            # a level of modwpt: its 2^(depth-1) nodes ride the batch axis
            (f"sym8 level-{depth} pair", pair, pair, b * (1 << (depth - 1)), spacing),
            # dtcwt's whole-tree bank (both trees' composed planes), as the
            # default route takes it at this shape
        ) + (((f"sym8 dtcwt {DTCWT_LEVELS}-level whole tree", dual_a, dual_s, b, 1),)
             if (b, n) == PACKET_SHAPES[0] else ()):
            x = torch.randn(rows, n, device=dev, generator=gen)
            planes = mb.bank_analysis(x, dense_a, True)[-len(dense_s):]
            stacked = torch.stack(planes, dim=1)
            # one library call: the taps reversed for the analysis (conv1d
            # correlates), the pair's 16 taps at dilation 2^(j-1)
            wa = weight(tuple(f[::dil] for f in dense_a))
            ws = weight(tuple(f[::dil] for f in dense_s))
            span = dil * (wa.shape[1] - 1)
            wa_rev = wa.flip(-1)[:, None].contiguous()
            calls = {
                "modwt_bank_analysis": (
                    dense_a,
                    lambda: mb.bank_analysis(x, dense_a, True),
                    lambda: mb.bank_analysis_plain(x, dense_a, True),
                    lambda: F.conv1d(F.pad(x[:, None], (span, 0), mode="circular"), wa_rev,
                                     dilation=dil)),
                "modwt_bank_synthesis": (
                    dense_s,
                    lambda: mb.bank_synthesis(planes, dense_s, True),
                    lambda: mb.bank_synthesis_plain(planes, dense_s, True),
                    lambda: F.conv1d(F.pad(stacked, (0, span), mode="circular"), ws[None],
                                     dilation=dil)),
            }
            lib_err = max(
                max_err(calls["modwt_bank_analysis"][3]()[:, -1],
                        calls["modwt_bank_analysis"][1]()[-1]),
                max_err(calls["modwt_bank_synthesis"][3]()[:, 0],
                        calls["modwt_bank_synthesis"][1]()))
            check(lib_err <= 1e-4, f"{label} {rows}x{n}: F.conv1d computes the bank "
                                   f"kernels' function ({lib_err:.3e})")
            for kname, (dense, kernel, plain, library_call) in calls.items():
                taps = mb.bank_taps(dense)
                samples = rows * n
                t_bytes = samples * 4 * (1 + taps.planes) / HBM_BPS * 1e3
                t_ops = samples * taps.nonzeros * 2 / FP32_FLOPS * 1e3
                by = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
                times = (median_ms(kernel), median_ms(plain, 1, 5), median_ms(library_call))
                if "tree" in label and (b, n) == PACKET_SHAPES[-1]:
                    ms_of[kname], bound[kname] = times, by
                else:
                    cases[kname].append({
                        "case": f"{label} {rows}x{n}", "ms": times[0], "plain_ms": times[1],
                        "library_ms": times[2], "bound_ms": by[0], "bound_by": by[1]})
                print(f"  {kname} {label} {rows}x{n} ({taps.planes} planes, "
                      f"{taps.nonzeros} taps): kernel {times[0]:.4f} ms "
                      f"({2e-9 * samples * taps.nonzeros / times[0]:.2f} TFLOP/s, "
                      f"{4e-6 * samples * (1 + taps.planes) / times[0]:.1f} GB/s), plain "
                      f"{times[1]:.4f} ms, library {times[2]:.4f} ms, bound {by[0]:.4f} ms "
                      f"({by[1]}; {100 * by[0] / times[0]:.1f}% of it)", flush=True)
            del x, planes, stacked, calls

    name = PACKET_WAVELET
    routes = ("tree", "level", "plain", "default")
    for b, n in ((1, 1024),) + PACKET_SHAPES:
        x = torch.randn(b, n, device=dev, generator=gen)
        for d in (2, 3, 4, 5):
            for route in routes:
                with routed(route):
                    t_ms = median_ms(lambda: vt.imodwpt(vt.modwpt(x, name, d), name), 2, 10)
                print(f"  modwpt + imodwpt {name} depth {d} {b}x{n}, {route} route: "
                      f"{t_ms:.4f} ms ({b * n / t_ms / 1e3:.1f} Msamples/s)", flush=True)
        del x
    # the dual tree also between the two shapes, where its bank routes cross
    for b, n in ((1, 1024), PACKET_SHAPES[0], (64, 65536), PACKET_SHAPES[1]):
        x = torch.randn(b, n, device=dev, generator=gen)
        for route in routes:
            with routed(route):
                t_ms = median_ms(lambda: vt.idtcwt(
                    vt.dtcwt(x, name, levels=DTCWT_LEVELS), name), 2, 10)
            print(f"  dtcwt + idtcwt {name} {DTCWT_LEVELS} levels {b}x{n}, {route} route: "
                  f"{t_ms:.4f} ms ({b * n / t_ms / 1e3:.1f} Msamples/s)", flush=True)
        del x
    noisy = torch.randn(8, 16384, device=dev, generator=gen)
    for label, fn in (
        (f"denoise_packet depth {depth}", lambda: vt.denoise_packet(noisy, name, depth)),
        (f"dtcwt_denoise {DTCWT_LEVELS} levels",
         lambda: vt.dtcwt_denoise(noisy, name, levels=DTCWT_LEVELS)),
    ):
        for route in ("default", "plain"):
            with routed(route):
                t_ms = median_ms(fn, 2, 10)
            print(f"  {label} 8x16384, {route} route: {t_ms:.4f} ms", flush=True)
    return ms_of, bound, cases


class backend:
    """Run the public entry points under one backend (``kernel``: the CWT's
    kernel-direct tier to h = 2048; ``torch``: the plain route), then back to
    ``auto``."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import vectorwave_tpu_torch as vt

        vt.set_backend(self.name)

    def __exit__(self, *exc):
        import vectorwave_tpu_torch as vt

        vt.set_backend("auto")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float64 (complex128 for complex)."""
    dt = torch.complex128 if want.is_complex() else torch.float64
    return ((got.to(dt) - want.to(dt)).abs().max() / want.to(dt).abs().max()).item()


def cwt_scales(count, lo, hi):
    return tuple(np.geomspace(lo, hi, count).tolist())


def tier_bank_calls(x, scales, name=None):
    """The kernel-direct tier's bank calls for ``scales`` on ``[B, N]`` ``x``,
    one a chunk: (x rolled by -maxhalf, the chunk's dense taps)."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.transforms import cwt as tc

    w = vt.wavelet(name or CWT_WAVELET)
    return [(torch.roll(x, -maxhalf, dims=-1), dense)
            for maxhalf, dense in tc._kernel_direct_chunks(w, tuple(scales))]


def cwt_kernels_against_plain(dev, gen, worst):
    """Phase 2 for the CWT's kernel-direct tier: the bank analysis with the
    tier's dense taps against its plain version, the whole tier against the
    FFT path, and its gradient (the bank synthesis with dense taps) against
    autograd through the plain version."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.transforms import cwt as tc

    # (label, wavelet, batch, n, scales); morl's scales ascend to h = 2048 (s = 512)
    cases = [
        ("config #5's row, h 8-2048", CWT_WAVELET, 1, CFG5_N, cwt_scales(24, 2.0, 512.0)),
        ("the main batch, h 8-2048", CWT_WAVELET, BATCH, N, cwt_scales(12, 2.0, 512.0)),
        ("ragged", CWT_WAVELET, 3, 5000, cwt_scales(8, 2.0, 256.0)),
        ("a span past N, h 16-2048", CWT_WAVELET, 2, 300, (4.0, 100.0, 512.0)),
        ("mexh", "mexh", 4, 65536, cwt_scales(8, 1.0, 128.0)),
    ]
    for label, name, b, n, scales in cases:
        x = torch.randn(b, n, device=dev, generator=gen)
        tag = f"{label}, {name} {b}x{n}, {len(scales)} scales"
        w = vt.wavelet(name)
        for xr, dense in tier_bank_calls(x, scales, name):
            before = mc.LAUNCHES["modwt_bank_analysis"]
            got = mb.bank_analysis(xr, dense, True)
            want = mb.bank_analysis_plain(xr, dense, True)
            torch.cuda.synchronize()
            check(mc.LAUNCHES["modwt_bank_analysis"] - before == 1,
                  f"{tag}: one bank analysis launch a chunk")
            top = max(p.abs().max().item() for p in want)
            err = max(max_err(g, p) for g, p in zip(got, want))
            worst["modwt_bank_analysis"] = max(worst["modwt_bank_analysis"], err)
            check(err <= TOL_CWT * top, f"modwt_bank_analysis on the tier's dense taps, {tag}:"
                                        f" max |kernel - plain| {err:.3e} <= "
                                        f"{TOL_CWT * top:.3e}")
            del got, want
        # every row under kernel is the FFT path's, past N too: both sum
        # the taps that wrap onto one slot
        with backend("kernel"):
            tier = vt.cwt(x, scales, name, boundary="periodic").coeffs
        with backend("torch"):
            ref = vt.cwt(x, scales, name, boundary="periodic").coeffs
        err = rel_err(tier, ref)
        check(tier.shape == (b, len(scales), n) and err <= TOL_CWT,
              f"cwt kernel-direct tier, {tag}: vs the FFT path {err:.3e} <= {TOL_CWT:.0e} "
              "of max")
        del tier, ref
    # the gradient: the tier's backward is the bank synthesis with the same
    # dense taps, one launch a chunk
    b, n, scales = 4, 65536, cwt_scales(12, 2.0, 512.0)
    x = torch.randn(b, n, device=dev, generator=gen).requires_grad_(True)
    wts = torch.randn(b, len(scales), n, device=dev, generator=gen)
    with backend("kernel"):
        before = mc.LAUNCHES["modwt_bank_synthesis"]
        (g_tier,) = torch.autograd.grad((vt.cwt(x, scales, CWT_WAVELET,
                                                boundary="periodic").coeffs * wts).sum(), x)
        torch.cuda.synchronize()
        syn = mc.LAUNCHES["modwt_bank_synthesis"] - before
    planes = [p for xr, dense in tier_bank_calls(x, scales)
              for p in mb.bank_analysis_plain(xr, dense, True)]
    (g_plain,) = torch.autograd.grad((torch.stack(planes, -2) * wts).sum(), x)
    err = rel_err(g_tier, g_plain)
    check(syn == 1 and err <= TOL_CWT,
          f"d/dx through the tier, {b}x{n}, {len(scales)} scales: {syn} bank synthesis "
          f"launch, vs autograd through the plain version {err:.3e} <= {TOL_CWT:.0e} of max")


def two_tone(n, dtype, dev):
    """Two tones inside both grids' bands (periods 8 and 32: scales 7.6 and
    30.6 for morl)."""
    t = torch.arange(n, device=dev, dtype=torch.float64)
    return (torch.sin(2 * math.pi * t / 8) + 0.5 * torch.sin(2 * math.pi * t / 32)).to(dtype)


def cwt_path(dev, gen):
    """Phase 3 for the CWT: the public entry points at config #5's
    single-card shape and the main path's batch, each call with its own reset
    and reading of the counters, against the plain route (``torch``).
    Returns the launches, summed over the calls."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.transforms import cwt as tc

    total = {}

    def counted(label, expect, fn):
        """``expect``: the exact launches (a dict), or the kernels that each
        launch at least once, and no other (a set)."""
        mc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == expect if isinstance(expect, dict) else set(got) == expect,
              f"{label}: launches {got}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return out

    w = vt.wavelet(CWT_WAVELET)

    def tier_launches(scales):
        """Bank launches ``auto`` makes for these periodic float32 scales."""
        k = tc._kernel_direct_split(dev, w, scales, "periodic", torch.float32)
        return len(tc._kernel_direct_chunks(w, scales[:k])) if k else 0

    def tier_expect(scales, backward=False):
        count = tier_launches(scales)
        if not count:
            return {}
        return ({"modwt_bank_analysis": count, "modwt_bank_synthesis": count} if backward
                else {"modwt_bank_analysis": count})

    rows = []
    for label, b, n, scales in (
        ("config #5 (one 2^20 row, 64 scales 2-4096)", 1, CFG5_N, CFG5_SCALES),
        (f"the main batch {BATCH}x{N} (32 scales 2-64)", BATCH, N, MAIN_SCALES),
    ):
        x = torch.randn(b, n, device=dev, generator=gen)
        x = x[0] if b == 1 else x
        k = tc._kernel_direct_split(dev, w, scales, "periodic", torch.float32)
        print(f"  cwt {label}: auto takes "
              f"{'the kernel-direct tier' if k else 'the FFT path'} (every scale to h = "
              f"{tc.AUTO_KERNEL_DIRECT_MAX_HALF} in one bank call, or none)", flush=True)
        check(k in (0, len(scales)), f"cwt {label}: auto takes the tier whole or not at all")
        res = counted(f"cwt {label}, auto", tier_expect(scales),
                      lambda: vt.cwt(x, scales, CWT_WAVELET, boundary="periodic"))
        with backend("torch"):
            ref = counted(f"cwt {label}, the plain route", {},
                          lambda: vt.cwt(x, scales, CWT_WAVELET, boundary="periodic"))
        err = rel_err(res.coeffs, ref.coeffs)
        check(res.coeffs.shape == x.shape[:-1] + (len(scales), n) and err <= TOL_CWT
              and bool(torch.isfinite(res.coeffs).all()),
              f"cwt {label}: auto vs the plain route {err:.3e} <= {TOL_CWT:.0e} of max")
        y = counted(f"icwt {label}", {}, lambda: vt.icwt(res, CWT_WAVELET))
        err = rel_err(y, vt.icwt(ref, CWT_WAVELET))
        check(y.shape == x.shape and err <= TOL_CWT,
              f"icwt {label}: vs the plain route's {err:.3e} <= {TOL_CWT:.0e} of max")
        rows.append((label, x, scales, res))
        del ref, y
        # the equalized inverse inside the band: a two-tone signal
        for dtype in (torch.float64, torch.float32):
            xt = two_tone(n, dtype, dev).expand(x.shape).contiguous()
            yt = vt.icwt(vt.cwt(xt, scales, CWT_WAVELET, boundary="periodic"), CWT_WAVELET)
            nrmse = ((yt.double() - xt.double()).pow(2).mean().sqrt()
                     / xt.double().std()).item()
            if dtype == torch.float64:
                check(nrmse <= ICWT_NRMSE_F64,
                      f"cwt -> icwt {label}, two tones, float64 (the FFT path): normalised "
                      f"RMSE {nrmse:.3e} <= {ICWT_NRMSE_F64:.0e}")
            else:
                check(math.isfinite(nrmse), f"cwt -> icwt {label}, two tones, float32 "
                                            f"(auto): normalised RMSE {nrmse:.6e}")
            del xt, yt

    # the gradient through the public call: the tier's backward on the card
    # (of a weighted sum: the plain sum's gradient is the wavelets' zero mean)
    x, scales = rows[1][1], rows[1][2]
    xg = x.detach().clone().requires_grad_(True)
    wts = torch.randn(x.shape[:-1] + (len(scales), x.shape[-1]), device=dev, generator=gen)

    def grad():
        return torch.autograd.grad(
            (vt.cwt(xg, scales, CWT_WAVELET, boundary="periodic").coeffs * wts).sum(), xg)[0]

    g = counted("d/dx of a weighted sum of cwt's coefficients, the main batch, auto",
                tier_expect(scales, backward=True), grad)
    with backend("torch"):
        g_ref = grad()
    err = rel_err(g, g_ref)
    check(err <= TOL_CWT, f"d/dx through cwt vs the plain route: {err:.3e} <= "
                          f"{TOL_CWT:.0e} of max")
    del xg, wts, g, g_ref

    # auto on the tier: 16 scales whose h all stay within the cap, at the
    # main batch; the result is the bank's [S, B, N] allocation seen as
    # [B, S, N] (no copy), and its gradient one bank synthesis launch
    cap = tc.AUTO_KERNEL_DIRECT_MAX_HALF
    scales = cwt_scales(16, cap / 32.0, cap / 4.0)
    res = counted(f"cwt the main batch, 16 scales to h = {cap}, auto (the tier)",
                  {"modwt_bank_analysis": 1},
                  lambda: vt.cwt(x, scales, CWT_WAVELET, boundary="periodic"))
    check(res.coeffs.stride() == (N, BATCH * N, 1),
          f"the tier's result is the bank's allocation seen as [B, S, N]: strides "
          f"{res.coeffs.stride()}")
    with backend("torch"):
        ref = vt.cwt(x, scales, CWT_WAVELET, boundary="periodic")
    err = rel_err(res.coeffs, ref.coeffs)
    check(err <= TOL_CWT, f"cwt on the tier under auto vs the plain route {err:.3e} <= "
                          f"{TOL_CWT:.0e} of max")
    xg = x.detach().clone().requires_grad_(True)
    wts = torch.randn(BATCH, len(scales), N, device=dev, generator=gen)
    g = counted("d/dx through cwt on the tier under auto",
                {"modwt_bank_analysis": 1, "modwt_bank_synthesis": 1},
                lambda: torch.autograd.grad((vt.cwt(xg, scales, CWT_WAVELET,
                                                    boundary="periodic").coeffs * wts).sum(),
                                            xg)[0])
    with backend("torch"):
        (g_ref,) = torch.autograd.grad((vt.cwt(xg, scales, CWT_WAVELET,
                                               boundary="periodic").coeffs * wts).sum(), xg)
    err = rel_err(g, g_ref)
    check(err <= TOL_CWT, f"d/dx through cwt on the tier vs the plain route {err:.3e} <= "
                          f"{TOL_CWT:.0e} of max")
    del res, ref, xg, wts, g, g_ref

    # modwt_based_icwt on the main batch: the first call calibrates (cwt and
    # modwt_multilevel on the card, cached), every call synthesises
    label, x, scales, res = rows[1]
    counted(f"modwt_based_icwt {label}, the first call (calibrates)",
            {"modwt_analysis", "modwt_synthesis"}
            | ({"modwt_bank_analysis"} if tier_launches(scales) else set()),
            lambda: vt.modwt_based_icwt(res, CWT_WAVELET))
    y = counted(f"modwt_based_icwt {label}", {"modwt_synthesis": 1},
                lambda: vt.modwt_based_icwt(res, CWT_WAVELET))
    with backend("torch"):
        y_ref = vt.modwt_based_icwt(res, CWT_WAVELET)
    err = rel_err(y, y_ref)
    check(y.shape == x.shape and bool(torch.isfinite(y).all()) and err <= TOL_CWT,
          f"modwt_based_icwt {label}: vs the plain route {err:.3e} <= {TOL_CWT:.0e} of max")
    del rows, res, y, y_ref

    # the TPU bench's zero-boundary rows, a complex wavelet and the analytic
    # signal: the FFT path, no kernel; a small input also against float64 on
    # the CPU
    small = torch.randn(2, 4096, device=dev, generator=gen)
    for label, b, n, kw in (
        ("zero boundary, 1x8192", 1, 8192, {}),
        ("zero boundary, 1x32768", 1, 32768, {}),
        ("cmor, periodic, 8x65536", 8, 65536, {"wavelet": "cmor", "boundary": "periodic"}),
        ("morl analytic, zero boundary, 8x65536", 8, 65536, {"analytic": True}),
    ):
        x = torch.randn(b, n, device=dev, generator=gen)
        kw = {"wavelet": CWT_WAVELET, **kw}
        res = counted(f"cwt {label}, 32 scales 2-64", {},
                      lambda: vt.cwt(x, MAIN_SCALES, **kw))
        with backend("torch"):
            ref = vt.cwt(x, MAIN_SCALES, **kw)
        got_s = vt.cwt(small, MAIN_SCALES, **kw).coeffs
        want_s = vt.cwt(small.cpu().double(), MAIN_SCALES, **kw).coeffs
        err_s = rel_err(got_s.cpu().to(want_s.dtype), want_s)
        check(res.coeffs.shape == (b, len(MAIN_SCALES), n)
              and bool(torch.isfinite(res.coeffs).all())
              and res.coeffs.is_complex() == ("cmor" in label or "analytic" in label)
              and rel_err(res.coeffs, ref.coeffs) <= TOL_CWT and err_s <= TOL_CWT,
              f"cwt {label}: vs the plain route {rel_err(res.coeffs, ref.coeffs):.3e}, 2x4096 "
              f"against float64 on the CPU {err_s:.3e}, each <= {TOL_CWT:.0e} of max")
        del res, ref
    print(f"  launches during the CWT path: {total}", flush=True)
    for k in BANK_PATH:
        check(total.get(k, 0) > 0, f"{k} launched {total.get(k, 0)} times on the CWT path")
    return total


def cwt_timing(dev, gen):
    """Phase 4 for the CWT: the public calls of phase 3, the FFT path against
    its floor, ``auto`` against the plain route, the gate sweep on whole
    calls (16 scales to each candidate cap, at 1 x 2^20 and 128 x 65536) and
    the bank pair on the tier's dense taps beside its bound and
    ``F.conv1d``.  Returns {kernel: [cases]}."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.transforms import cwt as tc

    w = vt.wavelet(CWT_WAVELET)
    cases = {k: [] for k in BANK_PATH}
    x5 = torch.randn(CFG5_N, device=dev, generator=gen)
    xb = torch.randn(BATCH, N, device=dev, generator=gen)
    res5 = vt.cwt(x5, CFG5_SCALES, CWT_WAVELET, boundary="periodic")
    resb = vt.cwt(xb, MAIN_SCALES, CWT_WAVELET, boundary="periodic")
    x8k = torch.randn(8192, device=dev, generator=gen)
    x32k = torch.randn(32768, device=dev, generator=gen)
    x8 = torch.randn(8, 65536, device=dev, generator=gen)

    def under(name, fn):
        def run():
            with backend(name):
                return fn()
        return run

    def cfg5(**kw):
        return vt.cwt(x5, CFG5_SCALES, CWT_WAVELET, boundary="periodic", **kw)

    def main_batch(**kw):
        return vt.cwt(xb, MAIN_SCALES, CWT_WAVELET, boundary="periodic", **kw)

    for label, count, fn in (
        ("cwt config #5 (2^20, 64 scales 2-4096, periodic), auto", CFG5_N, cfg5),
        ("cwt config #5, the plain route (every scale on the FFT path)", CFG5_N,
         under("torch", cfg5)),
        ("cwt config #5, backend kernel (the tier to h = 2048)", CFG5_N, under("kernel", cfg5)),
        ("icwt config #5", CFG5_N, lambda: vt.icwt(res5, CWT_WAVELET)),
        ("cwt -> icwt config #5, auto", CFG5_N, lambda: vt.icwt(cfg5(), CWT_WAVELET)),
        (f"cwt {BATCH}x{N} (32 scales 2-64, periodic), auto", BATCH * N, main_batch),
        (f"cwt {BATCH}x{N}, the plain route", BATCH * N, under("torch", main_batch)),
        (f"icwt {BATCH}x{N}", BATCH * N, lambda: vt.icwt(resb, CWT_WAVELET)),
        (f"cwt -> icwt {BATCH}x{N}, auto", BATCH * N,
         lambda: vt.icwt(main_batch(), CWT_WAVELET)),
        (f"modwt_based_icwt {BATCH}x{N}", BATCH * N,
         lambda: vt.modwt_based_icwt(resb, CWT_WAVELET)),
        ("cwt zero boundary 1x8192, 32 scales 2-64", 8192,
         lambda: vt.cwt(x8k, MAIN_SCALES, CWT_WAVELET)),
        ("cwt zero boundary 1x32768, 32 scales 2-64", 32768,
         lambda: vt.cwt(x32k, MAIN_SCALES, CWT_WAVELET)),
        ("cwt cmor periodic 8x65536, 32 scales 2-64", 8 * 65536,
         lambda: vt.cwt(x8, MAIN_SCALES, "cmor", boundary="periodic")),
        ("cwt morl analytic zero 8x65536, 32 scales 2-64", 8 * 65536,
         lambda: vt.cwt(x8, MAIN_SCALES, CWT_WAVELET, analytic=True)),
    ):
        t_ms = median_ms(fn, 2, 10)
        print(f"  {label}: {t_ms:.4f} ms ({count / t_ms / 1e3:.1f} Msamples/s)", flush=True)
    del res5, resb
    # the FFT path against bench_full.py's floor model: per scale, the
    # half-spectrum read and the row written, at the card's memory rate
    for label, x, scales in (("config #5", x5, CFG5_SCALES), (f"{BATCH}x{N}", xb, MAIN_SCALES)):
        n, rows = x.shape[-1], x.numel() // x.shape[-1]
        floor = len(scales) * rows * ((n // 2 + 1) * 8 + n * 4) / HBM_BPS * 1e3
        with backend("torch"):
            t_ms = median_ms(lambda: vt.cwt(x, scales, CWT_WAVELET, boundary="periodic"), 2, 10)
        print(f"  the FFT path, {label}, every scale: {t_ms:.4f} ms, {t_ms / len(scales):.4f} "
              f"ms a scale; floor {floor:.4f} ms ({t_ms / floor:.1f}x above it)", flush=True)

    # the gate sweep, on whole cwt calls: 16 scales whose h all stay at or
    # below each candidate cap (geomspace(cap / 32, cap / 4): h from cap / 8
    # to cap), the tier (one bank call, as auto takes it) against the plain
    # route, SWEEP_RUNS runs each at both shapes in turns (the tier first,
    # then the plain route first), after one untimed run of each route at
    # the shape
    planes = 16
    wins = {}
    for b, n in ((1, CFG5_N), (BATCH, N)):
        x = torch.randn(b, n, device=dev, generator=gen)
        for cap in CWT_GATE_CAPS:
            scales = cwt_scales(planes, cap / 32.0, cap / 4.0)
            check(max(tc._half_support(sc, w.bandwidth) for sc in scales) == cap,
                  f"the sweep's scales for cap {cap} reach h = {cap}")
            tier = under("kernel", lambda: vt.cwt(x, scales, CWT_WAVELET, boundary="periodic"))
            fft = under("torch", lambda: vt.cwt(x, scales, CWT_WAVELET, boundary="periodic"))
            if cap == CWT_GATE_CAPS[0]:
                median_ms(tier, 2, 10)
                median_ms(fft, 2, 10)
            runs = []
            for r in range(SWEEP_RUNS):
                if r % 2 == 0:
                    t_tier = median_ms(tier, 2, 10)
                    t_fft = median_ms(fft, 2, 10)
                else:
                    t_fft = median_ms(fft, 2, 10)
                    t_tier = median_ms(tier, 2, 10)
                runs.append((t_tier, t_fft))
            wins[(b, n, cap)] = all(t < f for t, f in runs)
            print(f"  gate sweep {b}x{n}, 16 scales to h = {cap}: tier "
                  f"{[round(t, 4) for t, _ in runs]} ms, the plain route "
                  f"{[round(f, 4) for _, f in runs]} ms "
                  f"({'tier' if wins[(b, n, cap)] else 'not the tier'} in every run)",
                  flush=True)
        del x
    derived = 0
    for cap in CWT_GATE_CAPS:
        if not all(wins[(b, n, cap)] for b, n in ((1, CFG5_N), (BATCH, N))):
            break
        derived = cap
    print(f"  gate sweep: the tier wins every run at both shapes up to h = {derived} "
          f"(0: nowhere); AUTO_KERNEL_DIRECT_MAX_HALF = {tc.AUTO_KERNEL_DIRECT_MAX_HALF}",
          flush=True)

    # the bank pair on the tier's dense taps: config #5's tier under
    # backend kernel (h 8-2048) and under auto, and the main batch's
    def tier_scales(scales, cap):
        return tuple(s for s in scales if tc._half_support(s, w.bandwidth) <= cap)

    cap = tc.AUTO_KERNEL_DIRECT_MAX_HALF
    for label, x, scales in (
        ("cwt config #5, backend kernel (h 8-2048)", x5[None],
         tier_scales(CFG5_SCALES, tc.KERNEL_DIRECT_MAX_HALF)),
        (f"config #5's scales to the auto cap h = {cap}", x5[None],
         tier_scales(CFG5_SCALES, cap)),
        (f"cwt {BATCH}x{N}, 16 scales to the auto cap h = {cap}", xb,
         cwt_scales(16, cap / 32.0, cap / 4.0)),
    ):
        ((xr, dense),) = tier_bank_calls(x, scales)
        taps = mb.bank_taps(dense)
        rows, n = xr.shape
        planes_out = mb.bank_analysis(xr, dense, True)
        stacked = torch.stack(planes_out, dim=1)
        bank = torch.tensor(dense, device=dev, dtype=torch.float32)
        w_rev = bank.flip(-1)[:, None].contiguous()
        calls = {
            "modwt_bank_analysis": (
                lambda: mb.bank_analysis(xr, dense, True),
                lambda: mb.bank_analysis_plain(xr, dense, True),
                lambda: F.conv1d(F.pad(xr[:, None], (taps.span, 0), mode="circular"), w_rev)),
            "modwt_bank_synthesis": (
                lambda: mb.bank_synthesis(planes_out, dense, True),
                lambda: mb.bank_synthesis_plain(planes_out, dense, True),
                lambda: F.conv1d(F.pad(stacked, (0, taps.span), mode="circular"), bank[None])),
        }
        lib_err = max(rel_err(calls["modwt_bank_analysis"][2]()[:, -1],
                              calls["modwt_bank_analysis"][0]()[-1]),
                      rel_err(calls["modwt_bank_synthesis"][2]()[:, 0],
                              calls["modwt_bank_synthesis"][0]()))
        check(lib_err <= 1e-4, f"{label}: F.conv1d computes the bank kernels' function on "
                               f"the dense taps ({lib_err:.3e} of max)")
        samples = rows * n
        t_bytes = samples * 4 * (1 + taps.planes) / HBM_BPS * 1e3
        t_ops = samples * taps.nonzeros * 2 / FP32_FLOPS * 1e3
        by = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        for kname, (kernel, plain, library_call) in calls.items():
            times = (median_ms(kernel, 2, 10), median_ms(plain, 1, 3),
                     median_ms(library_call, 1, 5))
            cases[kname].append({
                "case": f"{label} {rows}x{n}, {taps.planes} planes, {taps.nonzeros} taps",
                "ms": times[0], "plain_ms": times[1], "library_ms": times[2],
                "bound_ms": by[0], "bound_by": by[1]})
            print(f"  {kname} {label} {rows}x{n} ({taps.planes} planes, {taps.nonzeros} "
                  f"dense taps): kernel {times[0]:.4f} ms "
                  f"({2e-9 * samples * taps.nonzeros / times[0]:.2f} TFLOP/s), plain "
                  f"{times[1]:.4f} ms, library {times[2]:.4f} ms, bound {by[0]:.4f} ms "
                  f"({by[1]}; {100 * by[0] / times[0]:.1f}% of it)", flush=True)
        del planes_out, stacked, calls
    # auto against the plain route in whole calls at config #5 and the main
    # batch: ten pairs of runs (each the median of 20 calls from an idle
    # card), alternating which route runs first; auto must be no slower
    # than the plain route by more than AUTO_SLOWER in the median pair.  A
    # pair's two runs follow each other, so its ratio is free of the card's
    # clock drifting over the ten pairs, which the two routes' medians taken
    # apart are not.  The host's time to enqueue a call (no synchronise,
    # median of 50) is printed beside it.
    for label, fn in (("config #5", cfg5), (f"{BATCH}x{N}, 32 scales 2-64", main_batch)):
        t_auto, t_plain = [], []
        for r in range(AUTO_PAIRS):
            pair = [(t_auto, fn), (t_plain, under("torch", fn))]
            for times, f in (pair if r % 2 == 0 else pair[::-1]):
                times.append(median_ms(f, 2, 20))
        enqueue = []
        for f in (fn, under("torch", fn)):
            us = []
            for _ in range(50):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                us.append((time.perf_counter() - t0) * 1e6)
            enqueue.append(sorted(us)[25])
        torch.cuda.synchronize()
        a, p = float(np.median(t_auto)), float(np.median(t_plain))
        ratio = float(np.median([x / y for x, y in zip(t_auto, t_plain)]))
        check(ratio <= 1 + AUTO_SLOWER,
              f"cwt {label}: auto against the plain route {100 * (ratio - 1):+.1f}% in the "
              f"median pair (at most {100 * AUTO_SLOWER:+.0f}%; medians {a:.4f} / {p:.4f} ms; "
              f"auto faster in "
              f"{sum(x < y for x, y in zip(t_auto, t_plain))} of {AUTO_PAIRS} pairs; runs "
              f"auto {[round(t, 4) for t in t_auto]}, plain {[round(t, 4) for t in t_plain]}; "
              f"host enqueue {enqueue[0]:.1f} / {enqueue[1]:.1f} us)")
    return cases


def counted_launches(label, expect, fn, total):
    """Run ``fn`` with the launch counters set to 0 just before and read
    just after; ``expect``: the exact launches (a dict), or the kernels each
    launching at least once, and no other (a set).  Adds them to ``total``."""
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    mc.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in mc.LAUNCHES.items() if v}
    check(got == expect if isinstance(expect, dict) else set(got) == expect,
          f"{label}: launches {got}")
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return out


def cwt_tiled_path(dev, gen):
    """Phase 3 for the tiled CWT: config #5 (one 2^20-sample row, morl, 64
    log scales 2-4096) over 4 and 8 virtual shards of the card, zero and
    periodic, and ``cwt_tiled_2d`` on a 2 x 4 host x chip mesh of the card,
    each against the single-card ``cwt`` within TOL_CWT of the largest
    coefficient.  The FFT path on the tiles: no kernel launch."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import parallel as par

    total = {}
    x = torch.randn(CFG5_N, device=dev, generator=gen)
    for boundary in ("zero", "periodic"):
        ref = vt.cwt(x, CFG5_SCALES, CWT_WAVELET, boundary=boundary).coeffs
        for shards in TILED_SHARDS:
            mesh = par.make_mesh({"signal": shards}, devices=[dev] * shards)
            got = counted_launches(
                f"cwt_tiled config #5, {shards} shards, {boundary}", {},
                lambda: par.cwt_tiled(x, CFG5_SCALES, CWT_WAVELET, mesh=mesh,
                                      boundary=boundary), total).coeffs
            err = rel_err(got, ref)
            check(got.shape == ref.shape and bool(torch.isfinite(got).all())
                  and err <= TOL_CWT,
                  f"cwt_tiled config #5 over {shards} virtual shards, {boundary}: vs the "
                  f"single-card cwt {err:.3e} <= {TOL_CWT:.0e} of max")
            del got
        if boundary == "zero":
            hosts = par.make_multihost_mesh(n_hosts=2, chips_per_host=4, devices=[dev] * 8)
            got = counted_launches(
                "cwt_tiled_2d config #5, 2x4 host x chip", {},
                lambda: par.cwt_tiled_2d(x, CFG5_SCALES, CWT_WAVELET, mesh=hosts), total).coeffs
            err = rel_err(got, ref)
            check(got.shape == ref.shape and err <= TOL_CWT,
                  f"cwt_tiled_2d config #5 on a 2x4 mesh of the card: vs the single-card cwt "
                  f"{err:.3e} <= {TOL_CWT:.0e} of max")
            del got
        del ref
    return total


class float64_default:
    """Host prices become float64 tensors inside (the port's finance
    functions take the default dtype), as a float64 reference needs."""

    def __enter__(self):
        self.old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)

    def __exit__(self, *exc):
        torch.set_default_dtype(self.old)


def small_cpu(t):
    """A card tensor as the float64 CPU input of the plain reference."""
    return t.detach().cpu().double()


def cwt_analysis_path(dev, gen):
    """Phase 3 for what is built on the CWT, each call with its own reset and
    reading of the counters: the TPU bench's shapes for coherence, the ridge
    and the SST, the significance tests, matching pursuit and the finance
    analyzers, each held to a reference (a small input against float64 on
    the CPU, the plain route, or a closed form).  Returns the launches."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import finance as fin
    from vectorwave_tpu_torch.transforms import sst as tsst
    from vectorwave_tpu_torch.transforms.cwt import _log_weights

    total = {}
    s32 = cwt_scales(32, 2.0, 64.0)
    t = torch.arange(65536, device=dev, dtype=torch.float32)
    tone = torch.sin(2 * math.pi * 0.05 * t)
    noise = torch.randn(4, 65536, device=dev, generator=gen)
    x, y = tone + 0.3 * noise[0], torch.roll(tone, 7) + 0.3 * noise[1]

    # wavelet_coherence, 32 scales x 32768
    xs, ys = x[:32768].contiguous(), y[:32768].contiguous()
    coh = counted_launches("wavelet_coherence 32 scales x 32768", {},
                           lambda: vt.wavelet_coherence(xs, ys, s32, CWT_WAVELET), total)
    c = coh.coherence
    small = vt.wavelet_coherence(xs[:2048], ys[:2048], s32, CWT_WAVELET).coherence
    want = vt.wavelet_coherence(small_cpu(xs[:2048]), small_cpu(ys[:2048]), s32,
                                CWT_WAVELET).coherence
    err = rel_err(small.cpu(), want)
    check(c.shape == (32, 32768) and bool(((c >= 0) & (c <= 1)).all()) and err <= TOL_COH,
          f"wavelet_coherence: in [0, 1]; 2048 samples against float64 on the CPU {err:.3e} "
          f"<= {TOL_COH:.0e} of max")
    del coh, c

    # extract_ridge, 32 scales x 65536 (the blocked Viterbi); the reference:
    # the path's score under the card's own float32 field, against the CPU
    # float64 Viterbi's on a 4096-sample cut
    res = vt.cwt(x, s32, CWT_WAVELET, analytic=True)
    ridge = counted_launches("extract_ridge 32 scales x 65536", {},
                             lambda: vt.extract_ridge(res), total)
    check(ridge.indices.shape == (65536,) and ridge.indices.dtype == torch.int32
          and bool(torch.isfinite(ridge.amplitude).all()),
          "extract_ridge: int32 indices and finite amplitudes, one a sample")
    cut = vt.CWTResult(res.coeffs[:, :4096].contiguous(), res.scales, res.boundary)
    got = vt.extract_ridge(cut).indices.long().cpu()
    obs = torch.log(torch.clamp_min(cut.coeffs.abs(), 1e-30)).double().cpu()
    want = vt.extract_ridge(vt.CWTResult(cut.coeffs.cpu().to(torch.complex128), cut.scales,
                                         cut.boundary)).indices.long()
    log_s = torch.log2(torch.tensor(s32, dtype=torch.float64))
    pen = 2.0 * (log_s[:, None] - log_s[None, :]) ** 2

    def score(idx):
        return float(obs.T.gather(1, idx[:, None]).sum() - pen[idx[:-1], idx[1:]].sum())

    gap = abs(score(got) - score(want)) / abs(score(want))
    check(gap <= TOL_RIDGE, f"extract_ridge on 32x4096: the card's path scores "
                            f"{score(got):.6f}, the CPU float64 Viterbi's {score(want):.6f} "
                            f"({gap:.2e} <= {TOL_RIDGE:.0e} apart)")
    del res, ridge, cut

    # synchrosqueeze -> isst, 32 scales x 16384: the scatter against the
    # masked sum per bin on the card, and the in-band two tones recovered
    x16 = (torch.sin(2 * math.pi * 0.04 * t[:16384])
           + 0.8 * torch.sin(2 * math.pi * 0.06 * t[:16384]))
    sst = counted_launches("synchrosqueeze 32 scales x 16384", {},
                           lambda: vt.synchrosqueeze(x16, s32, CWT_WAVELET), total)
    y16 = counted_launches("isst 32 bins x 16384", {}, lambda: vt.isst(sst, CWT_WAVELET), total)
    r = vt.cwt(x16, s32, CWT_WAVELET, analytic=True)
    inner = slice(x16.shape[-1] // 16, -x16.shape[-1] // 16)
    err_sst = (y16 - x16)[inner].abs().max().item()
    err_icwt = (vt.icwt(r, CWT_WAVELET) - x16)[inner].abs().max().item()
    inst = vt.instantaneous_frequency(r)
    f_grid = vt.wavelet(CWT_WAVELET).center_frequency / np.asarray(s32)
    f_lo, f_hi = float(f_grid.min()), float(f_grid.max())
    idx = tsst._bin_indices(r.coeffs, inst, f_lo, math.log(f_hi / f_lo) / 31, 32, 0.0)
    contrib = r.coeffs * torch.as_tensor(_log_weights(s32), device=dev,
                                         dtype=torch.float32)[:, None]
    masked = torch.stack([torch.where(idx == b, contrib, 0).sum(-2) for b in range(32)], -2)
    err = rel_err(tsst._squeeze(contrib, idx, 32), masked)
    check(sst.coeffs.shape == (32, 16384) and err <= TOL_F32
          and err_sst <= err_icwt + SST_OVER_ICWT,
          f"synchrosqueeze: the scatter-add against the masked sum per bin {err:.3e} <= "
          f"{TOL_F32:.0e} of max; isst of two in-band tones off by {err_sst:.3e} inside the "
          f"edges, icwt {err_icwt:.3e} (at most {SST_OVER_ICWT} more)")
    del sst, r, inst, idx, contrib, masked

    # the significance tests, 32 scales x 32768 (64 surrogates)
    res = vt.cwt(xs, s32, CWT_WAVELET, analytic=True)
    sig = counted_launches("significant_power 32 scales x 32768", {},
                           lambda: vt.significant_power(res, xs, CWT_WAVELET), total)
    a = vt.ar1_coefficient(xs).item()
    v = xs.var(correction=0).item()  # float32, as significant_power takes it
    want = vt.significance_levels(s32, CWT_WAVELET, n=32768, lag1=a, variance=v, device="cpu")
    err = rel_err(sig.levels.cpu(), want)
    check(sig.mask.shape == (32, 32768) and sig.mask.dtype == torch.bool
          and err <= TOL_LEVELS,
          f"significant_power: levels against float64 on the CPU {err:.3e} <= "
          f"{TOL_LEVELS:.0e}; {int(sig.mask.sum())} significant coefficients")
    lev = counted_launches("coherence_significance 64 surrogates, 32 scales x 32768", {},
                           lambda: vt.coherence_significance(xs, ys, s32, CWT_WAVELET,
                                                             n_surrogates=64), total)
    again = vt.coherence_significance(xs, ys, s32, CWT_WAVELET, n_surrogates=64)
    above = int((vt.wavelet_coherence(xs, ys, s32, CWT_WAVELET).mean_coherence() > lev).sum())
    check(lev.shape == (32,) and bool(((lev > 0) & (lev <= 1)).all())
          and torch.equal(lev, again),
          f"coherence_significance: 32 levels in (0, 1], repeatable; the pair's mean "
          f"coherence above its level at {above} of 32 scales")
    del res, sig, lev, again

    # matching_pursuit 8 x 16384, mexh, 16 scales 2-64, 32 steps: two atoms
    # planted in each row under noise are found first, with their amplitudes
    s16 = cwt_scales(16, 2.0, 64.0)
    from vectorwave_tpu_torch.transforms.cwt import _sample_bank

    rows = _sample_bank(vt.wavelet("mexh"), s16, 16384)[0].real
    atoms = rows / np.linalg.norm(rows, axis=-1, keepdims=True)
    planted = np.zeros((8, 16384))
    for i in range(8):
        planted[i] += 5.0 * np.roll(atoms[3], 1000 + 1500 * i)
        planted[i] -= 4.0 * np.roll(atoms[10], 9000 + 700 * i)
    xm = (torch.as_tensor(planted, dtype=torch.float32, device=dev)
          + 0.01 * torch.randn(8, 16384, device=dev, generator=gen))
    mp = counted_launches("matching_pursuit 8x16384, 16 scales, 32 steps", {},
                          lambda: vt.matching_pursuit(xm, s16, "mexh", steps=32), total)
    found = all({(3, (1000 + 1500 * i) % 16384), (10, (9000 + 700 * i) % 16384)}
                == {(int(mp.scale_indices[i, k]), int(mp.shifts[i, k])) for k in (0, 1)}
                for i in range(8))
    amps = mp.coeffs[:, :2].abs().sort(dim=-1).values
    decreasing = bool((mp.energies[:, 1:] <= mp.energies[:, :-1] * (1 + 1e-6)).all())
    split = max_err(mp.approx + mp.residual, xm)
    check(found and max_err(amps, torch.tensor([4.0, 5.0], device=dev).expand(8, 2)) <= 0.05
          and decreasing and split <= TOL_F32,
          f"matching_pursuit: both planted atoms first in every row, amplitudes "
          f"{amps[0].tolist()}, energies non-increasing, approx + residual - x {split:.2e}")
    del mp

    # the finance analyzers on the card (float32, the default dtype)
    rets = 0.01 * torch.randn(1, 10240, device=dev, generator=gen) + 0.0005
    rets512 = 0.01 * torch.randn(512, 4096, device=dev, generator=gen) + 0.0005
    for label, r_in in (("1x10240", rets), ("512x4096", rets512)):
        got = counted_launches(f"wavelet_sharpe_ratio {label}", {"modwt_denoise"},
                               lambda: fin.wavelet_sharpe_ratio(r_in), total)
        with backend("torch"):
            ref = fin.wavelet_sharpe_ratio(r_in)
        err = rel_err(got, ref)
        check(got.shape == r_in.shape[:1] and err <= TOL_SHARPE,
              f"wavelet_sharpe_ratio {label} (the fused denoise) vs the plain route "
              f"{err:.3e} <= {TOL_SHARPE:.0e}")
    prices = 100.0 * torch.exp(torch.cumsum(rets[0], 0))
    prices[7000:7002] *= 0.85  # a crash
    mkt = counted_launches("analyze_market 10240 prices", {"modwt_denoise"},
                           lambda: fin.analyze_market(prices), total)
    p_np = prices.double().cpu().numpy()
    dd = float(np.max((np.maximum.accumulate(p_np) - p_np) / np.maximum.accumulate(p_np)))
    check(bool(mkt.regime_map) and math.isfinite(mkt.current_risk_level)
          and abs(mkt.max_drawdown - dd) <= 1e-12 and any(a.time_index in (6999, 7000)
                                                          for a in mkt.anomalies),
          f"analyze_market: {len(mkt.regime_map)} windows, {len(mkt.regime_changes)} regime "
          f"changes, {len(mkt.anomalies)} anomalies (the crash among them), max drawdown "
          f"{mkt.max_drawdown:.4f}")
    vol = fin.analyze_volatility(prices)
    with float64_default():
        want = fin.analyze_volatility(prices.double().cpu())
    err = np.abs(vol.instantaneous_volatility - want.instantaneous_volatility).max() / np.abs(
        want.instantaneous_volatility).max()
    check(err <= TOL_XWT, f"analyze_volatility's instantaneous volatility against float64 on "
                          f"the CPU {err:.3e} <= {TOL_XWT:.0e} of max")
    # one level: under the kernels' two-level floor, the plain cascade
    asym = counted_launches("crash_asymmetry haar J=1 symmetric 8x10240", {},
                            lambda: fin.crash_asymmetry(prices.expand(8, -1).contiguous()),
                            total)
    err = rel_err(asym.cpu(), fin.crash_asymmetry(prices.double().cpu().expand(8, -1)))
    check(err <= TOL_XWT, f"crash_asymmetry against float64 on the CPU {err:.3e} <= "
                          f"{TOL_XWT:.0e}")
    ind = counted_launches("calculate_wavelet_indicators sym8 10240", {"modwt_analysis"},
                           lambda: fin.calculate_wavelet_indicators(prices), total)
    with float64_default():
        want = fin.calculate_wavelet_indicators(prices.double().cpu())
    err = max(np.abs(a - b).max() / np.abs(b).max()
              for a, b in zip(ind[:1] + ind[3:], want[:1] + want[3:]))
    check(err <= TOL_XWT, f"calculate_wavelet_indicators (trend, support) against float64 "
                          f"on the CPU {err:.3e} <= {TOL_XWT:.0e} of max")
    ticks = prices[:4096].contiguous()
    m = counted_launches("analyze_ticks_incremental 4096 ticks", {},
                         lambda: fin.analyze_ticks_incremental(ticks), total)
    haar = (ticks[1:] - ticks[:-1]) * 0.5
    err = max_err(m.haar_detail[1:], haar)
    check(m.crash_score.shape == (4096,) and bool(torch.isfinite(m.crash_score[32:]).all())
          and err <= 1e-5 and m.haar_detail[0].item() == 0.0,
          f"analyze_ticks_incremental: the Haar detail against its closed form {err:.2e}; "
          f"{int(m.crash_detected.sum())} crash ticks, max drawdown "
          f"{m.base.max_drawdown[-1].item():.4f}")
    print(f"  launches on the paths built on the CWT: {total}", flush=True)
    return total


def cwt_analysis_timing(dev, gen):
    """Phase 4 for the tiled CWT and what is built on the CWT: each call of
    phase 3 timed with CUDA events (the tick stream, a Python loop of about
    50 launches a tick, with fewer runs)."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import finance as fin
    from vectorwave_tpu_torch import parallel as par

    x5 = torch.randn(CFG5_N, device=dev, generator=gen)
    s32, s16 = cwt_scales(32, 2.0, 64.0), cwt_scales(16, 2.0, 64.0)
    x = torch.randn(8, 65536, device=dev, generator=gen)
    xs, ys = x[0, :32768].contiguous(), x[1, :32768].contiguous()
    res_a = vt.cwt(x[2], s32, CWT_WAVELET, analytic=True)
    res32 = vt.cwt(xs, s32, CWT_WAVELET, analytic=True)
    rets = 0.01 * torch.randn(1, 10240, device=dev, generator=gen)
    rets512 = 0.01 * torch.randn(512, 4096, device=dev, generator=gen)
    prices = 100.0 * torch.exp(torch.cumsum(rets[0], 0))
    rows = []
    for shards in TILED_SHARDS:
        mesh = par.make_mesh({"signal": shards}, devices=[dev] * shards)
        for boundary in ("zero", "periodic"):
            rows.append((f"cwt_tiled config #5, {shards} shards, {boundary}", CFG5_N,
                         lambda mesh=mesh, boundary=boundary: par.cwt_tiled(
                             x5, CFG5_SCALES, CWT_WAVELET, mesh=mesh, boundary=boundary), 10))
    for boundary in ("zero", "periodic"):
        rows.append((f"cwt config #5 single card, {boundary}", CFG5_N,
                     lambda boundary=boundary: vt.cwt(x5, CFG5_SCALES, CWT_WAVELET,
                                                      boundary=boundary), 10))
    hosts = par.make_multihost_mesh(n_hosts=2, chips_per_host=4, devices=[dev] * 8)
    rows += [
        ("cwt_tiled_2d config #5, 2x4 host x chip", CFG5_N,
         lambda: par.cwt_tiled_2d(x5, CFG5_SCALES, CWT_WAVELET, mesh=hosts), 10),
        ("wavelet_coherence 32 scales x 32768", 32768,
         lambda: vt.wavelet_coherence(xs, ys, s32, CWT_WAVELET), 10),
        ("extract_ridge 32 scales x 65536", 65536, lambda: vt.extract_ridge(res_a), 5),
        ("synchrosqueeze -> isst 32 scales x 16384", 16384,
         lambda: vt.isst(vt.synchrosqueeze(x[3, :16384], s32, CWT_WAVELET), CWT_WAVELET), 10),
        ("significant_power 32 scales x 32768", 32768,
         lambda: vt.significant_power(res32, xs, CWT_WAVELET), 10),
        ("coherence_significance 64 surrogates, 32 scales x 32768", 32768,
         lambda: vt.coherence_significance(xs, ys, s32, CWT_WAVELET, n_surrogates=64), 5),
        ("matching_pursuit mexh 8x16384, 16 scales, 32 steps", 8 * 16384,
         lambda: vt.matching_pursuit(x[:, :16384], s16, "mexh", steps=32), 5),
        ("wavelet_sharpe_ratio 1x10240", 10240, lambda: fin.wavelet_sharpe_ratio(rets), 10),
        ("wavelet_sharpe_ratio 512x4096", 512 * 4096,
         lambda: fin.wavelet_sharpe_ratio(rets512), 10),
        ("analyze_market 10240 prices", 10240, lambda: fin.analyze_market(prices), 5),
        ("analyze_ticks_incremental 4096 ticks", 4096,
         lambda: fin.analyze_ticks_incremental(prices[:4096]), 2),
    ]
    for label, count, fn, reps in rows:
        t_ms = median_ms(fn, 1, reps)
        print(f"  {label}: {t_ms:.4f} ms ({count / t_ms / 1e3:.2f} Msamples/s)", flush=True)


def stream_kernels_against_plain(dev, gen, worst, worst_bf16):
    """Phase 2 for the streaming modes: the analysis kernel's external edge
    (with and without the head splice) and the denoise kernel's stream mode
    against their plain versions.  Halos shorter than, equal to and longer
    than the span; the streaming path's 128x8192 blocks with a halo of the
    span; a block shorter than the span; db36 J=8, whose span
    (18105) outlasts the tile; bfloat16 for the analysis."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
    from vectorwave_tpu_torch.kernels._build import library
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    # (wavelet, levels, batch, n, halo samples, dtype)
    cases = [
        (WAVELET, LEVELS, BATCH, N, 441, torch.float32),
        # the streaming path's own blocks and carry
        (WAVELET, LEVELS, STREAM_B, STREAM_BLK, 441, torch.float32),
        (WAVELET, LEVELS, 3, 5000, 100, torch.float32),
        (WAVELET, LEVELS, 2, 300, 441, torch.float32),
        ("sym8", 4, 8, N, 700, torch.float32),
        ("db36", 8, 2, N, 18105, torch.float32),  # 72 taps: span 18105 > tile
        (WAVELET, LEVELS, BATCH, N, 441, torch.bfloat16),
    ]
    for name, levels, b, n, h, dtype in cases:
        ws = vt.wavelet(name)
        fd, fr = _kernel_filters(ws, synthesis=False), _kernel_filters(ws, synthesis=True)
        span = mc.composite_halo_samples(ws.filter_length, levels)
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        halo = torch.randn(b, h, device=dev, generator=gen).to(dtype)
        tile = library().vw_modwt_analysis_tile(ws.filter_length, levels, n, mc.ANALYSIS_TILE,
                                                mc.EDGES["external"])
        tag = f"{name} J={levels} {b}x{n} halo {h} (span {span}, tile {tile}) {str(dtype)[6:]}"
        results = [("modwt_analysis_external", "", mc.analysis(x, levels, fd, False, halo=halo),
                    mc.analysis_plain(x, levels, fd, False, halo=halo))]
        if dtype == torch.float32 and n >= span:
            head = torch.stack(ms._symmetric_cascade(x[:, :span], fd, levels)).contiguous()
            results.append(("modwt_analysis_external", " with head splice",
                             mc.analysis(x, levels, fd, False, head=head, halo=halo),
                             mc.analysis_plain(x, levels, fd, False, head=head, halo=halo)))
        if dtype == torch.float32 and mc.denoise_tile(ws.filter_length, levels) is not None:
            th = gap_thresholds(mc._external_cascade(x, halo, levels, fd), levels)
            for mode in ("none", "soft", "hard"):
                results.append(("modwt_denoise_stream", f" {mode}",
                                mc.denoise(x, th, levels, fd, fr, False, mode, halo=halo),
                                mc.denoise_plain(x, th, levels, fd, fr, False, mode, halo=halo)))
        torch.cuda.synchronize()
        for kname, extra, got, want in results:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_err(g, p) for g, p in zip(got, want))
            if dtype == torch.float32:
                tol = TOL_F32
                worst[kname] = max(worst[kname], err)
            else:
                tol = BF16_ULP * max(p.float().abs().max().item() for p in want)
                worst_bf16[kname] = max(worst_bf16[kname], err)
            check(err <= tol, f"{kname}{extra} {tag}: max |kernel - plain| {err:.3e} <= "
                              f"{tol:.3e}")
        del x, halo, results


def streaming_path(dev, gen):
    """Phase 3 for the streaming tier at full width, each public call with its
    own reset and reading of the counters.  Returns the streaming rows'
    launches: the external edge's (the zero and symmetric streams) and the
    stream mode's, each counted under its own mode."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import native
    from vectorwave_tpu_torch import streaming as st
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    total = {"modwt_analysis_external": 0, "modwt_denoise_stream": 0}

    def counted(label, expect, fn):
        mc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == expect, f"{label}: launches {got}")
        return out, got

    x = torch.randn(STREAM_B, STREAM_NBLK * STREAM_BLK, device=dev, generator=gen)
    blocks = x.reshape(STREAM_B, STREAM_NBLK, STREAM_BLK).transpose(0, 1).contiguous()
    shape = f"{STREAM_B} streams x {STREAM_NBLK} x {STREAM_BLK}"

    def planes(res):
        return (*res.details, res.approx)

    for boundary in ("zero", "symmetric", "periodic"):
        t = st.StreamingTransform(WAVELET, levels=LEVELS, boundary=boundary,
                                  batch_shape=(STREAM_B,))
        check(t.backend == "kernel", f"StreamingTransform {boundary}: the kernel tier")
        outs = []
        row = "modwt_analysis" if boundary == "periodic" else "modwt_analysis_external"
        for i in range(STREAM_NBLK):
            res, got = counted(f"StreamingTransform {boundary} block {i}", {row: 1},
                               lambda: t.process(blocks[i]))
            outs.append(res)
            total["modwt_analysis_external"] += got.get("modwt_analysis_external", 0)
        if boundary == "periodic":
            err = max(max_err(g, r) for i, o in enumerate(outs) for g, r in zip(
                planes(o), planes(vt.modwt_multilevel(blocks[i], WAVELET, levels=LEVELS,
                                                      backend="torch"))))
            what = "each block vs its own plain periodic transform"
        else:
            whole = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary=boundary,
                                        backend="torch")
            err = max(max_err(torch.cat([o[j] for o in map(planes, outs)], -1), w)
                      for j, w in enumerate(planes(whole)))
            what = "concatenated blocks vs the plain whole-signal transform"
        check(err <= TOL_F32, f"StreamingTransform {boundary} {shape}: {what} "
                              f"{err:.3e} <= {TOL_F32:.0e}")
        del outs

    ramp = torch.arange(STREAM_NBLK * STREAM_BLK, device=dev, dtype=torch.float32)
    clean = torch.sin(2 * math.pi * ramp / 64.0).expand(STREAM_B, -1)
    noisy = clean + 0.5 * torch.randn(STREAM_B, ramp.numel(), device=dev, generator=gen)
    nblocks = noisy.reshape(STREAM_B, STREAM_NBLK, STREAM_BLK).transpose(0, 1).contiguous()
    state0 = st.kernel_streaming_denoiser_init(WAVELET, levels=LEVELS, batch_shape=(STREAM_B,))
    state, plain_state, outs, plain = state0, state0, [], []
    for i in range(STREAM_NBLK):
        (state, out), got = counted(
            f"streaming_denoise_block_kernel block {i}", {"modwt_denoise_stream": 1},
            lambda: st.streaming_denoise_block_kernel(state, nblocks[i], WAVELET,
                                                      levels=LEVELS))
        total["modwt_denoise_stream"] += got["modwt_denoise_stream"]
        outs.append(out)
        plain_state, p_out = st.streaming_denoise_block_kernel(
            plain_state, nblocks[i], WAVELET, levels=LEVELS, backend="torch")
        plain.append(p_out)
    err = max(max_err(a, b) for a, b in zip(outs, plain))
    check(torch.equal(state.noise_window, plain_state.noise_window) and err <= TOL_F32,
          f"streaming denoise {shape}: kernel vs plain version {err:.3e} <= {TOL_F32:.0e}, "
          "noise windows equal")
    den = torch.cat(outs, -1)
    check(den.shape == noisy.shape and bool(torch.isfinite(den).all()),
          f"streaming denoise output finite, shape {tuple(den.shape)}")
    (m_state, m_out), got = counted(
        f"streaming_denoise_blocks_kernel K={STREAM_NBLK}", {"modwt_denoise_stream": 1},
        lambda: st.streaming_denoise_blocks_kernel(state0, nblocks, WAVELET, levels=LEVELS))
    total["modwt_denoise_stream"] += got["modwt_denoise_stream"]
    gap = max_err(m_out, torch.stack(outs))
    check(torch.equal(m_out, torch.stack(outs)) and torch.equal(m_state.history, state.history)
          and torch.equal(m_state.noise_window, state.noise_window),
          f"multiblock K={STREAM_NBLK} equals {STREAM_NBLK} single steps bit for bit "
          f"(max gap {gap:.3e})")
    d = st.StreamingDenoiser(WAVELET, implementation="quality")
    check(d.backend == "kernel", "StreamingDenoiser under auto: the kernel tier")
    y, _ = counted("StreamingDenoiser.denoise 8192", {"modwt_denoise_stream": 1},
                   lambda: d.denoise(noisy[0, :STREAM_BLK]))
    check(y.shape == (STREAM_BLK,) and y.device == dev, "StreamingDenoiser output on the card")
    del outs, plain, m_out

    stream = torch.randn(SLIDE_BUFFER * 8, device=dev, generator=gen)
    slide = st.SlidingStreamingTransform(WAVELET, buffer_size=SLIDE_BUFFER)
    windows, _ = counted(f"SlidingStreamingTransform {SLIDE_BUFFER} (plain path)", {},
                         lambda: slide.process(stream))
    step = slide.step
    err = max(max_err(torch.stack(list(w)), torch.stack(list(vt.modwt(
        stream[i * step:i * step + SLIDE_BUFFER], WAVELET)))) for i, w in enumerate(windows))
    check(len(windows) == 1 + (stream.numel() - SLIDE_BUFFER) // step and err == 0.0,
          f"sliding windows: {len(windows)}, vs the direct transform {err:.3e}")

    check(native.native_available(), "the C++ ring buffer builds and loads")
    ingest = st.StreamIngest(WAVELET, buffer_size=SLIDE_BUFFER, levels=INGEST_LEVELS,
                             capacity=1 << 16)
    check(ingest.step == 407 and ingest.ring.backend == "native",
          f"StreamIngest hop {ingest.step} on the {ingest.ring.backend} ring")
    ticks = stream.cpu().numpy()
    ingest.push(ticks)
    out, _ = counted("StreamIngest.drain (its windows of 512 on the cascade kernel)",
                     {"modwt_analysis": 1}, ingest.drain)
    vt.set_backend("torch")
    try:
        ref = st.SlidingStreamingTransform(WAVELET, buffer_size=SLIDE_BUFFER,
                                           levels=INGEST_LEVELS).process(stream)
    finally:
        vt.set_backend("auto")
    err = max(max_err(a[i], b) for i, r in enumerate(ref)
              for a, b in zip((*out.details, out.approx), (*r.details, r.approx)))
    check(out.approx.shape[0] == len(ref) and out.approx.device == dev and err <= TOL_F32,
          f"StreamIngest: {out.approx.shape[0]} windows on {out.approx.device} vs the "
          f"plain sliding transform {err:.3e} <= {TOL_F32:.0e}")
    print(f"  launches during the streaming path: {total}", flush=True)
    for k, v in total.items():
        check(v > 0, f"{k} launched {v} times")
    return total


def streaming_timing(dev, gen):
    """Phase 4 for the streaming modes and the entry points above them.
    Returns ({row: (ms, plain ms, library ms)}, {row: (bound ms, by)})."""
    import numpy as np
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import native
    from vectorwave_tpu_torch import streaming as st
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    w = vt.wavelet(WAVELET)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    span = mc.composite_halo_samples(w.filter_length, LEVELS)
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    halo = torch.randn(BATCH, span, device=dev, generator=gen)
    th = torch.full((BATCH, LEVELS), 0.1, device=dev)
    bank = composite_bank(fd, LEVELS, dev, torch.float32)
    hx = torch.cat([halo, x], -1)[:, None].contiguous()
    lib_err = max_err(F.conv1d(hx, bank[:, None])[:, -1],
                      mc.analysis(x, LEVELS, fd, False, halo=halo)[-1])
    check(lib_err <= 1e-4, f"F.conv1d on [halo | x] computes the external edge ({lib_err:.3e})")
    samples, taps = BATCH * N, w.filter_length
    rows = {
        "modwt_analysis_external": (
            lambda: mc.analysis(x, LEVELS, fd, False, halo=halo),
            lambda: mc.analysis_plain(x, LEVELS, fd, False, halo=halo),
            lambda: F.conv1d(hx, bank[:, None]),
            # x and the halo in, J + 1 planes out; 2 L J FMAs a sample
            4 * (samples + BATCH * span) + 4 * (LEVELS + 1) * samples,
            2 * taps * LEVELS * samples),
        "modwt_denoise_stream": (
            lambda: mc.denoise(x, th, LEVELS, fd, fr, False, "soft", halo=halo),
            lambda: mc.denoise_plain(x, th, LEVELS, fd, fr, False, "soft", halo=halo),
            None,
            # x, the halo and the thresholds in, x_hat out; 4 L J FMAs a sample
            4 * (2 * samples + BATCH * span + BATCH * LEVELS),
            4 * taps * LEVELS * samples),
    }
    ms_of, bound = {}, {}
    for name, (kernel, plain, library_call, nbytes, fmas) in rows.items():
        ms_of[name] = (median_ms(kernel), median_ms(plain),
                       None if library_call is None else median_ms(library_call))
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, 2 * fmas / FP32_FLOPS * 1e3
        bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        k_ms, p_ms, l_ms = ms_of[name]
        print(f"  {name} {BATCH}x{N}, halo {span}: kernel {k_ms:.4f} ms "
              f"({samples / k_ms / 1e3:.1f} Msamples/s), plain {p_ms:.4f} ms, library "
              f"{'-' if l_ms is None else f'{l_ms:.4f} ms'}, bound {bound[name][0]:.4f} ms "
              f"({bound[name][1]}; {100 * bound[name][0] / k_ms:.1f}% of it)", flush=True)
    del x, halo, hx

    sx = torch.randn(STREAM_B, STREAM_NBLK * STREAM_BLK, device=dev, generator=gen)
    blocks = sx.reshape(STREAM_B, STREAM_NBLK, STREAM_BLK).transpose(0, 1).contiguous()
    stream_samples = sx.numel()

    def stream_row(boundary):
        state = st.kernel_streaming_init(WAVELET, LEVELS, batch_shape=(STREAM_B,))
        for i in range(STREAM_NBLK):
            state, res = st.modwt_stream_block_kernel(state, blocks[i], WAVELET,
                                                      levels=LEVELS, boundary=boundary)
        return res

    def denoise_row():
        state = st.kernel_streaming_denoiser_init(WAVELET, levels=LEVELS,
                                                  batch_shape=(STREAM_B,))
        for i in range(STREAM_NBLK):
            state, out = st.streaming_denoise_block_kernel(state, blocks[i], WAVELET,
                                                           levels=LEVELS)
        return out

    def multiblock_row():
        state = st.kernel_streaming_denoiser_init(WAVELET, levels=LEVELS,
                                                  batch_shape=(STREAM_B,))
        return st.streaming_denoise_blocks_kernel(state, blocks, WAVELET, levels=LEVELS)

    shape = f"{STREAM_B} streams x {STREAM_NBLK} x {STREAM_BLK}"
    for label, fn in (
        (f"block streaming zero {shape} (8 launches)", lambda: stream_row("zero")),
        (f"block streaming symmetric {shape}", lambda: stream_row("symmetric")),
        (f"streaming denoise {shape}, one step a block", denoise_row),
        (f"streaming denoise {shape}, K={STREAM_NBLK} in one launch", multiblock_row),
    ):
        t_ms = median_ms(fn, 2, 10)
        print(f"  {label}: {t_ms:.4f} ms ({stream_samples / t_ms / 1e3:.1f} Msamples/s)",
              flush=True)

    slide = st.SlidingStreamingTransform(WAVELET, buffer_size=SLIDE_BUFFER)
    feed = torch.randn(SLIDE_BUFFER + 200 * slide.step, device=dev, generator=gen)
    slide.process(feed[:SLIDE_BUFFER])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(200):
        slide.process(feed[SLIDE_BUFFER + i * slide.step:SLIDE_BUFFER + (i + 1) * slide.step])
    torch.cuda.synchronize()
    per_window = (time.perf_counter() - t0) / 200
    print(f"  sliding window {SLIDE_BUFFER} db4 (step {slide.step}): "
          f"{per_window * 1e3:.4f} ms a window, {per_window / slide.step * 1e6:.4f} us a "
          "sample (host clock)", flush=True)

    chunk = np.random.default_rng(SEED).standard_normal((4096, 1)).astype(np.float32)
    nticks = 1 << 22
    for backend in ("native", "python"):
        rb = native.RingBuffer(1 << 16, backend=backend)
        pushed = 0
        t0 = time.perf_counter()
        while pushed < nticks:
            pushed += rb.push(chunk)
            while rb.available >= SLIDE_BUFFER:
                if not rb.pop_frames(SLIDE_BUFFER, 407, max_frames=8).size:
                    break
        dt = time.perf_counter() - t0
        rb.close()
        print(f"  ring buffer push + pop_frames({SLIDE_BUFFER}, 407), {backend}: "
              f"{pushed / dt / 1e6:.1f} Mticks/s (host clock)", flush=True)
    ingest = st.StreamIngest(WAVELET, buffer_size=SLIDE_BUFFER, levels=INGEST_LEVELS,
                             capacity=1 << 16)
    pushed, frames = 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pushed < nticks:
        pushed += ingest.push(chunk)
        out = ingest.drain()
        frames += 0 if out is None else out.approx.shape[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  StreamIngest push + drain, {INGEST_LEVELS} levels, {frames} windows: "
          f"{pushed / dt / 1e6:.2f} Mticks/s (host clock, transforms on the card)",
          flush=True)
    return ms_of, bound


def halo_kernels_against_plain(dev, gen, worst, worst_bf16):
    """Phase 2 for the tiled tier's edges: the synthesis kernel's external
    right halo (row 4c) and the exact pair's halos (rows 7b and 8b) against
    their plain versions.  A halo of the span at the main path's shape, a
    short halo, planes shorter than the span, an exact plan split over two
    launches (sym8 J=10, where the wrapper runs on [halo | x]), and the
    synthesis once in bfloat16."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    # (wavelet, levels, batch, n, halo samples, dtype)
    cases = [
        (WAVELET, LEVELS, BATCH, N, 441, torch.float32),
        (WAVELET, LEVELS, 3, 5000, 100, torch.float32),
        (WAVELET, LEVELS, 2, 300, 441, torch.float32),
        ("sym8", 10, 2, 16384, 15345, torch.float32),  # exact: a split plan
        (WAVELET, LEVELS, BATCH, N, 441, torch.bfloat16),
    ]
    for name, levels, b, n, h, dtype in cases:
        wh = vt.wavelet(name)
        fd, fr = _kernel_filters(wh, synthesis=False), _kernel_filters(wh, synthesis=True)
        x = torch.randn(b, n, device=dev, generator=gen)
        planes = mc.analysis_plain(x, levels, fd, False)
        halo = tuple(torch.randn(b, h, device=dev, generator=gen) for _ in range(levels + 1))
        tag = f"{name} J={levels} {b}x{n} halo {h} {str(dtype)[6:]}"
        if mc.kernels_fit(wh.filter_length, levels):
            p_t = tuple(p.to(dtype) for p in planes)
            h_t = tuple(t.to(dtype) for t in halo)
            got = mc.synthesis(p_t, levels, fr, False, halo=h_t)
            want = mc.synthesis_plain(p_t, levels, fr, False, halo=h_t)
            torch.cuda.synchronize()
            err = max_err(got, want)
            if dtype == torch.float32:
                tol = TOL_F32
                worst["modwt_synthesis_external"] = max(worst["modwt_synthesis_external"], err)
            else:
                tol = BF16_ULP * want.float().abs().max().item()
                worst_bf16["modwt_synthesis_external"] = max(
                    worst_bf16["modwt_synthesis_external"], err)
            check(err <= tol, f"modwt_synthesis_external {tag}: max |kernel - plain| "
                              f"{err:.3e} <= {tol:.3e}")
        if dtype != torch.float32:
            continue
        plan = mc.exact_launches(mc.exact_analysis_shared_bytes, wh.filter_length, levels)
        how = "load rule" if mc._one_window(plan) else f"split plan, {len(plan)} launches"
        x_halo = torch.randn(b, h, device=dev, generator=gen)
        pairs = tuple(mc._split_pair(p.double()) for p in planes)
        halo_pairs = tuple(mc._split_pair(t.double() / 3) for t in halo)
        before = dict(mc.LAUNCHES)
        got = mc.exact_analysis(x, None, levels, fd, False, halo=x_halo)
        want = mc.exact_analysis_plain(x, None, levels, fd, False, halo=x_halo)
        y_got = mc.exact_synthesis(pairs, levels, fr, False, halo=halo_pairs)
        y_want = mc.exact_synthesis_plain(pairs, levels, fr, False, halo=halo_pairs)
        torch.cuda.synchronize()
        launched = {k: mc.LAUNCHES[k] - before[k] for k in mc.LAUNCHES}
        # a plan of one window launch reads the halo through the load rule and
        # counts under the halo's entry; a split plan runs on the extended
        # rows and counts under the kernel's own
        for kname, err, shared in (
                ("modwt_exact_analysis_halo", pair_err(got, want),
                 mc.exact_analysis_shared_bytes),
                ("modwt_exact_synthesis_halo", pair_err((y_got,), (y_want,)),
                 mc.exact_synthesis_shared_bytes)):
            worst[kname] = max(worst[kname], err)
            own = mc.exact_launches(shared, wh.filter_length, levels)
            counted_as, other = ((kname, kname[:-5]) if mc._one_window(own)
                                 else (kname[:-5], kname))
            count = launched[counted_as]
            check(err <= TOL_EXACT and count == len(own) and launched[other] == 0,
                  f"{kname} {tag} ({how}): max |kernel - plain| {err:.3e} <= "
                  f"{TOL_EXACT:.0e}, {count} launches under {counted_as}")
        del x, planes, halo, pairs, halo_pairs, got, want


def tiled_path(dev, gen):
    """Phase 3 for the parallel tier at full width, every mesh virtual
    shards on this card, each public call with its own reset and reading of
    the counters.  Returns the tiled rows' launches."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import parallel as par
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    total = {"modwt_analysis_external": 0, "modwt_synthesis_external": 0,
             "modwt_exact_analysis_halo": 0, "modwt_exact_synthesis_halo": 0}

    def counted(label, expect, fn):
        mc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == expect, f"{label}: launches {got}")
        for k, v in got.items():
            if k in total:
                total[k] += v
        return out

    def planes(res):
        return (*res.details, res.approx)

    def virtual(shape):
        return par.make_mesh(shape, devices=[dev] * math.prod(shape.values()))

    # the plain cascade in float32 and in float64, so the tiled kernels are
    # held against versions that run no kernel at the shapes the tiling
    # gives them ([B·T, N/T] rows with a halo of the span)
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    untiled = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, backend="torch")
    oracle = vt.modwt_multilevel(x.double(), WAVELET, levels=LEVELS, backend="torch")
    for shards in TILED_SHARDS:
        mesh = virtual({"signal": shards})
        label = f"{shards} shards, {BATCH}x{N} db4 J={LEVELS}"
        res = counted(f"modwt_multilevel_tiled {label}", {"modwt_analysis_external": 1},
                      lambda: par.modwt_multilevel_tiled(x, WAVELET, levels=LEVELS, mesh=mesh))
        y = counted(f"imodwt_multilevel_tiled {label}", {"modwt_synthesis_external": 1},
                    lambda: par.imodwt_multilevel_tiled(res, WAVELET, mesh=mesh))
        err = max(max_err(a, b) for a, b in zip(planes(res), planes(untiled)))
        syn_err = max_err(y, vt.imodwt_multilevel(res, WAVELET, backend="torch"))
        rmse = (y - x).pow(2).mean().sqrt().item()
        check(err <= TOL_F32 and syn_err <= TOL_F32 and rmse <= RT_RMSE,
              f"tiled {label} vs the untiled plain cascade: every plane {err:.3e}, the "
              f"inverse of the same planes {syn_err:.3e} <= {TOL_F32:.0e}; round trip "
              f"rmse {rmse:.3e} <= {RT_RMSE:.0e}")
        pairs = counted(f"modwt_multilevel_tiled_exact {label}",
                        {"modwt_exact_analysis_halo": 1},
                        lambda: par.modwt_multilevel_tiled_exact(x, WAVELET, levels=LEVELS,
                                                                 mesh=mesh))
        hi, lo = counted(f"imodwt_multilevel_tiled_exact {label}",
                         {"modwt_exact_synthesis_halo": 1},
                         lambda: par.imodwt_multilevel_tiled_exact(*pairs, WAVELET, mesh=mesh))
        combined = [p[0].double() + p[1].double() for p in (*pairs[0], pairs[1])]
        ana_err = max(max_err(a, b) for a, b in zip(combined, planes(oracle)))
        syn_err = max_err(hi.double() + lo.double(), vt.imodwt_multilevel(
            vt.MultiLevelMODWTResult(tuple(combined[:-1]), combined[-1]), WAVELET,
            backend="torch"))
        rmse = (hi.double() + lo.double() - x.double()).pow(2).mean().sqrt().item()
        check(ana_err <= EXACT_SYM and syn_err <= EXACT_SYM and rmse <= EXACT_RMSE,
              f"tiled exact {label} vs the float64 plain cascade: every plane "
              f"{ana_err:.3e}, the inverse of the same planes {syn_err:.3e} <= "
              f"{EXACT_SYM:.0e}; round trip rmse of hi + lo {rmse:.3e} <= {EXACT_RMSE:.0e}")
        del res, y, pairs, hi, lo, combined
    del untiled, oracle

    # the reference's fault shape: the periodic span (1785) outlasts the
    # signal, so the halo wraps twice; and a hop chain three shards deep
    for name, levels, b, n, shards in ((WAVELET, 8, 2, 1024, 8), ("db20", 6, 8, N, 64)):
        mesh = virtual({"signal": shards})
        xs = torch.randn(b, n, device=dev, generator=gen)
        span = (vt.wavelet(name).filter_length - 1) * ((1 << levels) - 1)
        label = f"{name} J={levels} {b}x{n} over {shards} shards (span {span})"
        res = counted(f"modwt_multilevel_tiled {label}", {"modwt_analysis_external": 1},
                      lambda: par.modwt_multilevel_tiled(xs, name, levels=levels, mesh=mesh))
        y = counted(f"imodwt_multilevel_tiled {label}", {"modwt_synthesis_external": 1},
                    lambda: par.imodwt_multilevel_tiled(res, name, mesh=mesh))
        ref = vt.modwt_multilevel(xs, name, levels=levels, backend="torch")
        err = max(max_err(a, r) for a, r in zip(planes(res), planes(ref)))
        check(err <= TOL_F32 and max_err(y, xs) <= RT_MAX,
              f"tiled {label} vs untiled plain transform: {err:.3e} <= {TOL_F32:.0e}; "
              f"round trip max {max_err(y, xs):.3e} <= {RT_MAX:.0e}")

    # BASELINE config #4: the batch facade on a one-card mesh
    xb = torch.randn(256, 16384, device=dev, generator=gen)
    one_card = par.make_mesh({"data": 1})
    res = counted("modwt_multilevel_sharded_batch 256x16384 db4 J=4", {"modwt_analysis": 1},
                  lambda: par.modwt_multilevel_sharded_batch(xb, WAVELET, levels=4,
                                                             mesh=one_card))
    ref = vt.modwt_multilevel(xb, WAVELET, levels=4)
    plain = vt.modwt_multilevel(xb, WAVELET, levels=4, backend="torch")
    err = max(max_err(a, p) for a, p in zip(planes(res), planes(plain)))
    check(all(torch.equal(a, r) for a, r in zip(planes(res), planes(ref))) and err <= TOL_F32,
          f"config #4 batch facade equals modwt_multilevel bit for bit, and the plain "
          f"cascade within {err:.3e} <= {TOL_F32:.0e}")

    hosts = par.make_multihost_mesh(2, 4, devices=[dev] * 8)
    res = counted(f"modwt_multilevel_multihost 2x4, {BATCH}x{N}",
                  {"modwt_analysis_external": 1},
                  lambda: par.modwt_multilevel_multihost(x, WAVELET, levels=LEVELS, mesh=hosts))
    y = counted(f"imodwt_multilevel_multihost 2x4, {BATCH}x{N}",
                {"modwt_synthesis_external": 1},
                lambda: par.imodwt_multilevel_multihost(res, WAVELET, mesh=hosts))
    ref = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, backend="torch")
    err = max(max_err(a, r) for a, r in zip(planes(res), planes(ref)))
    syn_err = max_err(y, vt.imodwt_multilevel(res, WAVELET, backend="torch"))
    rmse = (y - x).pow(2).mean().sqrt().item()
    check(err <= TOL_F32 and syn_err <= TOL_F32 and rmse <= RT_RMSE,
          f"multihost 2x4 vs the untiled plain cascade: {err:.3e}, its inverse "
          f"{syn_err:.3e} <= {TOL_F32:.0e}; round trip rmse {rmse:.3e} <= {RT_RMSE:.0e}")
    del res, y, ref

    img = torch.randn(*IMG, device=dev, generator=gen)
    rows4 = virtual({"rows": 4})
    res = counted("modwt2_multilevel_tiled db4 J=4 over 4 row shards (plain)", {},
                  lambda: par.modwt2_multilevel_tiled(img, WAVELET, levels=4, mesh=rows4))
    y = counted("imodwt2_multilevel_tiled db4 J=4 over 4 row shards (plain)", {},
                lambda: par.imodwt2_multilevel_tiled(res, WAVELET, mesh=rows4))
    ref = vt.modwt2_multilevel(img, WAVELET, levels=4)
    err = max(max_err(a, r) for a, r in zip(
        [p for t in res.details for p in t] + [res.approx],
        [p for t in ref.details for p in t] + [ref.approx]))
    check(err <= RT2_MAX and max_err(y, img) <= RT2_MAX,
          f"tiled 2-D {'x'.join(map(str, IMG))} vs modwt2_multilevel: {err:.3e}; round "
          f"trip max {max_err(y, img):.3e} <= {RT2_MAX:.0e}")
    del img, res, y, ref

    xs = torch.randn(8, N, device=dev, generator=gen)
    mesh = virtual({"signal": 8})
    res = counted(f"modwt_multilevel_tiled symmetric 8x{N} (plain)", {},
                  lambda: par.modwt_multilevel_tiled(xs, WAVELET, levels=LEVELS, mesh=mesh,
                                                     boundary="symmetric"))
    y = counted(f"imodwt_multilevel_tiled symmetric 8x{N} (plain)", {},
                lambda: par.imodwt_multilevel_tiled(res, WAVELET, mesh=mesh,
                                                    boundary="symmetric"))
    ref = vt.modwt_multilevel(xs, WAVELET, levels=LEVELS, boundary="symmetric", backend="torch")
    y_ref = vt.imodwt_multilevel(ref, WAVELET, boundary="symmetric", backend="torch")
    err = max(max_err(a, r) for a, r in zip(planes(res), planes(ref)))
    check(err <= TOL_F32 and max_err(y, y_ref) <= TOL_F32,
          f"tiled symmetric vs untiled plain: analysis {err:.3e}, synthesis "
          f"{max_err(y, y_ref):.3e} <= {TOL_F32:.0e}")
    print(f"  launches during the tiled path: {total}", flush=True)
    for k, v in total.items():
        check(v > 0, f"{k} launched {v} times on the tiled path")
    return total


def tiled_timing(dev, gen):
    """Phase 4 for rows 4c, 7b and 8b at the main path's shape with a halo of
    the span, and the tiled round trips beside the untiled one.  Returns
    ({row: (ms, plain ms, library ms)}, {row: (bound ms, by)})."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import parallel as par
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    w = vt.wavelet(WAVELET)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    span = mc.composite_halo_samples(w.filter_length, LEVELS)
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    x_halo = torch.randn(BATCH, span, device=dev, generator=gen)
    planes = mc.analysis(x, LEVELS, fd, True)
    halo = tuple(torch.randn(BATCH, span, device=dev, generator=gen) for _ in planes)
    pairs = mc.exact_analysis(x, None, LEVELS, fd, True)
    halo_pairs = tuple(mc._split_pair(t.double() / 3) for t in halo)
    bank_d = composite_bank(fd, LEVELS, dev, torch.float32)
    bank_r = composite_bank(fr, LEVELS, dev, torch.float32).flip(-1)
    ext = torch.cat([torch.stack(planes, 1), torch.stack(halo, 1)], -1)
    ext64 = torch.cat([torch.stack([mc._combine(*p) for p in pairs], 1),
                       torch.stack([mc._combine(*p) for p in halo_pairs], 1)], -1)
    hx64 = torch.cat([x_halo, x], -1).double()[:, None]
    lib_err = max_err(F.conv1d(ext, bank_r[None])[:, 0],
                      mc.synthesis(planes, LEVELS, fr, False, halo=halo))
    check(lib_err <= 1e-4, f"F.conv1d on [plane | halo] computes the external right halo "
                           f"({lib_err:.3e})")
    samples, taps = BATCH * N, w.filter_length
    halo_samples = BATCH * span
    rows = {
        "modwt_synthesis_external": (
            lambda: mc.synthesis(planes, LEVELS, fr, False, halo=halo),
            lambda: mc.synthesis_plain(planes, LEVELS, fr, False, halo=halo),
            lambda: F.conv1d(ext, bank_r[None]),
            # J + 1 planes and their halos in, x out
            4 * (LEVELS + 1) * (samples + halo_samples) + 4 * samples, FP32_FLOPS),
        "modwt_exact_analysis_halo": (
            lambda: mc.exact_analysis(x, None, LEVELS, fd, False, halo=x_halo),
            lambda: mc.exact_analysis_plain(x, None, LEVELS, fd, False, halo=x_halo),
            lambda: F.conv1d(hx64, bank_d.double()[:, None]),
            # x and its halo in, J + 1 pairs out
            4 * (samples + halo_samples) + 8 * (LEVELS + 1) * samples, FP64_FLOPS),
        "modwt_exact_synthesis_halo": (
            lambda: mc.exact_synthesis(pairs, LEVELS, fr, False, halo=halo_pairs),
            lambda: mc.exact_synthesis_plain(pairs, LEVELS, fr, False, halo=halo_pairs),
            lambda: F.conv1d(ext64, bank_r.double()[None]),
            # J + 1 pairs and their halo pairs in, one pair out
            8 * (LEVELS + 1) * (samples + halo_samples) + 8 * samples, FP64_FLOPS),
    }
    ms_of, bound = {}, {}
    for name, (kernel, plain, library_call, nbytes, rate) in rows.items():
        ms_of[name] = (median_ms(kernel), median_ms(plain), median_ms(library_call))
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = 2 * 2 * taps * LEVELS * samples / rate * 1e3
        bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        k_ms, p_ms, l_ms = ms_of[name]
        print(f"  {name} {BATCH}x{N}, halo {span}: kernel {k_ms:.4f} ms "
              f"({samples / k_ms / 1e3:.1f} Msamples/s), plain {p_ms:.4f} ms, library "
              f"{l_ms:.4f} ms, bound {bound[name][0]:.4f} ms ({bound[name][1]}; "
              f"{100 * bound[name][0] / k_ms:.1f}% of it)", flush=True)
    del planes, halo, pairs, halo_pairs, ext, ext64, hx64

    def untiled():
        return vt.imodwt_multilevel(vt.modwt_multilevel(x, WAVELET, levels=LEVELS), WAVELET)

    def tiled(mesh, exact=False):
        if exact:
            return par.imodwt_multilevel_tiled_exact(*par.modwt_multilevel_tiled_exact(
                x, WAVELET, levels=LEVELS, mesh=mesh), WAVELET, mesh=mesh)
        return par.imodwt_multilevel_tiled(par.modwt_multilevel_tiled(
            x, WAVELET, levels=LEVELS, mesh=mesh), WAVELET, mesh=mesh)

    meshes = {s: par.make_mesh({"signal": s}, devices=[dev] * s) for s in TILED_SHARDS}
    timed = [("modwt_multilevel + imodwt_multilevel (untiled)", untiled)]
    for s, mesh in meshes.items():
        timed.append((f"modwt_multilevel_tiled + imodwt_multilevel_tiled, {s} shards",
                      lambda mesh=mesh: tiled(mesh)))
    for s, mesh in meshes.items():
        timed.append((f"the tiled exact round trip, {s} shards",
                      lambda mesh=mesh: tiled(mesh, exact=True)))
    timed.append(("modwt_multilevel + imodwt_multilevel (untiled)", untiled))
    for label, fn in timed:
        t_ms = median_ms(fn)
        print(f"  {label}, {BATCH}x{N} db4 J={LEVELS}: {t_ms:.4f} ms "
              f"({samples / t_ms / 1e3:.1f} Msamples/s)", flush=True)
    return ms_of, bound


def count_collectives(dist) -> dict:
    """Wrap every function of ``COLLECTIVES`` with a counter; returns the
    live ``{name: calls}``, with the bytes that ``batch_isend_irecv`` sends
    under ``"sent_bytes"``."""
    from torch.distributed import distributed_c10d as c10d

    calls: dict = {}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            if name == "batch_isend_irecv":
                calls["sent_bytes"] = calls.get("sent_bytes", 0) + sum(
                    op.tensor.numel() * op.tensor.element_size() for op in args[0]
                    if op.op is c10d.isend)
            return fn(*args, **kwargs)
        return call

    for name in COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, counted(name, getattr(dist, name)))
    return calls


def rank_worker(argv) -> int:
    """One rank of the multi-process block (``chip_smoke.py --rank-worker
    BACKEND RANK WORLD STORE``): ``gloo`` ranks run the host x chip layout
    on their rows, ``nccl`` is the world of one.  Prints one ``RESULT`` line;
    any failed check raises."""
    import datetime

    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    backend, rank, world, store = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import parallel as par
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def launched(fn):
        mc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in mc.LAUNCHES.items() if v}

    def round_trip(mesh, x, boundary="periodic"):
        res = par.modwt_multilevel_multihost(x, WAVELET, levels=LEVELS, mesh=mesh,
                                             boundary=boundary)
        return res, par.imodwt_multilevel_multihost(res, WAVELET, mesh=mesh, boundary=boundary)

    gen = torch.Generator(device=dev).manual_seed(MP_SEED)
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    timeout = datetime.timedelta(seconds=MP_TIMEOUT)
    out = {"rank": rank, "backend": backend}
    if backend == "nccl":
        # the one-process facade first, with no process group
        one = par.make_multihost_mesh(1, 1, devices=[dev])
        (want, y_want), _ = launched(lambda: round_trip(one, x))
        dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0,
                                timeout=timeout)
        try:
            mesh = par.make_multihost_mesh()
            check(mesh.shape == {"host": 1, "chip": 1} and mesh.process_count == 1,
                  f"NCCL world of one: make_multihost_mesh() is {mesh.shape}")
            line = par.make_mesh(devices=[dev])
            check(line.is_local and line.shape == {"data": 1},
                  f"NCCL world of one: make_mesh is the one-process mesh {line.shape}")
            res, fwd = launched(lambda: par.modwt_multilevel_multihost(x, WAVELET, levels=LEVELS,
                                                                       mesh=mesh))
            y, inv = launched(lambda: par.imodwt_multilevel_multihost(res, WAVELET, mesh=mesh))
            same = all(torch.equal(a, b) for a, b in zip((*res.details, res.approx, y),
                                                       (*want.details, want.approx, y_want)))
            check(same and fwd == {"modwt_analysis_external": 1}
                  and inv == {"modwt_synthesis_external": 1},
                  f"NCCL world of one: the round trip equals the one-process facade bit for "
                  f"bit; launches {fwd}, {inv}")
            live = torch.ones(1, device=dev)
            dist.all_reduce(live)
            check(live.item() == 1.0, "NCCL world of one: all_reduce on the card")
            out["round_trip_ms"] = median_ms(lambda: round_trip(mesh, x))
        finally:
            dist.destroy_process_group()
        print("RESULT " + json.dumps(out), flush=True)
        return 0

    rows = BATCH // world
    x_full, x = x, x[rank * rows:(rank + 1) * rows].contiguous()
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=timeout)
    try:
        calls = count_collectives(dist)
        mesh = par.make_multihost_mesh(devices=[dev] * MP_CHIPS)
        check(mesh.shape == {"host": world, "chip": MP_CHIPS} and mesh.process_count == world
              and calls == {"all_gather_object": 1},
              f"rank {rank}: make_multihost_mesh is {mesh.shape}, its collectives {calls}")
        at_build = dict(calls)
        totals = {}
        for boundary in MP_BOUNDARIES:
            label = f"rank {rank}, rows {rank * rows}-{(rank + 1) * rows - 1}, {boundary}"
            kernel = boundary != "symmetric"
            res, fwd = launched(lambda: par.modwt_multilevel_multihost(
                x, WAVELET, levels=LEVELS, mesh=mesh, boundary=boundary))
            y, inv = launched(lambda: par.imodwt_multilevel_multihost(
                res, WAVELET, mesh=mesh, boundary=boundary))
            check(fwd == ({"modwt_analysis_external": 1} if kernel else {})
                  and inv == ({"modwt_synthesis_external": 1} if kernel else {}),
                  f"{label}: launches {fwd} forward, {inv} inverse")
            for k, v in (*fwd.items(), *inv.items()):
                totals[k] = totals.get(k, 0) + v
            ref = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary=boundary,
                                      backend="torch")
            err = max(max_err(a, b) for a, b in zip((*res.details, res.approx),
                                                    (*ref.details, ref.approx)))
            syn_err = max_err(y, vt.imodwt_multilevel(res, WAVELET, boundary=boundary,
                                                      backend="torch"))
            rmse = (y - x).pow(2).mean().sqrt().item()
            check(err <= TOL_F32 and syn_err <= TOL_F32
                  and (rmse <= RT_RMSE or boundary != "periodic"),
                  f"{label} vs the one-process plain cascade: every plane {err:.3e}, the "
                  f"inverse of the same planes {syn_err:.3e} <= {TOL_F32:.0e}; round trip "
                  f"rmse {rmse:.3e}" + (f" <= {RT_RMSE:.0e}" if boundary == "periodic" else ""))
        check(calls == at_build, f"rank {rank}: no torch.distributed call during the "
                                 f"transforms ({calls})")
        out["launches"] = totals
        # the round trip alone on the card (each rank in turn), then both at once
        alone = None
        for turn in range(world):
            dist.barrier()
            if turn == rank:
                alone = median_ms(lambda: round_trip(mesh, x))
        dist.barrier()
        out["round_trip_ms_alone"] = alone
        out["round_trip_ms"] = median_ms(lambda: round_trip(mesh, x))
        out.update(signal_across_ranks(rank, world, dev, x_full, calls, launched))
    finally:
        dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def signal_across_ranks(rank, world, dev, x_full, calls, launched) -> dict:
    """The signal axis across the ranks (in a Gloo rank of
    :func:`rank_worker`): a ``{"signal": 8}`` mesh of both ranks' four
    virtual shards of the card, each rank holding all 128 rows and its half
    of the samples.  Config #2 periodic, zero and symmetric, the tiled exact
    round trip and the tiled CWT at config #5, each with its launches and
    its exchanges (``batch_isend_irecv`` calls and bytes sent, held to the
    halo arithmetic and to the exchange module's own count); then the round
    trip timed with both ranks at once (every call exchanges) and, each rank
    in turn, its own block on a one-process mesh of its four shards."""
    import torch.distributed as dist

    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import parallel as par
    from vectorwave_tpu_torch.parallel import exchange

    sig = par.make_mesh({"signal": world * MP_CHIPS}, devices=[dev] * MP_CHIPS)
    check(sig.shape == {"signal": world * MP_CHIPS} and not sig.is_local
          and sig.local_devices == [dev] * MP_CHIPS,
          f"rank {rank}: make_mesh across the ranks is {sig.shape}, "
          f"{len(sig.local_devices)} cells this rank's")
    block = par.local_index(sig, x_full.shape, axis="signal")
    cols = block[-1]
    head, tail = cols.start == 0, cols.stop == N
    xb = x_full[block].contiguous()
    out = {"signal_columns": [cols.start, cols.stop], "exchanges": {}}
    launches: dict = {}
    span = (vt.wavelet(WAVELET).filter_length - 1) * ((1 << LEVELS) - 1)
    halo_bytes = BATCH * span * 4

    def exchanged(label, expect, fn):
        before = dict(calls)
        exchange.reset_traffic()
        res, got = launched(fn)
        moved = {k: v - before.get(k, 0) for k, v in calls.items() if v != before.get(k, 0)}
        sent = moved.get("sent_bytes", 0)
        out["exchanges"][label] = [moved.get("batch_isend_irecv", 0), sent]
        same = (exchange.TRAFFIC["calls"] == moved.get("batch_isend_irecv", 0)
                and exchange.TRAFFIC["bytes"] == sent
                and set(moved) <= {"batch_isend_irecv", "sent_bytes"})
        want = expect if expect is None else tuple(expect)
        check(same and (want is None or (moved.get("batch_isend_irecv", 0), sent) == want),
              f"rank {rank}, {label}: {moved.get('batch_isend_irecv', 0)} batch_isend_irecv "
              f"calls, {sent} bytes sent (the exchange module counts "
              f"{exchange.TRAFFIC['calls']}, {exchange.TRAFFIC['bytes']}"
              + ("" if want is None else f"; the halo arithmetic {want}") + ")")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return res, got

    label = f"rank {rank}, {BATCH}x{cols.start}-{cols.stop - 1} of a {{'signal': 8}} mesh"
    for boundary in MP_BOUNDARIES:
        kernel = boundary != "symmetric"
        # the halo arithmetic: one cumulative left halo of the span forward,
        # the J + 1 planes' right halos in one exchange inverse (the kernel
        # route); the plain symmetric route a left halo a level forward
        fwd_bytes = 0 if boundary != "periodic" and tail else halo_bytes
        inv_bytes = 0 if boundary == "zero" and head else (LEVELS + 1) * halo_bytes
        res, fwd = exchanged(f"{boundary} forward", (LEVELS if not kernel else 1, fwd_bytes),
                             lambda: par.modwt_multilevel_tiled(
                                 xb, WAVELET, levels=LEVELS, mesh=sig, boundary=boundary))
        y, inv = exchanged(f"{boundary} inverse", (1, inv_bytes) if kernel else None,
                           lambda: par.imodwt_multilevel_tiled(res, WAVELET, mesh=sig,
                                                               boundary=boundary))
        check(fwd == ({"modwt_analysis_external": 1} if kernel else {})
              and inv == ({"modwt_synthesis_external": 1} if kernel else {}),
              f"{label}, {boundary}: launches {fwd} forward, {inv} inverse")
        ref = vt.modwt_multilevel(x_full, WAVELET, levels=LEVELS, boundary=boundary,
                                  backend="torch")
        err = max(max_err(a, b[block]) for a, b in zip((*res.details, res.approx),
                                                       (*ref.details, ref.approx)))
        syn_err = max_err(y, vt.imodwt_multilevel(ref, WAVELET, boundary=boundary,
                                                  backend="torch")[block])
        rmse = (y - xb).pow(2).mean().sqrt().item()
        check(err <= TOL_F32 and syn_err <= TOL_F32
              and (rmse <= RT_RMSE or boundary != "periodic"),
              f"{label}, {boundary} vs the one-process plain cascade: every plane {err:.3e}, "
              f"the inverse {syn_err:.3e} <= {TOL_F32:.0e}; round trip rmse {rmse:.3e}"
              + (f" <= {RT_RMSE:.0e}" if boundary == "periodic" else ""))
        del ref, res, y
    pairs, ex_fwd = exchanged("exact forward", (1, halo_bytes), lambda:
                              par.modwt_multilevel_tiled_exact(xb, WAVELET, levels=LEVELS,
                                                               mesh=sig))
    (hi, lo), ex_inv = exchanged("exact inverse", (1, 2 * (LEVELS + 1) * halo_bytes), lambda:
                                 par.imodwt_multilevel_tiled_exact(*pairs, WAVELET, mesh=sig))
    rmse = (hi.double() + lo.double() - xb.double()).pow(2).mean().sqrt().item()
    check(ex_fwd == {"modwt_exact_analysis_halo": 1}
          and ex_inv == {"modwt_exact_synthesis_halo": 1} and rmse <= EXACT_RMSE,
          f"{label}, the tiled exact round trip: launches {ex_fwd}, {ex_inv}; rmse of hi + lo "
          f"{rmse:.3e} <= {EXACT_RMSE:.0e}")
    del pairs, hi, lo
    x5 = torch.randn(1, CFG5_N, device=dev, generator=torch.Generator(device=dev).manual_seed(
        MP_SEED + 1))
    blk5 = par.local_index(sig, x5.shape, axis="signal")
    for boundary in ("zero", "periodic"):
        got, _ = exchanged(f"cwt_tiled config #5 {boundary}", None, lambda: par.cwt_tiled(
            x5[blk5], CFG5_SCALES, CWT_WAVELET, mesh=sig, boundary=boundary))
        want = vt.cwt(x5, CFG5_SCALES, CWT_WAVELET, boundary=boundary).coeffs
        err = max_err(got.coeffs, want[..., blk5[-1]]) / want.abs().max().item()
        check(err <= TOL_CWT, f"rank {rank}, cwt_tiled config #5 {boundary}, samples "
                              f"{blk5[-1].start}-{blk5[-1].stop - 1} over 8 shards of two "
                              f"ranks vs the one-card cwt: {err:.3e} of the largest "
                              f"coefficient <= {TOL_CWT:.0e}")
        del got, want
    out["signal_launches"] = launches
    own = par.Mesh([dev] * MP_CHIPS, ("signal",))

    def round_trip(mesh):
        return par.imodwt_multilevel_tiled(par.modwt_multilevel_tiled(
            xb, WAVELET, levels=LEVELS, mesh=mesh), WAVELET, mesh=mesh)

    alone = None
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            alone = median_ms(lambda: round_trip(own))
    dist.barrier()
    out["signal_round_trip_ms"] = median_ms(lambda: round_trip(sig))
    out["signal_own_block_ms_alone"] = alone
    return out


def run_ranks(backend: str, world: int) -> list:
    """Start ``world`` rank workers on one ``file://`` store in a temporary
    directory, wait at most ``MP_TIMEOUT`` s for all of them (killing every
    one past it), echo their output and return their results in rank order.
    A rank that fails, hangs or prints no result fails the phase, with its
    stderr's tail."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks") as tmp:
        procs, logs = [], []
        for rank in range(world):
            logs.append((os.path.join(tmp, f"rank{rank}.out"),
                         os.path.join(tmp, f"rank{rank}.err")))
            with open(logs[-1][0], "w") as fo, open(logs[-1][1], "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), RANK_WORKER, backend, str(rank),
                     str(world), os.path.join(tmp, "store")], stdout=fo, stderr=fe))
        deadline = time.monotonic() + MP_TIMEOUT
        hung = []
        for rank, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                hung.append(rank)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        results, faults = [], []
        for rank, (proc, (out, err)) in enumerate(zip(procs, logs)):
            with open(out) as fo, open(err) as fe:
                lines, tail = fo.read().splitlines(), fe.read()[-3000:]
            for line in lines:
                if not line.startswith("RESULT "):
                    print(f"  [{backend} rank {rank}] {line.strip()}", flush=True)
            found = [json.loads(ln[len("RESULT "):]) for ln in lines if ln.startswith("RESULT ")]
            if rank in hung or proc.returncode != 0 or len(found) != 1:
                print(f"  [{backend} rank {rank}] stderr:\n{tail}", file=sys.stderr, flush=True)
                hang = f"hung past {MP_TIMEOUT} s, killed; " if rank in hung else ""
                faults.append(f"rank {rank}: {hang}exit code {proc.returncode}, "
                              f"{len(found)} results")
            else:
                results.append(found[0])
    check(not faults, f"{backend} ranks: " + ("; ".join(faults) if faults else
                                              f"{world} of {world} returned their results"))
    return results


def multiprocess_path():
    """Phase 3 for the multi-process run: two ranks on this card over Gloo
    (each its own 64 rows over a row of four virtual shards of the host x
    chip layout, then all the rows and its half of the samples of the
    signal axis across the ranks; every boundary, the launches, the
    collectives and the exchanges counted in the rank), then the NCCL world
    of one.  Returns (the rows' launches, the ranks' results)."""
    t0 = time.perf_counter()
    ranks = run_ranks("gloo", MP_RANKS)
    world_of_one = run_ranks("nccl", 1)
    total = {}
    for res in ranks:
        for got in (res["launches"], res["signal_launches"]):
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
    # a rank: periodic and zero on the host x chip row and on the signal
    # mesh, one launch each way; the exact round trip on the signal mesh
    check(total == {"modwt_analysis_external": 4 * MP_RANKS,
                    "modwt_synthesis_external": 4 * MP_RANKS,
                    "modwt_exact_analysis_halo": MP_RANKS,
                    "modwt_exact_synthesis_halo": MP_RANKS},
          f"the ranks' launches on the multi-process path: {total}")
    for res in ranks:
        print(f"  rank {res['rank']}, samples {res['signal_columns'][0]}-"
              f"{res['signal_columns'][1] - 1}: exchanges (batch_isend_irecv calls, bytes "
              f"sent) {res['exchanges']}", flush=True)
    print(f"  the multi-process block took {time.perf_counter() - t0:.1f} s", flush=True)
    return total, {"gloo": ranks, "nccl": world_of_one}


def multiprocess_timing(dev, gen, smi, ranks):
    """Phase 4 for the multi-process block: each rank's round trip of its 64
    rows (alone on the card, and with both ranks at once; CUDA events in the
    rank, measured in phase 3), each rank's round trip of its half of the
    samples across the ranks (both at once) and of the same block on its own
    four shards (alone), the NCCL world of one's round trip, and in this
    process the one-process 8-shard mesh, the 2x4 mesh and the untiled round
    trip at 128x65536 and 64x65536."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import parallel as par

    rows = BATCH // MP_RANKS
    for res in ranks["gloo"]:
        print(f"  rank {res['rank']} of {MP_RANKS} (Gloo), {rows}x{N} over {MP_CHIPS} virtual "
              f"shards: round trip {res['round_trip_ms']:.4f} ms with both ranks at once, "
              f"{res['round_trip_ms_alone']:.4f} ms alone ({smi})", flush=True)
    for res in ranks["gloo"]:
        print(f"  rank {res['rank']} of {MP_RANKS} (Gloo), {BATCH}x{N // MP_RANKS} of a "
              f"{{'signal': {MP_RANKS * MP_CHIPS}}} mesh across the ranks: round trip "
              f"{res['signal_round_trip_ms']:.4f} ms with both ranks at once (the halos "
              f"staged through host memory); its block on a one-process mesh of its "
              f"{MP_CHIPS} shards, alone: {res['signal_own_block_ms_alone']:.4f} ms ({smi})",
              flush=True)
    (one,) = ranks["nccl"]
    print(f"  NCCL world of one, {BATCH}x{N} on make_multihost_mesh() (1x1): round trip "
          f"{one['round_trip_ms']:.4f} ms ({smi})", flush=True)
    shards = MP_RANKS * MP_CHIPS
    eight = par.make_mesh({"signal": shards}, devices=[dev] * shards)
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    t_ms = median_ms(lambda: par.imodwt_multilevel_tiled(par.modwt_multilevel_tiled(
        x, WAVELET, levels=LEVELS, mesh=eight), WAVELET, mesh=eight))
    print(f"  modwt_multilevel_tiled + imodwt_multilevel_tiled, one process {shards} shards, "
          f"{BATCH}x{N}: {t_ms:.4f} ms ({smi})", flush=True)
    hosts = par.make_multihost_mesh(2, 4, devices=[dev] * 8)
    for b in (BATCH, rows):
        xb = x[:b].contiguous()
        for label, fn in (
            ("modwt_multilevel_multihost + imodwt_multilevel_multihost, one process 2x4",
             lambda: par.imodwt_multilevel_multihost(par.modwt_multilevel_multihost(
                 xb, WAVELET, levels=LEVELS, mesh=hosts), WAVELET, mesh=hosts)),
            ("modwt_multilevel + imodwt_multilevel (untiled)",
             lambda: vt.imodwt_multilevel(vt.modwt_multilevel(xb, WAVELET, levels=LEVELS),
                                          WAVELET)),
        ):
            t_ms = median_ms(fn)
            print(f"  {label}, {b}x{N}: {t_ms:.4f} ms ({t_ms / b * 1e3:.3f} µs a row; {smi})",
                  flush=True)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` ending in a synchronise: what a
    caller waits for a host-bound call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def bandlimited_image(shape, lo, hi, seed):
    """A zero-mean image whose radial frequencies lie in (lo, hi)
    cycles/sample, made on the host from a seed (float32)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape)
    ky, kx = np.meshgrid(np.fft.fftfreq(shape[-2]), np.fft.fftfreq(shape[-1]), indexing="ij")
    r = np.hypot(ky, kx)
    img = np.real(np.fft.ifft2(np.fft.fft2(img) * ((r > lo) & (r < hi))))
    return (img - img.mean(axis=(-2, -1), keepdims=True)).astype(np.float32)


def per_level_rel(got, want) -> float:
    """The largest relative difference of one level's estimate."""
    return ((got.double() - want.double()).abs() / want.double().abs()).max().item()


def analysis_inputs(dev, gen):
    """The inputs of the default-depth and analysis paths, made on the card
    from the seed (the 2-D images and the multifractal walk on the host)."""
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    y = 0.6 * x + 0.8 * torch.randn(BATCH, N, device=dev, generator=gen)
    t = torch.arange(N, device=dev, dtype=torch.float32)
    tones = (torch.sin(2 * math.pi * 0.03 * t) + 0.8 * torch.sin(2 * math.pi * 0.11 * t)
             + 0.6 * torch.sin(2 * math.pi * 0.3 * t))
    walk = np.cumsum(np.random.default_rng(SEED).standard_normal(LONG_N)).astype(np.float32)
    return {
        "x": x, "y": y,
        "long": torch.randn(LONG_N, device=dev, generator=gen),
        "stepped": torch.cat([torch.cat([x[:1, :VAR_STEP], 3.0 * x[:1, VAR_STEP:]], -1), x[1:]]),
        "tones": (tones + 0.05 * torch.randn(BATCH, N, device=dev, generator=gen)).contiguous(),
        "walk": torch.from_numpy(walk).to(dev),
        "ints": torch.randint(-(1 << 15), 1 << 15, (BATCH, N), device=dev, generator=gen,
                              dtype=torch.int32),
        "scat": torch.randn(8, 16384, device=dev, generator=gen),
        "img256": torch.from_numpy(bandlimited_image((256, 256), 0.03, 0.3, 1)).to(dev),
        "img1k": torch.from_numpy(bandlimited_image((1, 1024, 1024), 0.03, 0.3, 2)).to(dev),
        "img128": torch.randn(1, 128, 128, device=dev, generator=gen),
    }


def analysis_path(dev, gen):
    """Phase 3 for the default-depth MODWT, the 1-D analysis modules and the
    2-D CWT, each call with its own reset and reading of the counters: the
    default-depth round trip (db4 and sym8 with no ``levels``, J = 9, and db4
    J = 10) at 128x65536, one analysis and one synthesis launch, against the
    plain route; the variance family (one analysis launch a transform) and
    ``hurst_exponent`` against the plain route; the variance stream on the
    kernel step (one external-edge launch a block) against the whole
    signal's variance; ``variance_change_test``, ``multifractal_spectrum``,
    the lifting round trips, the EWT, 1-D scattering, ``cwt2`` -> ``icwt2``
    and 2-D scattering (no launch) against float64 on the CPU at a cut of
    the same call or an identity.  Returns the launches, the stream's
    counted as the external edge's."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import streaming as st

    t0 = time.perf_counter()
    total = {}
    data = analysis_inputs(dev, gen)
    x, y = data["x"], data["y"]
    def planes(r):
        return (*r.details, r.approx)

    for name, levels in DEFAULT_DEPTH_CASES:
        label = f"{name} {'no levels' if levels is None else f'J={levels}'} {BATCH}x{N}"
        res = counted_launches(f"modwt_multilevel {label}", {"modwt_analysis": 1},
                               lambda: vt.modwt_multilevel(x, name, levels=levels), total)
        back = counted_launches(f"imodwt_multilevel {label}", {"modwt_synthesis": 1},
                                lambda: vt.imodwt_multilevel(res, name), total)
        with backend("torch"):
            ref = vt.modwt_multilevel(x, name, levels=levels)
            back_ref = vt.imodwt_multilevel(ref, name)
        err = max(max_err(g, r) for g, r in zip(planes(res), planes(ref)))
        check(res.levels == (levels or 9) and err <= TOL_F32
              and max_err(back, back_ref) <= TOL_F32,
              f"default-depth route {label} (J={res.levels}) vs the plain route: planes "
              f"{err:.3e}, inverse {max_err(back, back_ref):.3e} <= {TOL_F32:.0e}")
        del res, back, ref, back_ref

    def against_plain(label, expect, call):
        got = counted_launches(label, expect, call, total)
        with backend("torch"):
            want = call()
        return got, want

    for label, signal, levels in ((f"{BATCH}x{N} no levels", x, None),
                                  (f"1x{LONG_N} J=6", data["long"], 6)):
        got, want = against_plain(f"wavelet_variance {label}", {"modwt_analysis": 1},
                                  lambda: vt.wavelet_variance(signal, WAVELET, levels))
        err = per_level_rel(got.variance, want.variance)
        check(got.n_levels == (levels or 9) and err <= TOL_VAR
              and bool((got.ci_low <= got.variance).all()),
              f"wavelet_variance {label} (J={got.n_levels}) vs the plain route: {err:.3e} "
              f"<= {TOL_VAR:.0e} per level")
    cov, cov_ref = against_plain("wavelet_covariance", {"modwt_analysis": 2},
                                 lambda: vt.wavelet_covariance(x, y, WAVELET)[0])
    rho, rho_ref = against_plain("wavelet_correlation", {"modwt_analysis": 4},
                                 lambda: vt.wavelet_correlation(x, y, WAVELET)[0])
    one = counted_launches("wavelet_correlation of x with x", {"modwt_analysis": 4},
                           lambda: vt.wavelet_correlation(x, x, WAVELET)[0], total)
    err = max(per_level_rel(cov, cov_ref), per_level_rel(rho, rho_ref))
    check(err <= TOL_VAR and (one - 1).abs().max().item() <= 1e-5,
          f"covariance and correlation {BATCH}x{N} vs the plain route {err:.3e} <= "
          f"{TOL_VAR:.0e}; correlation of x with x within {(one - 1).abs().max().item():.2e} "
          "of 1")
    walk = torch.cumsum(x, dim=-1)
    for model, signal, lo in (("fgn", x, 1), ("fbm", walk, 3)):
        got, want = against_plain(f"hurst_exponent {model}", {"modwt_analysis": 1},
                                  lambda: vt.hurst_exponent(signal, WAVELET, model=model,
                                                            min_level=lo))
        h = got.hurst.mean().item()
        err = (got.hurst - want.hurst).abs().max().item()
        check(abs(h - 0.5) <= 0.05 and err <= TOL_VAR,
              f"hurst_exponent {model} {BATCH}x{N}: mean H {h:.4f} (0.5 +- 0.05), vs the "
              f"plain route {err:.3e} <= {TOL_VAR:.0e}")
    del walk

    # the variance stream: 8 blocks of 8192 through the kernel-tier step
    streams = x.reshape(STREAM_B, STREAM_NBLK, STREAM_BLK).transpose(0, 1).contiguous()
    state = st.kernel_streaming_init(WAVELET, LEVELS, batch_shape=(STREAM_B,), device=dev)
    acc = vt.variance_stream_init(WAVELET, LEVELS, batch_shape=(STREAM_B,), device=dev)
    stream_launches = {}
    for i, blk in enumerate(streams):
        state, res = counted_launches(f"modwt_stream_block_kernel block {i}",
                                      {"modwt_analysis_external": 1},
                                      lambda: st.modwt_stream_block_kernel(
                                          state, blk, WAVELET, levels=LEVELS),
                                      stream_launches)
        acc = vt.variance_stream_update(acc, res.details, WAVELET)
    total["modwt_analysis_external"] = stream_launches.get("modwt_analysis_external", 0)
    whole = counted_launches("wavelet_variance of the whole streams", {"modwt_analysis": 1},
                             lambda: vt.wavelet_variance(x, WAVELET, LEVELS), total)
    err = per_level_rel(vt.variance_stream_result(acc).variance, whole.variance)
    check(acc.position == N and total["modwt_analysis_external"] == STREAM_NBLK
          and err <= TOL_VAR,
          f"variance stream {STREAM_B} x {STREAM_NBLK} x {STREAM_BLK}: "
          f"{total['modwt_analysis_external']} launches, vs wavelet_variance of the whole "
          f"{err:.3e} <= {TOL_VAR:.0e}")
    del streams, state, acc, res

    for level in (1, 4):
        got = counted_launches(f"variance_change_test level {level}", {},
                               lambda: vt.variance_change_test(data["stepped"], WAVELET,
                                                               level=level), total)
        ref = vt.variance_change_test(small_cpu(data["stepped"][1:2]), WAVELET, level=level)
        err = abs(got.statistic[1].item() - ref.statistic[0].item()) / ref.statistic[0].item()
        where = int(got.location[0])
        check(bool(got.reject[0]) and abs(where - VAR_STEP) <= 1024 and err <= TOL_VAR,
              f"variance_change_test level {level}: the stepped row rejected at {where} "
              f"(step at {VAR_STEP}); a constant row's statistic vs float64 on the CPU "
              f"{err:.3e} <= {TOL_VAR:.0e}")

    walk = data["walk"]
    got = counted_launches(f"multifractal_spectrum 1x{LONG_N}", {},
                           lambda: vt.multifractal_spectrum(walk, "db3"), total)
    check(all(bool(torch.isfinite(getattr(got, f)).all()) for f in ("zeta", "h", "D")),
          f"multifractal_spectrum 1x{LONG_N}: finite")
    cut = walk[: 1 << 16]
    got = vt.multifractal_spectrum(cut, "db3")
    ref = vt.multifractal_spectrum(small_cpu(cut), "db3")
    err = max((getattr(got, f).cpu().double() - getattr(ref, f)).abs().max().item()
              for f in ("zeta", "h", "D", "c1", "c2"))
    check(err <= TOL_VAR, f"multifractal_spectrum 2^16 cut vs float64 on the CPU: {err:.3e} "
                          f"<= {TOL_VAR:.0e}")

    dec = counted_launches("lifting_wavedec cdf97 J=6", {},
                           lambda: vt.lifting_wavedec(x, "cdf97", levels=LEVELS), total)
    back = vt.lifting_waverec(dec, "cdf97")
    rmse = ((back - x).pow(2).mean().sqrt() / x.abs().max()).item()
    fcut = x[:2, :4096]
    fgot = vt.lifting_wavedec(fcut, "cdf97", levels=LEVELS)
    fref = vt.lifting_wavedec(small_cpu(fcut), "cdf97", levels=LEVELS)
    fpairs = list(zip((*fgot.details, fgot.approx), (*fref.details, fref.approx)))
    ferr = (max((g.cpu().double() - r).abs().max().item() for g, r in fpairs)
            / max(r.abs().max().item() for _, r in fpairs))
    ints = data["ints"]
    idec = counted_launches("lifting_wavedec_int legall53 J=6", {},
                            lambda: vt.lifting_wavedec_int(ints, "legall53", levels=LEVELS),
                            total)
    small = ints[:2, :4096]
    same = all(torch.equal(g.cpu(), r) for g, r in zip(
        *(lambda a, b: ((*a.details, a.approx), (*b.details, b.approx)))(
            vt.lifting_wavedec_int(small, "legall53", levels=LEVELS),
            vt.lifting_wavedec_int(small.cpu(), "legall53", levels=LEVELS))))
    check(rmse <= RT_RMSE and ferr <= TOL_VAR and same
          and torch.equal(vt.lifting_waverec_int(idec, "legall53"), ints),
          f"lifting cdf97 J=6 {BATCH}x{N}: round trip RMSE {rmse:.3e} <= {RT_RMSE:.0e} of max, "
          f"its forward vs float64 on the CPU on 2x4096 {ferr:.3e} <= {TOL_VAR:.0e} of max; "
          "int32 legall53 round trip equal, and its forward equal to the CPU's on 2x4096")
    del dec, back, idec

    x16 = data["tones"][:1, :16384].contiguous()
    modes = counted_launches("ewt 1x16384, 4 bands", {},
                             lambda: vt.ewt(x16, EWT_BOUNDS), total)
    err16 = (vt.iewt(modes, EWT_BOUNDS) - x16).abs().max().item() / x16.abs().max().item()
    tones = data["tones"]
    bounds = counted_launches(f"ewt_boundaries {BATCH}x{N}", {},
                              lambda: vt.ewt_boundaries(tones, 3), total)
    ref_bounds = vt.ewt_boundaries(tones.cpu().double(), 3)
    modes = vt.ewt(tones, bounds)
    err = (vt.iewt(modes, bounds) - tones).abs().max().item() / tones.abs().max().item()
    analytic = counted_launches(f"ewt_hilbert {BATCH}x{N}", {},
                                lambda: vt.ewt_hilbert(tones, bounds), total)
    err_h = (analytic.real - modes).abs().max().item() / modes.abs().max().item()
    check(max(err16, err, err_h) <= 1e-5 and len(bounds) == 2
          and all(abs(a - b) <= 1.0 / N for a, b in zip(bounds, ref_bounds))
          and 0.03 < bounds[0] < 0.11 < bounds[1] < 0.3,
          f"EWT: 1x16384 round trip {err16:.2e}, {BATCH}x{N} round trip {err:.2e}, hilbert "
          f"{err_h:.2e} <= 1e-5 of max; boundaries {bounds} (CPU float64 {ref_bounds})")
    del modes, analytic

    scat = data["scat"]
    got = counted_launches("scattering1d 8x16384 J=6 Q=8", {},
                           lambda: vt.scattering1d(scat, J=6, Q=8), total)
    ref = vt.scattering1d(small_cpu(scat[:2]), J=6, Q=8)
    err = max(rel_err(getattr(got, f)[:2].cpu(), getattr(ref, f)) for f in ("s0", "s1", "s2"))
    check(got.pairs == ref.pairs and err <= TOL_VAR,
          f"scattering1d 8x16384 order 2 ({len(got.xi1)} + {len(got.pairs)} paths) vs float64 "
          f"on the CPU: {err:.3e} <= {TOL_VAR:.0e} of max")

    for key, scales in (("img256", CWT2_SCALES_256), ("img1k", CWT2_SCALES_1K)):
        img = data[key]
        shape = "x".join(map(str, img.shape))
        res = counted_launches(f"cwt2 {shape}, {len(scales)} x {len(CWT2_ANGLES)}", {},
                               lambda: vt.cwt2(img, scales, "morl2", angles=CWT2_ANGLES), total)
        rec = counted_launches(f"icwt2 {shape}", {}, lambda: vt.icwt2(res, "morl2"), total)
        err = (rec - img).abs().max().item() / img.abs().max().item()
        check(res.coeffs.shape == img.shape[:-2] + (len(scales), len(CWT2_ANGLES)) + img.shape[-2:]
              and res.coeffs.dtype == torch.complex64 and err <= 1e-5,
              f"cwt2 -> icwt2 {shape}, {len(scales)} scales x {len(CWT2_ANGLES)} angles: "
              f"in-band round trip {err:.3e} <= 1e-5 of max")
        if key == "img256":
            ref = vt.cwt2(small_cpu(img[:64, :64]), scales, "morl2", angles=CWT2_ANGLES)
            got = vt.cwt2(img[:64, :64].contiguous(), scales, "morl2", angles=CWT2_ANGLES)
            err = rel_err(got.coeffs.cpu(), ref.coeffs)
            check(err <= TOL_VAR, f"cwt2 64x64 cut vs float64 on the CPU: {err:.3e} <= "
                                  f"{TOL_VAR:.0e} of max")
        del res, rec
    img = data["img128"]
    got = counted_launches("scattering2d 128x128 J=3 L=6", {},
                           lambda: vt.scattering2d(img, J=3, L=6), total)
    ref = vt.scattering2d(small_cpu(img), J=3, L=6)
    err = max(rel_err(getattr(got, f).cpu(), getattr(ref, f)) for f in ("s0", "s1", "s2"))
    check(err <= TOL_VAR, f"scattering2d 128x128 order 2 ({len(got.pairs)} pairs) vs float64 on "
                          f"the CPU: {err:.3e} <= {TOL_VAR:.0e} of max")
    print(f"  launches during the analysis path: {total}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return total


def analysis_timing(dev, gen):
    """Phase 4 for the default-depth MODWT and the analysis paths: each call
    of phase 3 timed with CUDA events and on the host clock, and the
    default-depth round trip on the plain route, the route the gate took
    before it asked for the pair's room alone."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import streaming as st

    t0 = time.perf_counter()
    data = analysis_inputs(dev, gen)
    x, y = data["x"], data["y"]
    walk = torch.cumsum(x, dim=-1)
    streams = x.reshape(STREAM_B, STREAM_NBLK, STREAM_BLK).transpose(0, 1).contiguous()

    def round_trip(name, levels, route):
        def run():
            with backend(route):
                return vt.imodwt_multilevel(vt.modwt_multilevel(x, name, levels=levels), name)
        return run

    def variance_stream():
        state = st.kernel_streaming_init(WAVELET, LEVELS, batch_shape=(STREAM_B,), device=dev)
        acc = vt.variance_stream_init(WAVELET, LEVELS, batch_shape=(STREAM_B,), device=dev)
        for blk in streams:
            state, res = st.modwt_stream_block_kernel(state, blk, WAVELET, levels=LEVELS)
            acc = vt.variance_stream_update(acc, res.details, WAVELET)
        return vt.variance_stream_result(acc)

    res256 = vt.cwt2(data["img256"], CWT2_SCALES_256, "morl2", angles=CWT2_ANGLES)
    res1k = vt.cwt2(data["img1k"], CWT2_SCALES_1K, "morl2", angles=CWT2_ANGLES)
    bounds = vt.ewt_boundaries(data["tones"], 3)
    x16 = data["tones"][:1, :16384].contiguous()
    rows = []
    for name, levels in DEFAULT_DEPTH_CASES:
        label = f"{name} {'no levels' if levels is None else f'J={levels}'}"
        for route in ("auto", "torch"):
            rows.append((f"modwt_multilevel -> imodwt_multilevel {label} {BATCH}x{N}, "
                         f"{'kernel' if route == 'auto' else 'plain'} route",
                         round_trip(name, levels, route), 20))
    rows += [
        (f"wavelet_variance {BATCH}x{N} no levels (J=9)",
         lambda: vt.wavelet_variance(x, WAVELET), 20),
        (f"wavelet_variance 1x{LONG_N} J=6", lambda: vt.wavelet_variance(data["long"], WAVELET, 6),
         20),
        (f"wavelet_covariance {BATCH}x{N}", lambda: vt.wavelet_covariance(x, y, WAVELET), 20),
        (f"wavelet_correlation {BATCH}x{N}", lambda: vt.wavelet_correlation(x, y, WAVELET), 20),
        (f"hurst_exponent fgn {BATCH}x{N}", lambda: vt.hurst_exponent(x, WAVELET), 20),
        (f"hurst_exponent fbm {BATCH}x{N}",
         lambda: vt.hurst_exponent(walk, WAVELET, model="fbm", min_level=3), 20),
        (f"variance stream {STREAM_B} x {STREAM_NBLK} x {STREAM_BLK} J=6", variance_stream, 10),
        (f"variance_change_test level 1 {BATCH}x{N}",
         lambda: vt.variance_change_test(data["stepped"], WAVELET, level=1), 20),
        (f"variance_change_test level 4 {BATCH}x{N}",
         lambda: vt.variance_change_test(data["stepped"], WAVELET, level=4), 20),
        (f"multifractal_spectrum db3 1x{LONG_N}",
         lambda: vt.multifractal_spectrum(data["walk"], "db3"), 10),
        (f"lifting_wavedec -> lifting_waverec cdf97 J=6 {BATCH}x{N}",
         lambda: vt.lifting_waverec(vt.lifting_wavedec(x, "cdf97", levels=LEVELS), "cdf97"), 20),
        (f"lifting_wavedec_int -> waverec_int legall53 J=6 {BATCH}x{N}",
         lambda: vt.lifting_waverec_int(vt.lifting_wavedec_int(data["ints"], "legall53",
                                                               levels=LEVELS), "legall53"), 20),
        ("ewt -> iewt 1x16384, 4 bands", lambda: vt.iewt(vt.ewt(x16, EWT_BOUNDS), EWT_BOUNDS), 20),
        (f"ewt -> iewt {BATCH}x{N}, 3 bands",
         lambda: vt.iewt(vt.ewt(data["tones"], bounds), bounds), 20),
        (f"ewt_boundaries {BATCH}x{N}, 3 bands", lambda: vt.ewt_boundaries(data["tones"], 3), 1),
        (f"ewt_hilbert {BATCH}x{N}, 3 bands", lambda: vt.ewt_hilbert(data["tones"], bounds), 20),
        ("scattering1d order 2 8x16384 J=6 Q=8", lambda: vt.scattering1d(data["scat"]), 20),
        ("cwt2 256x256, 8 scales x 8 angles",
         lambda: vt.cwt2(data["img256"], CWT2_SCALES_256, "morl2", angles=CWT2_ANGLES), 20),
        ("icwt2 256x256, 8 scales x 8 angles", lambda: vt.icwt2(res256, "morl2"), 20),
        ("cwt2 1x1024x1024, 16 scales x 8 angles",
         lambda: vt.cwt2(data["img1k"], CWT2_SCALES_1K, "morl2", angles=CWT2_ANGLES), 10),
        ("icwt2 1x1024x1024, 16 scales x 8 angles", lambda: vt.icwt2(res1k, "morl2"), 10),
        ("scattering2d order 2 128x128 J=3 L=6",
         lambda: vt.scattering2d(data["img128"], J=3, L=6), 20),
    ]
    for label, fn, reps in rows:  # a host-bound row timed once takes one warm-up
        t_ms = median_ms(fn, min(3, reps), reps)
        w_ms = wall_ms(fn, min(reps, 5))
        print(f"  {label}: {t_ms:.4f} ms (wall {w_ms:.4f} ms)", flush=True)
    del res256, res1k
    print(f"  the analysis rows took {time.perf_counter() - t0:.1f} s", flush=True)


def blur_spectrum(n, taps, width, dev):
    """The rfft of a centred Gaussian blur of ``taps`` taps (peak at index 0),
    for a circular blur of rows of ``n``."""
    t = np.arange(taps) - taps // 2
    k = np.exp(-0.5 * (t / width) ** 2)
    k = np.fft.ifftshift(k / k.sum())
    return k, torch.from_numpy(np.fft.rfft(k, n=n).astype(np.complex64)).to(dev)


def piecewise_smooth(shape, seed):
    """Rows of a few sines with a step: sparse in a wavelet frame."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / n
    rows = []
    for _ in range(int(np.prod(shape[:-1]))):
        f = rng.uniform(2, 40, 3)
        row = sum(np.sin(2 * np.pi * fi * t + rng.uniform(0, 6)) for fi in f)
        row[int(rng.uniform(0.2, 0.8) * n):] += rng.uniform(-1, 1)
        rows.append(row)
    return np.asarray(rows, dtype=np.float32).reshape(shape)


def texture(shape, seed):
    """A zero-mean oriented weave (the JAX packet2 tests' texture) on
    ``[..., H, W]``, of a period of 16 pixels or more."""
    yy, xx = np.mgrid[0:shape[-2], 0:shape[-1]]
    rng = np.random.default_rng(seed)
    kx, ky = rng.integers(3, shape[-1] // 16, 2)
    img = np.sin(2 * np.pi * (kx * xx / shape[-1] + ky * yy / shape[-2]))
    return np.broadcast_to(img, shape).astype(np.float32)


def optimize_inputs(dev, gen):
    """The inputs of the sparse solvers, the deconvolutions, the block
    denoise and the decimated 2-D trees: made on the card from the seed, or
    on the host from it for the structured signals and images."""
    clean = torch.from_numpy(piecewise_smooth((1, OPT_LONG), 1)).to(dev)
    mask = (torch.rand(1, OPT_LONG, device=dev, generator=gen) >= OPT_MISSING).float()
    x = torch.from_numpy(piecewise_smooth((BATCH, N), 2)).to(dev)
    kernel, spec = blur_spectrum(N, OPT_BLUR_TAPS, 4.0, dev)
    cs_true = torch.from_numpy(piecewise_smooth((8, N), 3)).to(dev)
    g = np.exp(-0.5 * ((np.arange(7) - 3) / 1.5) ** 2)
    psf = np.outer(g, g) / np.outer(g, g).sum()  # a 7x7 PSF, peak at (3, 3)
    img = torch.from_numpy(texture(IMG, 4)).to(dev)
    psf_full = np.zeros(IMG[1:], np.float32)
    psf_full[:7, :7] = psf
    blurred2 = torch.fft.irfft2(torch.fft.rfft2(img) * torch.fft.rfft2(
        torch.from_numpy(psf_full).to(dev)), s=IMG[1:])
    tex256 = torch.from_numpy(texture((256, 256), 5)).to(dev)
    yy, xx = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512), indexing="ij")
    smooth = (np.sin(2 * np.pi * 2 * xx) * np.cos(2 * np.pi * yy)
              + 0.5 * np.sin(2 * np.pi * (xx + yy)))[None].astype(np.float32)
    return {
        "clean": clean, "mask": mask, "observed": torch.where(mask > 0, clean, torch.nan),
        "x": x, "noisy": x + 0.3 * torch.randn(BATCH, N, device=dev, generator=gen),
        "blur_kernel": kernel, "blur": spec,
        "blurred": (torch.fft.irfft(torch.fft.rfft(x) * spec, n=N)
                    + 0.05 * torch.randn(BATCH, N, device=dev, generator=gen)),
        "cs_true": cs_true,
        "cs_meas": (torch.fft.irfft(torch.fft.rfft(cs_true) * spec, n=N)
                    + 0.01 * torch.randn(8, N, device=dev, generator=gen)),
        "psf": psf, "img": img,
        "blurred2": blurred2 + 0.05 * torch.randn(IMG, device=dev, generator=gen),
        "noisy_img": img + 0.4 * torch.randn(IMG, device=dev, generator=gen),
        "tex256": tex256,
        "noisy256": tex256 + 0.4 * torch.randn(256, 256, device=dev, generator=gen),
        "smooth": torch.from_numpy(smooth).to(dev),
        "mask2": (torch.rand(1, 512, 512, device=dev, generator=gen) > 0.3).float(),
        "img512": torch.from_numpy(texture((512, 512), 6)).to(dev),
    }


def optimize_calls(data):
    """The slice's public calls as (label, the call) pairs, in the order of
    phase 3, each at the shape it is driven at."""
    import vectorwave_tpu_torch as vt

    spec = data["blur"]

    def blur(v):
        return torch.fft.irfft(torch.fft.rfft(v) * spec, n=N)

    img = data["img"]
    return {
        "inpaint": lambda: vt.inpaint(data["observed"], data["mask"], "db8", steps=OPT_STEPS),
        "bpdn": lambda: vt.bpdn(data["noisy"], WAVELET, steps=OPT_BPDN_STEPS).signal,
        "sparse_recover": lambda: vt.sparse_recover(
            data["cs_meas"], blur, WAVELET, signal_shape=(8, N), lam=1e-3, lam_init=0.1,
            steps=OPT_BPDN_STEPS).signal,
        "deconvolve": lambda: vt.deconvolve(data["blurred"], data["blur_kernel"], "sym8"),
        "deconvolve2": lambda: vt.deconvolve2(data["blurred2"], data["psf"], "sym8"),
        "denoise_block": lambda: vt.denoise_block(data["noisy"], WAVELET),
        "wpt2": lambda: vt.iwpt2(vt.wpt2(img, "sym8", 3), "sym8"),
        "best_basis_denoise2 256": lambda: vt.best_basis_denoise2(
            data["noisy256"], "sym8", 3, threshold=1.2, cost="risk", cost_threshold=1.2,
            mode="hard"),
        "best_basis_denoise2": lambda: vt.best_basis_denoise2(
            data["noisy_img"], "sym8", 3, threshold=1.2, cost="risk", cost_threshold=1.2,
            mode="hard"),
        "denoise_packet2 256": lambda: vt.denoise_packet2(data["noisy256"], "sym8", 3),
        "denoise_packet2": lambda: vt.denoise_packet2(data["noisy_img"], "sym8", 3),
        "dtcwt2 512": lambda: vt.idtcwt2(vt.dtcwt2(data["img512"], levels=4)),
        "dtcwt2": lambda: vt.idtcwt2(vt.dtcwt2(img, levels=4)),
        "dtcwt2_denoise": lambda: vt.dtcwt2_denoise(data["noisy_img"], levels=4),
        "inpaint2": lambda: vt.inpaint2(data["smooth"] * data["mask2"], data["mask2"], "db4",
                                        levels=OPT_2D_LEVELS, steps=OPT_2D_STEPS),
    }


def optimize_path(dev, gen):
    """Phase 3 for the sparse solvers, the deconvolutions, the block denoise,
    the decimated 2-D trees and the infrastructure, each call with its own
    reset and reading of the counters.  The solvers take one cascade
    synthesis and one cascade analysis launch a FISTA step, the first
    analysis and the final synthesis beside them; the deconvolutions the
    cascade pair (1-D, 4 levels) or the 2-D pair (one launch a level each
    way and one for the 2-D noise probe); the block denoise one launch each
    way; the trees none.  Each is held against the plain route on the card
    (the deconvolutions in soft mode, whose output moves continuously with
    the coefficients), float64 on the CPU at a cut, or an identity.  Returns
    the launches."""
    import tempfile

    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import cost_model, observability

    t0 = time.perf_counter()
    total = {}
    data = optimize_inputs(dev, gen)
    calls = optimize_calls(data)
    two = {"modwt_analysis": OPT_BPDN_STEPS + 1, "modwt_synthesis": OPT_BPDN_STEPS + 1}
    for name, expect, label in (
        ("inpaint", {"modwt_analysis": OPT_STEPS + 1, "modwt_synthesis": OPT_STEPS + 1},
         f"inpaint db8 J=8 1x{OPT_LONG}, {OPT_MISSING:.0%} missing, {OPT_STEPS} steps"),
        ("bpdn", two, f"bpdn db4 J=8 {BATCH}x{N}, {OPT_BPDN_STEPS} steps"),
        ("sparse_recover", two, f"sparse_recover db4 J=8, circular blur, 8x{N}, "
                                f"{OPT_BPDN_STEPS} steps"),
    ):
        got = counted_launches(label, expect, calls[name], total)
        with backend("torch"):
            want = calls[name]()
        err = rel_err(got, want)
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and err <= TOL_FISTA_CARD,
              f"{label} vs the plain route: {err:.3e} <= {TOL_FISTA_CARD:.0e} of max")
        if name == "inpaint":
            miss = data["mask"] == 0
            fill = ((got - data["clean"])[miss].pow(2).mean().sqrt()
                    / data["clean"].std()).item()
            check(fill <= 0.1 and torch.equal(got[~miss], data["clean"][~miss]),
                  f"{label}: missing samples restored to {fill:.3e} <= 0.1 of the std; "
                  "observed samples kept")
        del got, want

    x = data["x"]
    got = counted_launches(f"deconvolve sym8 J=4 {BATCH}x{N}, {OPT_BLUR_TAPS}-tap blur",
                           {"modwt_analysis": 1, "modwt_synthesis": 1}, calls["deconvolve"], total)
    err_in = (data["blurred"] - x).pow(2).mean().sqrt().item()
    err_out = (got.signal - x).pow(2).mean().sqrt().item()
    soft = lambda: vt.deconvolve(data["blurred"], data["blur_kernel"], "sym8",  # noqa: E731
                                 mode="soft").signal
    got_soft = counted_launches("deconvolve soft", {"modwt_analysis": 1, "modwt_synthesis": 1},
                                soft, total)
    with backend("torch"):
        want_soft = soft()
    err = rel_err(got_soft, want_soft)
    check(err_out < err_in and err <= TOL_F32_REL,
          f"deconvolve {BATCH}x{N}: RMSE {err_in:.4f} -> {err_out:.4f}; soft vs the plain route "
          f"{err:.3e} <= {TOL_F32_REL:.0e} of max")
    del got, got_soft, want_soft

    levels2 = 3  # deconvolve2's default depth
    expect2 = {"modwt2_analysis": levels2 + 1, "modwt2_synthesis": levels2}
    got = counted_launches(f"deconvolve2 sym8 J={levels2} {'x'.join(map(str, IMG))}", expect2,
                           calls["deconvolve2"], total)
    img = data["img"]
    err_in = (data["blurred2"] - img).pow(2).mean().sqrt().item()
    err_out = (got.signal - img).pow(2).mean().sqrt().item()
    soft2 = lambda: vt.deconvolve2(data["blurred2"], data["psf"], "sym8",  # noqa: E731
                                   mode="soft").signal
    got_soft = counted_launches("deconvolve2 soft", expect2, soft2, total)
    with backend("torch"):
        want_soft = soft2()
    err = rel_err(got_soft, want_soft)
    check(err_out < err_in and err <= TOL_F32_REL,
          f"deconvolve2 {'x'.join(map(str, IMG))}: RMSE {err_in:.4f} -> {err_out:.4f}; soft vs "
          f"the plain route {err:.3e} <= {TOL_F32_REL:.0e} of max")
    del got, got_soft, want_soft

    got = counted_launches(f"denoise_block db4 no levels (J=9) {BATCH}x{N}",
                           {"modwt_analysis": 1, "modwt_synthesis": 1}, calls["denoise_block"],
                           total)
    with backend("torch"):
        want = calls["denoise_block"]()
    err = rel_err(got, want)
    snr_in = (x.pow(2).sum() / (data["noisy"] - x).pow(2).sum()).log10().item() * 10
    snr_out = (x.pow(2).sum() / (got - x).pow(2).sum()).log10().item() * 10
    check(err <= TOL_BLOCK_CARD and snr_out > snr_in + 3,
          f"denoise_block {BATCH}x{N}: SNR {snr_in:.2f} -> {snr_out:.2f} dB; vs the plain route "
          f"{err:.3e} <= {TOL_BLOCK_CARD:.0e} of max")
    del got, want

    # the decimated 2-D trees: no kernel route
    shape = "x".join(map(str, IMG))
    rec = counted_launches(f"wpt2 -> iwpt2 sym8 depth 3 {shape}", {}, calls["wpt2"], total)
    err = rel_err(rec, img)
    cut = data["noisy_img"][0, :64, :64]
    tree = vt.wpt2(cut.contiguous(), "sym8", 3)
    ref = vt.wpt2(small_cpu(cut), "sym8", 3)
    err_cut = max(rel_err(g.cpu(), r) for g, r in zip(tree.levels, ref.levels))
    check(err <= 1e-5 and err_cut <= 1e-5,
          f"wpt2 -> iwpt2 {shape}: round trip {err:.3e} <= 1e-5 of max; the 64x64 cut's tree vs "
          f"float64 on the CPU {err_cut:.3e} <= 1e-5")
    for label, key, clean in (("256x256", " 256", data["tex256"]), (shape, "", img)):
        noisy = data["noisy256"] if key else data["noisy_img"]
        mse_in = (noisy - clean).pow(2).mean().item()
        for fn in ("best_basis_denoise2", "denoise_packet2"):
            got = counted_launches(f"{fn} sym8 depth 3 {label}", {}, calls[fn + key], total)
            mse = (got - clean).pow(2).mean().item()
            check(bool(torch.isfinite(got).all()) and mse < 0.6 * mse_in,
                  f"{fn} {label}: MSE {mse_in:.4f} -> {mse:.4f} (< 0.6x)")
            del got
    for label, key, src in (("512x512", " 512", data["img512"]), (shape, "", img)):
        rec = counted_launches(f"dtcwt2 -> idtcwt2 4 levels {label}", {}, calls["dtcwt2" + key],
                               total)
        err = (rec - src).abs().max().item()
        check(err <= 2e-5, f"dtcwt2 -> idtcwt2 {label}: round trip {err:.3e} <= 2e-5")
    res = vt.dtcwt2(cut.contiguous(), levels=3)
    ref = vt.dtcwt2(small_cpu(cut), levels=3)
    err_cut = max(rel_err(g.cpu(), r) for g, r in zip(res.highpasses, ref.highpasses))
    check(res.highpasses[0].dtype == torch.complex64 and err_cut <= 1e-5,
          f"dtcwt2 64x64 cut vs float64 on the CPU: {err_cut:.3e} <= 1e-5 of max")
    got = counted_launches(f"dtcwt2_denoise 4 levels {shape}", {}, calls["dtcwt2_denoise"], total)
    mse_in = (data["noisy_img"] - img).pow(2).mean().item()
    mse = (got - img).pow(2).mean().item()
    check(bool(torch.isfinite(got).all()) and mse < 0.5 * mse_in,
          f"dtcwt2_denoise {shape}: MSE {mse_in:.4f} -> {mse:.4f} (< 0.5x)")
    del got, rec, res

    # inpaint2: the 2-D pair for the probe, the first analysis and the last
    # synthesis; every step's gradient on the plain 2-D cascade
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    mc.reset_launches()
    got = calls["inpaint2"]()
    torch.cuda.synchronize()
    seen = {k: v for k, v in mc.LAUNCHES.items() if v}
    for k, v in seen.items():
        total[k] = total.get(k, 0) + v
    miss = data["mask2"] == 0
    fill = ((got - data["smooth"])[miss].pow(2).mean().sqrt() / data["smooth"].std()).item()
    check(seen == {"modwt2_analysis": OPT_2D_LEVELS + 1, "modwt2_synthesis": OPT_2D_LEVELS}
          and fill <= 0.1,
          f"inpaint2 db4 J={OPT_2D_LEVELS} 1x512x512, {OPT_2D_STEPS} steps: launches {seen} (its "
          f"gradient on the plain 2-D cascade); missing pixels restored to {fill:.3e} <= 0.1")
    del got

    # the infrastructure
    with tempfile.TemporaryDirectory() as tmp:
        old = os.environ.get("VECTORWAVE_TPU_TORCH_CACHE")
        os.environ["VECTORWAVE_TPU_TORCH_CACHE"] = tmp
        try:
            before = cost_model.estimate_processing_time(N, levels=LEVELS, batch=BATCH)
            rate = cost_model.calibrate()
            after = cost_model.estimate_processing_time(N, levels=LEVELS, batch=BATCH)
            stored = json.loads(open(os.path.join(tmp, "performance.json")).read())
        finally:
            if old is None:
                os.environ.pop("VECTORWAVE_TPU_TORCH_CACHE")
            else:
                os.environ["VECTORWAVE_TPU_TORCH_CACHE"] = old
        key = f"cuda:{torch.cuda.get_device_name(0)}"
        check(not before.calibrated and after.calibrated and key in stored and rate > 0,
              f"cost_model.calibrate() on the card: {rate:.6e} samples/s (db4 J=6 float32 round "
              f"trip, 8x16384 and 8x65536), kept as {key!r}; the {BATCH}x{N} estimate "
              f"{before.estimated_seconds * 1e3:.4f} ms (default) -> "
              f"{after.estimated_seconds * 1e3:.4f} ms (calibrated)")
        info = vt.get_performance_info()
        check(info.platform == "cuda" and info.cuda_kernels and info.device_count >= 1,
              f"get_performance_info(): {info.description}")
        observability.stats.reset()
        with observability.throughput_meter("round trip", BATCH * N):
            vt.imodwt_multilevel(vt.modwt_multilevel(x, WAVELET, levels=LEVELS), WAVELET)
        secs = observability.stats.get("round trip.seconds")
        check(secs > 0, f"throughput_meter around one {BATCH}x{N} round trip: "
                        f"{BATCH * N / secs / 1e6:.1f} Msamples/s (host clock, synchronised)")
        with observability.profiler_trace(os.path.join(tmp, "trace")) as log_dir:
            vt.imodwt_multilevel(vt.modwt_multilevel(x, WAVELET, levels=LEVELS), WAVELET)
        files = os.listdir(log_dir)
        size = sum(os.path.getsize(os.path.join(log_dir, f)) for f in files)
        check(len(files) == 1 and size > 0, f"profiler_trace: {files} ({size} bytes)")
    print(f"  launches during the optimisation and 2-D tree path: {total}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return total


def optimize_timing(dev, gen):
    """Phase 4 for this slice's calls: CUDA events and the host clock from
    the same runs (3 warm-ups and 20 runs; 5 runs for a call over 100 ms, 3
    over a second, after the first), medians, and each call's kernel
    launches from its first run."""
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    t0 = time.perf_counter()
    data = optimize_inputs(dev, gen)
    for label, fn in optimize_calls(data).items():
        torch.cuda.synchronize()
        mc.reset_launches()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - start) * 1e3
        launches = sum(mc.LAUNCHES.values())
        warm, reps = (0, 3) if once > 1000 else (0, 5) if once > 100 else (3, 20)
        for _ in range(warm):
            fn()
        dev_ms, host_ms = [], []
        for _ in range(reps):
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            begin.record()
            fn()
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - h0) * 1e3)
            dev_ms.append(begin.elapsed_time(end))
        dev_ms.sort()
        host_ms.sort()
        print(f"  {label}: {dev_ms[reps // 2]:.4f} ms (wall {host_ms[reps // 2]:.4f} ms, first "
              f"call {once:.4f} ms, {launches} kernel launches)", flush=True)
    print(f"  the optimisation and 2-D tree rows took {time.perf_counter() - t0:.1f} s", flush=True)


#: the kernels each example launches on the card at its own sizes; phase 5
#: fails if one of them is not launched
EXAMPLE_KERNELS = {
    "basic_transforms": ("modwt_analysis", "modwt_synthesis"),
    "denoising_demo": ("modwt_denoise",),
    "fused_denoise_demo": ("modwt_denoise", "modwt_analysis", "modwt_synthesis"),
    "swt_demo": ("modwt_analysis", "modwt_synthesis"),
    "swt_best_practices": ("modwt_analysis", "modwt_synthesis"),
    "dwt_and_kernels_demo": ("modwt_analysis", "modwt_synthesis"),
    "tolerance_routing_demo": ("modwt_exact_analysis", "modwt_exact_synthesis"),
    "extended_symlets_demo": ("modwt_analysis", "modwt_synthesis", "modwt_denoise"),
    "wavelet_selection_guide": ("modwt_analysis", "modwt_denoise"),
    "image_processing_2d": ("modwt2_analysis", "modwt2_synthesis"),
    "wavelet_packets_demo": ("modwt_bank_analysis", "modwt_bank_synthesis"),
    "dtcwt_demo": ("modwt_bank_analysis", "modwt_bank_synthesis"),
    "deconvolution_demo": ("modwt_analysis", "modwt_synthesis", "modwt2_analysis",
                           "modwt2_synthesis"),
    "sparse_recovery_demo": ("modwt_analysis", "modwt_synthesis"),
    "wavelet_variance_demo": ("modwt_analysis",),
    "streaming_demo": ("modwt_analysis", "modwt_denoise"),
    "checkpoint_resume_demo": ("modwt_analysis",),
    "memory_and_flush_demo": ("modwt_analysis",),
    "native_ingest_demo": ("modwt_analysis",),
    "calibration_demo": ("modwt_analysis", "modwt_synthesis"),
    "financial_demo": ("modwt_denoise",),
    "portfolio_risk": ("modwt_analysis",),
    "realtime_market_monitor": ("modwt_analysis",),
    "trading_signals": ("modwt_analysis",),
    "parallel_denoising": ("modwt_denoise",),
}
#: the parallel tier's examples, which print parity figures instead of
#: following a recording (``tests/test_torch_examples.py``'s check)
PARITY_EXAMPLES = ("multihost_demo", "distributed_demo", "parallel_denoising")
TOL_EXAMPLE_PARITY = 1e-5


def mirror_cases_path(dev, phase: str, family: str, cases) -> dict:
    """Phase 2b (2c): the kernel-reaching cases of the MODWT core's (the
    other kernel families') test mirrors (``tools/mirror_cases.py``) at the
    JAX tests' own shapes, each through the public entry points under
    ``auto`` and under ``backend='kernel'``, held against the plain route on
    the card; the route of each direction held to the gate, and
    ``kernel``'s refusals to where the kernels cannot serve.  Prints a line
    a case, the launches by kernel and one summary line; any fault fails the
    phase.  Phase 2d runs the streaming and parallel tiers' cases the same
    way, phase 2e the CWT family's and phase 2f the 1-D analysis modules'.
    Returns the phase's launches by kernel."""
    from tools import mirror_cases
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    print(f"phase {phase}: {family} mirrored test cases on the card, under auto and "
          "backend='kernel', against the plain route", flush=True)
    t0 = time.perf_counter()
    mc.reset_launches()
    outcomes = []
    for case in cases:
        out = mirror_cases.run_case(case, dev)
        outcomes.append(out)
        routes = ", ".join(f"{k} {v}" for k, v in out.routes.items())
        worst = max((e / b for _, e, b in out.errors), default=0.0)
        print(f"  {'ok  ' if out.ok else 'FAIL'} mirror {case.label}: {routes}; "
              f"worst error / bound {worst:.3f}"
              + ("" if out.ok else f"; {'; '.join(out.faults)}"), flush=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in mc.LAUNCHES.items() if v}
    s = mirror_cases.summary(outcomes)
    print(f"  mirror launches {json.dumps(launched)}", flush=True)
    print(f"  mirror summary: {s['cases']} cases, {s['auto_kernel']} on a kernel and "
          f"{s['auto_plain']} on the plain route under auto, {s['kernel_only']} through a "
          f"kernel entry point alone, {s['kernel_refused']} refused under backend='kernel' "
          f"({s['refused_by_design']} with a refusal by design); "
          "worst error against each bound "
          + ", ".join(f"{e:.3e} <= {b}" for b, e in s["worst"].items())
          + f"; {seconds:.1f} s", flush=True)
    check(s["faults"] == 0, f"mirror cases: {s['faults']} faults in {s['cases']} cases")
    return launched


def facade_on_the_card(dev, gen) -> None:
    """The end of phase 2g: ``facade.circular_convolve_modwt`` on a CUDA
    tensor (db4 on 2 x 256 float32, which the card's gate sends to the FFT
    route) against ``atrous_convolve`` on the card, within 2e-5."""
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.ops import convolve, facade

    filt = vt.wavelet("db4").dec_lo / math.sqrt(2.0)
    x = torch.randn(2, 256, device=dev, generator=gen)
    fft = facade.should_use_fft(x.shape[-1], len(filt), device=x.device)
    err = max_err(facade.circular_convolve_modwt(x, filt),
                  convolve.atrous_convolve(x, filt, boundary="periodic"))
    print(f"  facade circular_convolve_modwt db4 2x256: the "
          f"{'FFT' if fft else 'rolled'} route, max |facade - atrous_convolve| {err:.3e}",
          flush=True)
    check(fft and err <= TOL_F32, f"facade circular_convolve_modwt on the FFT route within "
                                  f"{TOL_F32:.0e} of atrous_convolve: {err:.3e}")


def examples_path(total: dict) -> None:
    """Phase 5: every ``examples/torch/*.py`` on the card, each against the
    recording of its JAX counterpart, with its launches (added to
    ``total``)."""
    import re
    import tempfile

    from tools.example_figures import EXAMPLES, run_and_compare, run_counted
    from vectorwave_tpu_torch import cost_model

    parity = re.compile(r"(?:single-device|round trip|vs one call)[^:]*:? ([0-9.]+e[+-][0-9]+)")
    times = {}
    real_store = cost_model._store_path
    with tempfile.TemporaryDirectory(prefix="vw_examples_") as store:
        cost_model._store_path = lambda: os.path.join(store, "performance.json")
        try:
            for path in sorted(EXAMPLES.glob("*.py")):
                name = path.stem
                t0 = time.perf_counter()
                if name in PARITY_EXAMPLES:
                    out, got = run_counted(name, ())
                else:
                    problems, got = run_and_compare(name, ())
                times[name] = time.perf_counter() - t0
                print(f"example {name}: {times[name]:.2f} s, launches {got}", flush=True)
                if name in PARITY_EXAMPLES:
                    figures = [float(f) for f in parity.findall(out)]
                    check(bool(figures) and max(figures) <= TOL_EXAMPLE_PARITY,
                          f"{name}: parity figures {figures} <= {TOL_EXAMPLE_PARITY:.0e}")
                else:
                    check(not problems, f"{name} against its JAX recording"
                          + "".join(f"\n      {p}" for p in problems))
                named = EXAMPLE_KERNELS.get(name, ())
                ran = {MODE_OF.get(k, k) for k in got}
                missing = [k for k in named if k not in ran]
                check(not missing, f"{name} launches {', '.join(named) or 'no named kernel'}"
                      + (f" (not {missing})" if missing else ""))
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
        finally:
            cost_model._store_path = real_store
    slowest = sorted(times, key=times.get, reverse=True)[:3]
    print(f"  the {len(times)} examples took {sum(times.values()):.1f} s; slowest "
          + ", ".join(f"{n} {times[n]:.2f} s" for n in slowest), flush=True)
    check(len(times) == 40, f"{len(times)} examples of examples/torch ran")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a "
              "CUDA device", file=sys.stderr)
        return 1
    run_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vectorwave_tpu_torch as vt
    from tools import mirror_cases
    from vectorwave_tpu_torch.denoise.denoiser import _fused_sigma
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt2 as k2
    from vectorwave_tpu_torch.kernels import modwt_cascade as mx
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters
    from vectorwave_tpu_torch.ops.thresholds import universal_threshold

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    smi = nvidia_smi()

    print("phase 0: device", flush=True)
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"  built {os.path.basename(lib._name)} from "
          f"{len([p for p in _build.sources() if p.suffix == '.cu'])} sources in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    print("phase 2: kernels against their plain versions (db4, 6 levels)", flush=True)
    w = vt.wavelet(WAVELET)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    worst = {name: 0.0 for name in KERNELS}
    worst_bf16 = {name: 0.0 for name in KERNELS}
    cases = [
        (BATCH, N, True, torch.float32),
        (3, 5000, False, torch.float32),
        (2, 300, True, torch.float32),
        (BATCH, N, True, torch.bfloat16),
    ]
    for b, n, periodic, dtype in cases:
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        label = f"{b}x{n} {'periodic' if periodic else 'zero'} {str(dtype)[6:]}"
        plain = mc.analysis_plain(x, LEVELS, fd, periodic)
        results = [
            ("modwt_analysis", "", mc.analysis(x, LEVELS, fd, periodic), plain),
            ("modwt_synthesis", "",
             mc.synthesis(plain, LEVELS, fr, periodic),
             mc.synthesis_plain(plain, LEVELS, fr, periodic)),
        ]
        th = gap_thresholds(mc._analysis_cascade(x, LEVELS, fd, periodic), LEVELS)
        for mode in ("none", "soft", "hard"):
            results.append((
                "modwt_denoise", f" {mode}",
                mc.denoise(x, th, LEVELS, fd, fr, periodic, mode),
                mc.denoise_plain(x, th, LEVELS, fd, fr, periodic, mode),
            ))
        torch.cuda.synchronize()
        for name, tag, got, want in results:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_err(g, p) for g, p in zip(got, want))
            if dtype == torch.float32:
                tol = TOL_F32
                worst[name] = max(worst[name], err)
            else:
                tol = BF16_ULP * max(p.float().abs().max().item() for p in want)
                worst_bf16[name] = max(worst_bf16[name], err)
            check(err <= tol, f"{name}{tag} {label}: max |kernel - plain| "
                              f"{err:.3e} <= {tol:.3e}")

    # the denoise kernel at other filters and depths, in both dtypes:
    # (wavelet, levels, batch, n, periodic); haar at J = 1 and at its
    # deepest (10, also shorter than the span), sym8 J=4, db20 at its deepest
    # (J=7), db4 at J = 1 and at its deepest (9); zero and periodic edges
    denoise_cases = [
        ("haar", 1, 3, 5001, True), ("haar", 10, 2, 3001, False), ("haar", 10, 2, 700, True),
        ("sym8", 4, 3, 5000, False), ("db20", 7, 2, 9000, True), (WAVELET, 1, 2, 1000, False),
        (WAVELET, 9, 2, 9003, True),
    ]
    for name, levels, b, n, periodic in denoise_cases:
        wd = vt.wavelet(name)
        dd, dr = _kernel_filters(wd, synthesis=False), _kernel_filters(wd, synthesis=True)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
            th = gap_thresholds(mc._analysis_cascade(x, levels, dd, periodic), levels)
            label = (f"{name} J={levels} {b}x{n} {'periodic' if periodic else 'zero'} "
                     f"{str(dtype)[6:]}")
            for mode in ("none", "soft", "hard"):
                got = mc.denoise(x, th, levels, dd, dr, periodic, mode)
                want = mc.denoise_plain(x, th, levels, dd, dr, periodic, mode)
                torch.cuda.synchronize()
                err = max_err(got, want)
                if dtype == torch.float32:
                    tol = TOL_F32
                    worst["modwt_denoise"] = max(worst["modwt_denoise"], err)
                else:
                    tol = BF16_ULP * want.float().abs().max().item()
                    worst_bf16["modwt_denoise"] = max(worst_bf16["modwt_denoise"], err)
                check(err <= tol, f"modwt_denoise {mode} {label}: max |kernel - plain| "
                                  f"{err:.3e} <= {tol:.3e}")

    # exact fp64 kernels: (wavelet, batch, n, periodic, first level, levels, lo word)
    exact_cases = [
        (WAVELET, BATCH, N, True, 1, LEVELS, False),
        (WAVELET, 3, 5000, False, 1, LEVELS, False),
        (WAVELET, 2, 300, True, 1, LEVELS, False),
        (WAVELET, 8, 65536, True, 1, LEVELS, True),
        (WAVELET, 4, 8192, False, 3, 2, True),
        ("sym8", 2, 16384, True, 1, 10, False),  # two launches each
        ("db38", 2, 32768, False, 1, 9, False),  # levels 8-9 run direct
        # odd rows (each after the first off 16 bytes), rows not a multiple
        # of the tile, and strides of 256 and 512 (above the block's threads)
        (WAVELET, 3, 5001, True, 1, LEVELS, True),
        (WAVELET, 3, 9001, False, 1, LEVELS, False),
        (WAVELET, 2, 5001, True, 9, 2, True),
        (WAVELET, 2, 4099, False, 10, 1, False),
    ]
    for name, b, n, periodic, first, levels, with_lo in exact_cases:
        wx = vt.wavelet(name)
        ed, er = _kernel_filters(wx, synthesis=False), _kernel_filters(wx, synthesis=True)
        x = torch.randn(b, n, device=dev, generator=gen)
        x_lo = (x * 2.0**-26 * torch.randn(b, n, device=dev, generator=gen)
                if with_lo else None)
        label = (f"{name} {b}x{n} {'periodic' if periodic else 'zero'} levels "
                 f"{first}..{first + levels - 1}{' with lo' if with_lo else ''}")
        before = dict(mc.LAUNCHES)
        want = mc.exact_analysis_plain(x, x_lo, levels, ed, periodic, first)
        got = mc.exact_analysis(x, x_lo, levels, ed, periodic, first)
        y_want = mc.exact_synthesis_plain(want, levels, er, periodic, first)
        y_got = mc.exact_synthesis(want, levels, er, periodic, first)
        torch.cuda.synchronize()
        launched = {k: mc.LAUNCHES[k] - before[k] for k in EXACT_PATH}
        for kname, err in (("modwt_exact_analysis", pair_err(got, want)),
                           ("modwt_exact_synthesis", pair_err((y_got,), (y_want,)))):
            worst[kname] = max(worst[kname], err)
            check(err <= TOL_EXACT and launched[kname] >= 1,
                  f"{kname} {label}: max |kernel - plain| {err:.3e} <= {TOL_EXACT:.0e} "
                  f"({launched[kname]} launches)")

    # the symmetric kernel pair and the analysis head splice:
    # (wavelet, levels, batch, n, dtype); planes from an analysis of x, so the
    # outputs are of the order of x
    sym_cases = [
        (WAVELET, LEVELS, BATCH, N, torch.float32),
        ("sym8", 4, BATCH, N, torch.float32),
        (WAVELET, LEVELS, 3, 5000, torch.float32),
        ("haar", 4, 2, 4096, torch.float32),
        ("db36", 8, 2, N, torch.float32),  # windows too wide for a 2048 tile
        (WAVELET, LEVELS, BATCH, N, torch.bfloat16),
        # odd rows (each after the first off 16 bytes; a ragged last tile),
        # rows one sample longer than the two splices (441 and 225), and
        # bfloat16 on unaligned rows
        (WAVELET, LEVELS, 3, 5001, torch.float32),
        (WAVELET, LEVELS, 2, 442, torch.float32),
        ("sym8", 4, 2, 226, torch.float32),
        (WAVELET, LEVELS, 3, 5001, torch.bfloat16),
    ]
    for name, levels, b, n, dtype in sym_cases:
        ws = vt.wavelet(name)
        sd, sr = _kernel_filters(ws, synthesis=False), _kernel_filters(ws, synthesis=True)
        ops = ms.symmetric_level_ops(ws, levels)
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        cut = min(mc.composite_halo_samples(ws.filter_length, levels), n)
        head = torch.stack(ms._symmetric_cascade(x[:, :cut].float(), sd, levels)).contiguous()
        planes = mc.analysis_plain(x, levels, sd, False, head)
        span_l, span_r, _, _ = ms.synthesis_windows(ws.filter_length, ops)
        hd = torch.randn(b, span_l, device=dev, generator=gen)
        tl = torch.randn(b, span_r, device=dev, generator=gen)
        c = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        forward = lib.vw_modwt_symmetric_synthesis_tile(ws.filter_length, levels, n,
                                                        mc.SYMMETRIC_LAUNCH_TILE)
        adjoint = lib.vw_modwt_symmetric_adjoint_tile(ws.filter_length, levels, n,
                                                      mc.SYMMETRIC_ADJOINT_LAUNCH_TILE)
        label = (f"{name} J={levels} {b}x{n} {str(dtype)[6:]} (tiles: forward {forward}, "
                 f"adjoint {adjoint})")
        results = [
            ("modwt_analysis", " with head splice",
             mc.analysis(x, levels, sd, False, head), planes),
            ("modwt_symmetric_synthesis", "",
             mc.symmetric_synthesis(planes, hd, tl, levels, sr, ops),
             mc.symmetric_synthesis_plain(planes, hd, tl, levels, sr, ops)),
            ("modwt_symmetric_adjoint", "",
             mc.symmetric_adjoint(c, levels, sr, ops),
             mc.symmetric_adjoint_plain(c, levels, sr, ops)),
            ("modwt_symmetric_adjoint", " on the interior",
             mc.symmetric_adjoint(c, levels, sr, ops, span_l, span_r),
             mc.symmetric_adjoint_plain(c, levels, sr, ops, span_l, span_r)),
        ]
        torch.cuda.synchronize()
        for kname, tag, got, want in results:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_err(g, p) for g, p in zip(got, want))
            if dtype == torch.float32:
                tol = TOL_F32
                worst[kname] = max(worst[kname], err)
            else:
                tol = BF16_ULP * max(p.float().abs().max().item() for p in want)
                worst_bf16[kname] = max(worst_bf16[kname], err)
            check(err <= tol, f"{kname}{tag} {label}: max |kernel - plain| "
                              f"{err:.3e} <= {tol:.3e}")

    # the adjoint alone at strides 256 and 512 (passes), on the interior
    for name, levels, b, n, dtype in (("haar", 10, 2, 20001, torch.float32),
                                      ("sym8", 9, 2, 16001, torch.float32),
                                      ("sym8", 9, 2, 16001, torch.bfloat16)):
        ws = vt.wavelet(name)
        sr = _kernel_filters(ws, synthesis=True)
        ops = ms.symmetric_level_ops(ws, levels)
        spans = mc.symmetric_spans(ws.filter_length, ops)
        c = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        got = mc.symmetric_adjoint(c, levels, sr, ops, *spans)
        want = mc.symmetric_adjoint_plain(c, levels, sr, ops, *spans)
        torch.cuda.synchronize()
        err = max(max_err(g, p) for g, p in zip(got, want))
        if dtype == torch.float32:
            tol = TOL_F32
            worst["modwt_symmetric_adjoint"] = max(worst["modwt_symmetric_adjoint"], err)
        else:
            tol = BF16_ULP * max(p.float().abs().max().item() for p in want)
            worst_bf16["modwt_symmetric_adjoint"] = max(
                worst_bf16["modwt_symmetric_adjoint"], err)
        check(err <= tol, f"modwt_symmetric_adjoint {name} J={levels} {b}x{n} "
                          f"{str(dtype)[6:]} on the interior: max |kernel - plain| "
                          f"{err:.3e} <= {tol:.3e}")

    # the cascade pair's launch tile, the library's: every shape the routers'
    # gates send (their rule, taps + 2 or 3 rows of tile + span) it launches,
    # for every filter length and depth, and a short row's tile is the row
    lib = _build.library()
    refused = []
    for taps in range(1, 129):  # kMaxTaps
        for levels in range(1, 11):
            reach = mc.mirror_reach(taps, levels)
            if (mc.analysis_tile(taps, levels) is not None
                    and not lib.vw_modwt_analysis_tile(taps, levels, 1 << 20, mc.ANALYSIS_TILE,
                                                       mc.EDGES["periodic"])):
                refused.append(("analysis", taps, levels))
            if mc.analysis_tile(taps, levels, mirror=True) is not None and not all(
                    lib.vw_modwt_analysis_tile(taps, levels, n, mc.ANALYSIS_TILE,
                                               mc.EDGES["mirror"])
                    for n in (max(reach, 1), 1 << 20)):
                refused.append(("mirror analysis", taps, levels))
            if (mc._fitting_tile(lambda t: mc.synthesis_shared_bytes(taps, levels, t),
                                 mc.SYNTHESIS_TILE) is not None
                    and not lib.vw_modwt_synthesis_tile(taps, levels, 1 << 20,
                                                        mc.SYNTHESIS_TILE)):
                refused.append(("synthesis", taps, levels))
    check(not refused, f"the cascade pair launches every shape the gates send, filter "
                       f"lengths 1-128, J 1-10 (refused: {refused[:5]})")
    # the denoise kernel's and the exact synthesis's launch tiles, the
    # library's: every depth denoise_tile admits, and every window launch
    # of the exact plans from every first level
    refused = []
    for taps in range(1, 129):
        for levels in range(1, 11):
            if (mc.denoise_tile(taps, levels) is not None
                    and not lib.vw_modwt_denoise_tile(taps, levels, 1 << 20,
                                                       mc.DENOISE_LAUNCH_TILE)):
                refused.append(("denoise", taps, levels))
            for first_level in range(1, 12 - levels):
                for first, count, _, direct in mc.exact_launches(
                        mc.exact_synthesis_shared_bytes, taps, levels, first_level):
                    if not direct and not lib.vw_modwt_exact_synthesis_tile(
                            taps, first, count, 1 << 20, mc.EXACT_SYNTHESIS_LAUNCH_TILE):
                        refused.append(("exact synthesis", taps, first, count))
    check(not refused, f"the denoise and exact synthesis kernels launch every shape the "
                       f"gates send, filter lengths 1-128, J 1-10 (refused: {refused[:5]})")
    # the symmetric synthesis's and the exact analysis's launch tiles, the
    # library's: every registered wavelet and depth symmetric_tile admits,
    # and every window launch of the exact plans from every first level (a
    # tile of 128 or more where a block of 128 fits, else 64: the exact
    # analysis's padded taps and rows take up to 208 bytes more than the
    # gates' rule)
    refused, served = [], 0
    for name in vt.available_wavelets():
        ws = vt.wavelet(name)
        if not isinstance(ws, vt.DiscreteWavelet) or ws.filter_length > 128:
            continue
        for levels in range(1, 11):
            ops = ms.symmetric_level_ops(ws, levels)
            if mc.symmetric_tile(ws.filter_length, ops, True) is not None and (
                    lib.vw_modwt_symmetric_adjoint_tile(
                        ws.filter_length, levels, 1 << 20,
                        mc.SYMMETRIC_ADJOINT_LAUNCH_TILE) < 128):
                refused.append(("symmetric adjoint", name, levels))
            if mc.symmetric_tile(ws.filter_length, ops, False) is None:
                continue
            served += 1
            if lib.vw_modwt_symmetric_synthesis_tile(ws.filter_length, levels, 1 << 20,
                                                     mc.SYMMETRIC_LAUNCH_TILE) < 128:
                refused.append(("symmetric synthesis", name, levels))
    for taps in range(1, 129):
        for levels in range(1, 11):
            for first_level in range(1, 12 - levels):
                for first, count, _, direct in mc.exact_launches(
                        mc.exact_analysis_shared_bytes, taps, levels, first_level):
                    fits = lib.vw_modwt_exact_analysis_shared_bytes(taps, first, count, 128)
                    least = 128 if fits <= mc.SHARED_LIMIT else 64
                    if not direct and lib.vw_modwt_exact_analysis_tile(
                            taps, first, count, 1 << 20, mc.EXACT_ANALYSIS_LAUNCH_TILE) < least:
                        refused.append(("exact analysis", taps, first, count))
    check(not refused and served > 100,
          f"the symmetric synthesis ({served} wavelets and depths), its adjoint and the "
          f"exact analysis "
          f"launch every shape the gates send (refused: {refused[:5]})")
    short = (lib.vw_modwt_analysis_tile(8, LEVELS, 1000, mc.ANALYSIS_TILE, 1),
             lib.vw_modwt_synthesis_tile(8, LEVELS, 1000, mc.SYNTHESIS_TILE),
             lib.vw_modwt_symmetric_synthesis_tile(8, LEVELS, 1000, mc.SYMMETRIC_LAUNCH_TILE),
             lib.vw_modwt_symmetric_adjoint_tile(8, LEVELS, 1000,
                                                 mc.SYMMETRIC_ADJOINT_LAUNCH_TILE),
             lib.vw_modwt_exact_analysis_tile(8, 1, LEVELS, 1000,
                                              mc.EXACT_ANALYSIS_LAUNCH_TILE),
             lib.vw_modwt_analysis_tile(8, LEVELS, N, mc.ANALYSIS_TILE, 1),
             lib.vw_modwt_synthesis_tile(8, LEVELS, N, mc.SYNTHESIS_TILE),
             lib.vw_modwt_symmetric_synthesis_tile(8, LEVELS, N, mc.SYMMETRIC_LAUNCH_TILE),
             lib.vw_modwt_symmetric_adjoint_tile(8, LEVELS, N,
                                                 mc.SYMMETRIC_ADJOINT_LAUNCH_TILE),
             lib.vw_modwt_exact_analysis_tile(8, 1, LEVELS, N, mc.EXACT_ANALYSIS_LAUNCH_TILE))
    check(short == (1000,) * 5 + (mc.ANALYSIS_TILE, mc.SYNTHESIS_TILE,
                                  mc.SYMMETRIC_LAUNCH_TILE, mc.SYMMETRIC_ADJOINT_LAUNCH_TILE,
                                  mc.EXACT_ANALYSIS_LAUNCH_TILE),
          f"db4 J={LEVELS} launch tiles, rows of 1000 / {N}: {short}")

    # the cascade pair in each edge mode: (wavelet, levels, batch, n, dtype);
    # the synthesis runs on the plain analysis planes of the same edge (zero
    # for the mirror's)
    cascade_cases = [
        (WAVELET, LEVELS, BATCH, N, torch.float32),
        ("sym8", 4, BATCH, N, torch.float32),
        (WAVELET, LEVELS, 3, 5000, torch.float32),
        (WAVELET, LEVELS, 2, 300, torch.float32),  # reach 224 <= N < span 441
        ("sym8", 4, 2, 150, torch.float32),  # reach 120 <= N < span 225
        ("haar", 5, 2, 4096, torch.float32),
        ("db36", 8, 2, N, torch.float32),  # the mirror's tile 71 * 128 < span
        (WAVELET, LEVELS, BATCH, N, torch.bfloat16),
        # rows not a multiple of 4 long (each row after the first starts
        # off 16 bytes), J=9 (stride 256 = the block's threads) and J=10
        # (stride 512: two passes a chunk), haar at J=10, a long filter at a
        # shallow depth, and bfloat16 on an unaligned row
        (WAVELET, LEVELS, 3, 5001, torch.float32),
        (WAVELET, 9, 2, 8195, torch.float32),
        (WAVELET, 10, 2, 20003, torch.float32),
        ("haar", 10, 3, 3001, torch.float32),
        ("db36", 3, 2, 4099, torch.float32),
        (WAVELET, LEVELS, 3, 5001, torch.bfloat16),
    ]
    for name, levels, b, n, dtype in cascade_cases:
        wc = vt.wavelet(name)
        cd, cr = _kernel_filters(wc, synthesis=False), _kernel_filters(wc, synthesis=True)
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        for edge in ("periodic", "zero", "mirror"):
            periodic, mirror = edge == "periodic", edge == "mirror"
            used = lib.vw_modwt_analysis_tile(wc.filter_length, levels, n,
                                              mc.ANALYSIS_TILE, mc.EDGES[edge])
            label = f"{name} J={levels} {b}x{n} {edge} {str(dtype)[6:]} (tile {used})"
            want = mx.analysis_plain(x, levels, cd, edge)
            results = [
                ("modwt_mxu_analysis", mx.run_analysis_mxu(
                    x, levels, cd, periodic, PROBE_TILE, "float32", False,
                    symmetric=mirror),
                 want),
                ("modwt_mxu_synthesis",
                 mx.run_synthesis_mxu(want, levels, cr, periodic, PROBE_TILE, "float32",
                                      False),
                 mc.synthesis_plain(want, levels, cr, periodic)),
            ]
            torch.cuda.synchronize()
            for kname, got, ref in results:
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = max(max_err(g, p) for g, p in zip(got, ref))
                if dtype == torch.float32:
                    tol = TOL_F32
                    worst[kname] = max(worst[kname], err)
                else:
                    tol = BF16_ULP * max(p.float().abs().max().item() for p in ref)
                    worst_bf16[kname] = max(worst_bf16[kname], err)
                check(err <= tol, f"{kname} {label}: max |kernel - plain| "
                                  f"{err:.3e} <= {tol:.3e}")
            del want, results

    # the 2-D level kernels: (wavelet, level, shape), each in the three edge
    # modes; the synthesis planes are independent unit-variance images
    img_cases = [
        (WAVELET, 1, IMG), (WAVELET, 4, IMG), ("sym8", 1, IMG), ("sym8", 6, IMG),
        (WAVELET, 3, (3, 200, 328)), ("haar", 5, (1, 24, 40)), ("db20", 4, (2, 1024, 1024)),
        # every db4 level 1-6 on ragged widths (the planners' tiles change
        # with the level), haar level 10, db20 at its deepest served level
        *((WAVELET, j, (2, 1000, 1030)) for j in range(1, LEVELS + 1)),
        ("haar", 10, (1, 1100, 1030)), ("db20", 6, (1, 600, 700)),
    ]
    for name, level, shape in img_cases:
        wi = vt.wavelet(name)
        s = 1 << (level - 1)
        fa, fs = _kernel_filters(wi, synthesis=False), _kernel_filters(wi, synthesis=True)
        xi = torch.randn(*shape, device=dev, generator=gen)
        planes = [torch.randn(*shape, device=dev, generator=gen) for _ in range(4)]
        for edge in ("periodic", "zero", "symmetric"):
            ops = k2.synthesis_ops(wi, level, edge)[level - 1]
            label = f"{name} level {level} {'x'.join(map(str, shape))} {edge}"
            got = k2.analysis2_level(xi, fa, s, edge)
            want = k2.analysis2_level_plain(xi, fa, s, edge)
            torch.cuda.synchronize()
            err = max(max_err(g, p) for g, p in zip(got, want))
            worst["modwt2_analysis"] = max(worst["modwt2_analysis"], err)
            check(err <= TOL_F32, f"modwt2_analysis {label}, every band: max |kernel - "
                                  f"plain| {err:.3e} <= {TOL_F32:.0e}")
            del got, want
            got = k2.synthesis2_level(*planes, fs, s, ops, edge)
            want = k2.synthesis2_level_plain(*planes, fs, s, ops, edge)
            torch.cuda.synchronize()
            err = max_err(got, want)
            worst["modwt2_synthesis"] = max(worst["modwt2_synthesis"], err)
            check(err <= TOL_F32, f"modwt2_synthesis {label}, ops {ops}: max |kernel - "
                                  f"plain| {err:.3e} <= {TOL_F32:.0e}")
            del got, want
        del xi, planes

    bank_kernels_against_plain(dev, gen, worst, worst_bf16)
    cwt_kernels_against_plain(dev, gen, worst)
    stream_kernels_against_plain(dev, gen, worst, worst_bf16)
    halo_kernels_against_plain(dev, gen, worst, worst_bf16)
    mirror_launches = {
        phase: mirror_cases_path(dev, phase, family, cases)
        for phase, family, cases in (
            ("2b", "the MODWT core's", mirror_cases.cases()),
            ("2c", "the other kernel families'", mirror_cases.family_cases()),
            ("2d", "the streaming and parallel tiers'", mirror_cases.tier_cases()),
            ("2e", "the CWT family's", mirror_cases.analysis_cases()),
            ("2f", "the 1-D analysis modules'", mirror_cases.decimated_cases()),
            ("2g", "the 2-D trees', the solvers' and the infrastructure's",
             mirror_cases.solver_cases()))}
    facade_on_the_card(dev, gen)

    print(f"phase 3: main path through the public entry points, "
          f"{BATCH}x{N} float32", flush=True)
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    t = torch.arange(N, device=dev, dtype=torch.float32)
    clean = (torch.sin(2 * math.pi * t / 32.0) + 0.5 * torch.sin(2 * math.pi * t / 8.0)
             + 0.25 * torch.sin(2 * math.pi * t / 128.0 + 0.6)).expand(BATCH, N)
    noisy = (clean + 0.5 * torch.randn(BATCH, N, device=dev, generator=gen)).contiguous()
    mc.reset_launches()
    for tier in ("float32", "bf16_3x", "bf16"):
        res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, precision=tier)
        y = vt.imodwt_multilevel(res, WAVELET, precision=tier)
        rmse = (y - x).pow(2).mean().sqrt().item()
        check(rmse <= RT_RMSE and max_err(y, x) <= RT_MAX,
              f"round trip {tier}: rmse {rmse:.3e} <= {RT_RMSE:.0e}, "
              f"max {max_err(y, x):.3e} <= {RT_MAX:.0e}")
    y = vt.modwt_roundtrip_fused(x, WAVELET, levels=LEVELS)
    rmse = (y - x).pow(2).mean().sqrt().item()
    check(rmse <= RT_RMSE and max_err(y, x) <= RT_MAX,
          f"modwt_roundtrip_fused: rmse {rmse:.3e}, max {max_err(y, x):.3e}")
    den = vt.denoise_multilevel(noisy, WAVELET, levels=LEVELS, method="universal",
                                mode="soft")
    torch.cuda.synchronize()
    launches = dict(mc.LAUNCHES)
    print(f"  launches during the main path: {launches}", flush=True)
    for name in MAIN_PATH:
        check(launches[name] > 0, f"{name} launched {launches[name]} times")

    sigma = _fused_sigma(noisy, w, "periodic")
    ths = torch.cat([universal_threshold(N, sigma / math.sqrt(2.0**j)).float()
                     for j in range(1, LEVELS + 1)], dim=-1).contiguous()
    den_plain = mc.denoise_plain(noisy, ths, LEVELS, fd, fr, True, "soft")
    check(den.shape == noisy.shape and bool(torch.isfinite(den).all()),
          f"denoise_multilevel output finite, shape {tuple(den.shape)}")
    check(max_err(den, den_plain) <= TOL_F32,
          f"denoise_multilevel vs plain path: {max_err(den, den_plain):.3e}")

    weights = [torch.randn(BATCH, N, device=dev, generator=gen) for _ in range(LEVELS + 1)]
    xg = x.clone().requires_grad_(True)
    grads = []
    for backend in ("kernel", "torch"):
        res = vt.modwt_multilevel(xg, WAVELET, levels=LEVELS, backend=backend)
        loss = sum((p * wt).sum() for p, wt in zip((*res.details, res.approx), weights))
        grads.append(torch.autograd.grad(loss, xg)[0])
    check(max_err(*grads) <= TOL_F32,
          f"analysis gradient, kernel vs plain autograd: {max_err(*grads):.3e}")
    planes = [p.detach().clone().requires_grad_(True) for p in mc.analysis(x, LEVELS, fd, True)]
    grads = []
    for backend in ("kernel", "torch"):
        y = vt.imodwt_multilevel(
            vt.MultiLevelMODWTResult(tuple(planes[:LEVELS]), planes[LEVELS]),
            WAVELET, backend=backend)
        grads.append(torch.autograd.grad((y * weights[0]).sum(), planes))
    err = max(max_err(a, b) for a, b in zip(*grads))
    check(err <= TOL_F32, f"synthesis gradient, kernel vs plain autograd: {err:.3e}")

    small = torch.randn(4, 8192, device=dev, generator=gen)
    got = vt.modwt_multilevel(small, WAVELET, levels=LEVELS, backend="kernel")
    ref = vt.modwt_multilevel(small.cpu().double(), WAVELET, levels=LEVELS, backend="torch")
    err = max(max_err(g.cpu().double(), r) for g, r in
              zip((*got.details, got.approx), (*ref.details, ref.approx)))
    check(err <= TOL_F32, f"4x8192 kernel analysis vs float64 CPU cascade: {err:.3e}")

    print(f"  the exact path, {BATCH}x{N} float32", flush=True)
    mc.reset_launches()
    for how in ({"precision": "exact"}, {"tolerance": 1e-10}):
        res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, **how)
        y = vt.imodwt_multilevel(res, WAVELET, **how)
        hi, lo = vt.imodwt_multilevel_exact(
            tuple(zip(res.details, res.details_lo)), (res.approx, res.approx_lo), WAVELET)
        torch.cuda.synchronize()
        check(isinstance(res, vt.ExactMODWTResult) and res.approx.device == dev,
              f"{how}: an ExactMODWTResult on {res.approx.device}")
        rmse = (hi.double() + lo.double() - x.double()).pow(2).mean().sqrt().item()
        same = (y == x).double().mean().item()
        check(rmse <= EXACT_RMSE and bool(torch.equal(hi, y)),
              f"exact round trip {how}: rmse of hi + lo {rmse:.3e} <= {EXACT_RMSE:.0e}, "
              f"share of hi words equal to x {same:.6f}")
    exact_launches = dict(mc.LAUNCHES)
    print(f"  launches during the exact path: {exact_launches}", flush=True)
    for name in EXACT_PATH:
        check(exact_launches[name] > 0, f"{name} launched {exact_launches[name]} times")
    launches.update({name: exact_launches[name] for name in EXACT_PATH})

    sym = vt.modwt_multilevel_exact(small, "sym8", levels=4, boundary="symmetric")
    ref = vt.modwt_multilevel(small.cpu().double(), "sym8", levels=4,
                              boundary="symmetric", backend="torch")
    err = max((h.cpu().double() + l.cpu().double() - r).abs().max().item()
              for (h, l), r in zip((*sym[0], sym[1]), (*ref.details, ref.approx)))
    check(err <= EXACT_SYM, f"4x8192 sym8 exact symmetric analysis vs float64 CPU "
                            f"cascade: {err:.3e} <= {EXACT_SYM:.0e}")
    try:
        vt.modwt_multilevel(x.clone().requires_grad_(True), WAVELET, levels=LEVELS,
                            precision="exact")
        refused = False
    except vt.InvalidArgumentError:
        refused = True
    check(refused, "an exact request on an input that requires grad raises")

    print(f"  the probe's path (run_analysis_mxu -> run_synthesis_mxu), {BATCH}x{N} "
          "float32", flush=True)
    for tier in mx.PRECISIONS:
        mc.reset_launches()
        planes = mx.run_analysis_mxu(x, LEVELS, fd, True, PROBE_TILE, tier, False)
        y = mx.run_synthesis_mxu(planes, LEVELS, fr, True, PROBE_TILE, tier, False)
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == dict.fromkeys(MXU_PATH, 1), f"probe round trip {tier}: launches {got}")
        for name in MXU_PATH:
            launches[name] += got[name]
        rmse = (y - x).pow(2).mean().sqrt().item()
        check(rmse <= RT_RMSE and max_err(y, x) <= RT_MAX,
              f"probe round trip {tier}: rmse {rmse:.3e} <= {RT_RMSE:.0e}, "
              f"max {max_err(y, x):.3e} <= {RT_MAX:.0e}")
    del planes

    print(f"  the symmetric path, {BATCH}x{N} float32", flush=True)
    mc.reset_launches()
    res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary="symmetric")
    y = vt.imodwt_multilevel(res, WAVELET, boundary="symmetric")
    torch.cuda.synchronize()
    rt_launches = {k: v for k, v in mc.LAUNCHES.items() if v}
    check(rt_launches == {"modwt_mxu_analysis": 1, "modwt_symmetric_synthesis": 1},
          f"symmetric round trip launches {rt_launches}")
    ref = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary="symmetric",
                              backend="torch")
    y_ref = vt.imodwt_multilevel(ref, WAVELET, boundary="symmetric", backend="torch")
    err = max(max_err(a, b) for a, b in zip((*res.details, res.approx),
                                            (*ref.details, ref.approx)))
    check(err <= TOL_F32, f"symmetric analysis vs plain cascade: {err:.3e}")
    check(max_err(y, y_ref) <= TOL_F32,
          f"symmetric synthesis vs plain cascade: {max_err(y, y_ref):.3e}")
    # 128x65536 is 2^23 samples: both kernels; a row of 16384 takes the
    # mirror analysis and the plain synthesis (SYMMETRIC_SYNTHESIS_MIN_SAMPLES)
    for b, n, expect in ((BATCH, N, rt_launches), (1, 16384, {"modwt_mxu_analysis": 1})):
        xs = noisy[:b, :n].contiguous()
        before = dict(mc.LAUNCHES)
        got = vt.swt_denoise(xs, "sym8", levels=4, boundary="symmetric")
        torch.cuda.synchronize()
        seen = {k: v - before[k] for k, v in mc.LAUNCHES.items() if v - before[k]}
        check(seen == expect, f"swt_denoise sym8 J=4 symmetric {b}x{n} launches {seen}")
        vt.set_backend("torch")
        try:
            want = vt.swt_denoise(xs, "sym8", levels=4, boundary="symmetric")
        finally:
            vt.set_backend("auto")
        check(got.shape == xs.shape and bool(torch.isfinite(got).all())
              and max_err(got, want) <= TOL_SWT,
              f"swt_denoise sym8 J=4 symmetric {b}x{n} vs plain path: "
              f"{max_err(got, want):.3e} <= {TOL_SWT:.0e}")
    xg = x.clone().requires_grad_(True)
    grads = []
    for backend in ("kernel", "torch"):
        r = vt.modwt_multilevel(xg, WAVELET, levels=LEVELS, boundary="symmetric",
                                backend=backend)
        loss = sum((p * wt).sum() for p, wt in zip((*r.details, r.approx), weights))
        grads.append(torch.autograd.grad(loss, xg)[0])
    check(max_err(*grads) <= TOL_F32,
          f"symmetric analysis gradient, kernel vs plain autograd: {max_err(*grads):.3e}")
    planes = [p.detach().clone().requires_grad_(True) for p in (*ref.details, ref.approx)]
    grads = []
    for backend in ("kernel", "torch"):
        yy = vt.imodwt_multilevel(
            vt.MultiLevelMODWTResult(tuple(planes[:LEVELS]), planes[LEVELS]),
            WAVELET, boundary="symmetric", backend=backend)
        grads.append(torch.autograd.grad((yy * weights[0]).sum(), planes))
    err = max(max_err(a, b) for a, b in zip(*grads))
    check(err <= TOL_F32, f"symmetric synthesis gradient, kernel vs plain autograd: "
                          f"{err:.3e}")
    got = vt.modwt_multilevel(small, WAVELET, levels=LEVELS, boundary="symmetric",
                              backend="kernel")
    ref = vt.modwt_multilevel(small.cpu().double(), WAVELET, levels=LEVELS,
                              boundary="symmetric", backend="torch")
    err = max(max_err(g.cpu().double(), r) for g, r in
              zip((*got.details, got.approx), (*ref.details, ref.approx)))
    y_got = vt.imodwt_multilevel(got, WAVELET, boundary="symmetric", backend="kernel")
    y_ref = vt.imodwt_multilevel(
        vt.MultiLevelMODWTResult(tuple(g.cpu().double() for g in got.details),
                                 got.approx.cpu().double()),
        WAVELET, boundary="symmetric", backend="torch")
    err_y = max_err(y_got.cpu().double(), y_ref)
    check(err <= TOL_F32 and err_y <= TOL_F32,
          f"4x8192 symmetric kernels vs float64 CPU cascade: analysis {err:.3e}, "
          f"synthesis {err_y:.3e}")
    torch.cuda.synchronize()
    sym_launches = dict(mc.LAUNCHES)
    print(f"  launches during the symmetric path: {sym_launches}", flush=True)
    for name in SYMMETRIC_PATH + ("modwt_synthesis",):
        check(sym_launches[name] > 0, f"{name} launched {sym_launches[name]} times "
                                      "in the symmetric path")
    check(sym_launches["modwt_analysis"] == 0,
          f"modwt_analysis launched {sym_launches['modwt_analysis']} times in the "
          "symmetric path (its analysis is the mirror mode)")
    for name in SYMMETRIC_PATH:
        launches[name] += sym_launches[name]
    # the synthesis kernel at the 1x16384 shape that auto gives the plain
    # route, forced, against the plain synthesis (not counted above)
    xs = noisy[:1, :16384].contiguous()
    planes16 = vt.modwt_multilevel(xs, "sym8", levels=4, boundary="symmetric",
                                   backend="torch")
    mc.reset_launches()
    y_got = vt.imodwt_multilevel(planes16, "sym8", boundary="symmetric", backend="kernel")
    torch.cuda.synchronize()
    forced = mc.LAUNCHES["modwt_symmetric_synthesis"]
    y_ref = vt.imodwt_multilevel(planes16, "sym8", boundary="symmetric", backend="torch")
    check(forced == 1 and max_err(y_got, y_ref) <= TOL_F32,
          f"symmetric synthesis kernel sym8 J=4 1x16384 (forced, {forced} launch) vs plain "
          f"synthesis: {max_err(y_got, y_ref):.3e} <= {TOL_F32:.0e}")

    print(f"  the fused denoise's gradient, {BATCH}x{N} float32", flush=True)
    th = gap_thresholds(mc._analysis_cascade(noisy, LEVELS, fd, True), LEVELS)
    grads = []
    for fused in (True, False):
        xg, tg = noisy.clone().requires_grad_(True), th.clone().requires_grad_(True)
        if fused:
            y = vt.fused_denoise_multilevel(xg, WAVELET, levels=LEVELS, thresholds=tg,
                                            mode="soft")
            mc.reset_launches()
        else:
            y = mc.denoise_plain(xg, tg, LEVELS, fd, fr, True, "soft")
        grads.append(torch.autograd.grad((y * weights[0]).sum(), (xg, tg)))
        if fused:
            torch.cuda.synchronize()
            grad_launches = {k: v for k, v in mc.LAUNCHES.items() if v}
    check(grad_launches == {"modwt_analysis": 2, "modwt_synthesis": 1},
          f"fused denoise backward launches {grad_launches}")
    for name, count in grad_launches.items():
        launches[name] += count
    (gx, gt), (px, pt) = grads
    err_t = max_err(gt, pt) / pt.abs().max().item()
    check(max_err(gx, px) <= TOL_F32 and err_t <= TOL_DTH,
          f"fused denoise gradient vs plain autograd: d/dx {max_err(gx, px):.3e} <= "
          f"{TOL_F32:.0e}, d/dthreshold {err_t:.3e} <= {TOL_DTH:.0e} of its largest")
    xg = noisy.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(vt.denoise_multilevel(xg, WAVELET, levels=LEVELS).pow(2).sum(),
                               xg)
    check(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0,
          "denoise_multilevel differentiates on the card")

    print(f"  the 2-D path, {'x'.join(map(str, IMG))} float32", flush=True)
    twod_launches = dict.fromkeys(TWOD_PATH, 0)

    def counted(label, expect, fn):
        """Run fn with the counters set to 0 just before and read just after."""
        mc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == expect, f"{label}: launches {got}")
        for k in TWOD_PATH:
            twod_launches[k] += got.get(k, 0)
        return out

    img = torch.randn(*IMG, device=dev, generator=gen)

    def bands(res):
        return [p for trip in res.details for p in trip] + [res.approx]

    for name, levels, boundary in ((WAVELET, 4, "periodic"), (WAVELET, 6, "periodic"),
                                   (WAVELET, 4, "zero"), ("sym8", 4, "symmetric")):
        label = f"{name} J={levels} {boundary}"
        each = {"modwt2_analysis": levels}
        res = counted(f"modwt2_multilevel {label}", each, lambda: vt.modwt2_multilevel(
            img, name, levels=levels, boundary=boundary))
        y = counted(f"imodwt2_multilevel {label}", {"modwt2_synthesis": levels},
                    lambda: vt.imodwt2_multilevel(res, name, boundary=boundary))
        ref = vt.modwt2_multilevel(img, name, levels=levels, boundary=boundary,
                                   backend="torch")
        err = max(max_err(g, r) for g, r in zip(bands(res), bands(ref)))
        y_ref = vt.imodwt2_multilevel(ref, name, boundary=boundary, backend="torch")
        check(err <= TOL_F32 and max_err(y, y_ref) <= TOL_F32,
              f"2-D {label} vs plain path: every band {err:.3e}, inverse "
              f"{max_err(y, y_ref):.3e} <= {TOL_F32:.0e}")
        if boundary == "periodic":
            rmse = (y - img).pow(2).mean().sqrt().item()
            check(max_err(y, img) <= RT2_MAX,
                  f"2-D round trip {label}: rmse {rmse:.3e}, max {max_err(y, img):.3e} "
                  f"<= {RT2_MAX:.0e}")
        del res, y, ref, y_ref
    rows = torch.arange(IMG[1], device=dev, dtype=torch.float32)[:, None]
    cols = torch.arange(IMG[2], device=dev, dtype=torch.float32)[None, :]
    noisy_img = (torch.sin(2 * math.pi * rows / 64.0) * torch.cos(2 * math.pi * cols / 48.0)
                 + 0.5 * torch.randn(*IMG, device=dev, generator=gen)).contiguous()
    den2 = counted("denoise2 db4 J=4 universal soft",
                   {"modwt2_analysis": 4, "modwt2_synthesis": 4},
                   lambda: vt.denoise2(noisy_img, WAVELET, levels=4))
    vt.set_backend("torch")
    try:
        want = vt.denoise2(noisy_img, WAVELET, levels=4)
    finally:
        vt.set_backend("auto")
    check(den2.shape == noisy_img.shape and bool(torch.isfinite(den2).all())
          and max_err(den2, want) <= TOL_SWT,
          f"denoise2 db4 J=4 vs plain path: {max_err(den2, want):.3e} <= {TOL_SWT:.0e}")
    del den2, want
    small2 = torch.randn(2, 96, 80, device=dev, generator=gen)
    for boundary in ("periodic", "zero", "symmetric"):
        got = counted(f"modwt2_multilevel sym8 J=2 {boundary} 2x96x80",
                      {"modwt2_analysis": 2}, lambda: vt.modwt2_multilevel(
                          small2, "sym8", levels=2, boundary=boundary))
        ref = vt.modwt2_multilevel(small2.cpu().double(), "sym8", levels=2,
                                   boundary=boundary, backend="torch")
        err = max(max_err(g.cpu(), r) for g, r in zip(bands(got), bands(ref)))
        y = counted(f"imodwt2_multilevel sym8 J=2 {boundary} 2x96x80",
                    {"modwt2_synthesis": 2},
                    lambda: vt.imodwt2_multilevel(got, "sym8", boundary=boundary))
        y_ref = vt.imodwt2_multilevel(
            vt.MultiLevelMODWT2Result(tuple(tuple(p.cpu().double() for p in t)
                                            for t in got.details),
                                      got.approx.cpu().double()),
            "sym8", boundary=boundary, backend="torch")
        check(err <= TOL_F32 and max_err(y.cpu(), y_ref) <= TOL_F32,
              f"2x96x80 sym8 J=2 {boundary} 2-D kernels vs float64 CPU cascade: "
              f"analysis {err:.3e}, synthesis {max_err(y.cpu(), y_ref):.3e}")
    try:
        vt.modwt2_multilevel(small2.clone().requires_grad_(True), "db4", levels=2)
        refused = False
    except vt.InvalidArgumentError:
        refused = True
    check(refused, "a 2-D input that requires grad raises on the card")
    print(f"  launches during the 2-D path: {twod_launches}", flush=True)
    for name in TWOD_PATH:
        check(twod_launches[name] > 0, f"{name} launched {twod_launches[name]} times")
        launches[name] = twod_launches[name]

    print(f"  the packet and dual-tree path, {' and '.join(f'{b}x{n}' for b, n in PACKET_SHAPES)} "
          "float32", flush=True)
    launches.update(packet_path(dev, gen))

    print(f"  the CWT path, config #5 (1x{CFG5_N}) and {BATCH}x{N} float32", flush=True)
    for name, count in cwt_path(dev, gen).items():
        launches[name] = launches.get(name, 0) + count

    print(f"  the tiled CWT, config #5 over {' and '.join(map(str, TILED_SHARDS))} virtual "
          "shards and a 2x4 mesh", flush=True)
    for name, count in cwt_tiled_path(dev, gen).items():
        launches[name] = launches.get(name, 0) + count
    print("  what is built on the CWT: coherence, ridge, SST, significance, matching "
          "pursuit, finance", flush=True)
    for name, count in cwt_analysis_path(dev, gen).items():
        launches[name] = launches.get(name, 0) + count

    print(f"  the streaming path, {STREAM_B} streams x {STREAM_NBLK} blocks x {STREAM_BLK} "
          "float32", flush=True)
    launches.update(streaming_path(dev, gen))

    print(f"  the tiled path, {BATCH}x{N} over {' and '.join(map(str, TILED_SHARDS))} "
          "virtual shards", flush=True)
    for name, count in tiled_path(dev, gen).items():
        launches[name] = launches.get(name, 0) + count
    print(f"  the multi-process run: {MP_RANKS} ranks on this card over Gloo, "
          f"{BATCH // MP_RANKS}x{N} a rank over {MP_CHIPS} virtual shards; an NCCL world of one",
          flush=True)
    mp_launches, mp_ranks = multiprocess_path()
    for name, count in mp_launches.items():
        launches[name] = launches.get(name, 0) + count
    print(f"  the default-depth MODWT and the analysis modules, {BATCH}x{N}, 1x{LONG_N} "
          "and the 2-D CWT", flush=True)
    for name, count in analysis_path(dev, gen).items():
        launches[name] = launches.get(name, 0) + count
    print(f"  the sparse solvers, the deconvolutions, the block denoise and the decimated 2-D "
          f"trees, 1x{OPT_LONG}, {BATCH}x{N} and {'x'.join(map(str, IMG))}", flush=True)
    for name, count in optimize_path(dev, gen).items():
        launches[name] = launches.get(name, 0) + count

    print("phase 4: timing (CUDA events, 3 warm-ups, median of 20)", flush=True)
    print(smi, flush=True)
    samples = BATCH * N
    planes = mc.analysis(x, LEVELS, fd, True)
    th = torch.full((BATCH, LEVELS), 0.1, device=dev)
    pairs = mc.exact_analysis(x, None, LEVELS, fd, True)
    ops = ms.symmetric_level_ops(w, LEVELS)
    span_l, span_r, _, _ = ms.synthesis_windows(w.filter_length, ops)
    sym_res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary="symmetric")
    sym_planes = (*sym_res.details, sym_res.approx)
    noisy_16k = noisy[:1, :16384].contiguous()
    hd, tl = torch.zeros(BATCH, span_l, device=dev), torch.zeros(BATCH, span_r, device=dev)
    c = torch.randn(BATCH, N, device=dev, generator=gen)
    span = mc.composite_halo_samples(w.filter_length, LEVELS)
    bank_d = composite_bank(fd, LEVELS, dev, torch.float32)
    bank_r = composite_bank(fr, LEVELS, dev, torch.float32).flip(-1)
    sbank, g_sym, d_sym = symmetric_bank(fr, ops, dev)
    stacked = torch.stack(planes, dim=1)
    sym_stacked = torch.stack(sym_planes, dim=1)
    x64, stacked64 = x.double()[:, None], stacked.double()
    timed = {
        "modwt_analysis": (
            lambda: mc.analysis(x, LEVELS, fd, True),
            lambda: mc.analysis_plain(x, LEVELS, fd, True),
            lambda: F.conv1d(F.pad(x[:, None], (span, 0), mode="circular"), bank_d[:, None])),
        "modwt_synthesis": (
            lambda: mc.synthesis(planes, LEVELS, fr, True),
            lambda: mc.synthesis_plain(planes, LEVELS, fr, True),
            lambda: F.conv1d(F.pad(stacked, (0, span), mode="circular"), bank_r[None])),
        "modwt_denoise": (
            lambda: mc.denoise(x, th, LEVELS, fd, fr, True, "soft"),
            lambda: mc.denoise_plain(x, th, LEVELS, fd, fr, True, "soft"),
            None),
        "modwt_exact_analysis": (
            lambda: mc.exact_analysis(x, None, LEVELS, fd, True),
            lambda: mc.exact_analysis_plain(x, None, LEVELS, fd, True),
            lambda: F.conv1d(F.pad(x64, (span, 0), mode="circular"), bank_d.double()[:, None])),
        "modwt_exact_synthesis": (
            lambda: mc.exact_synthesis(pairs, LEVELS, fr, True),
            lambda: mc.exact_synthesis_plain(pairs, LEVELS, fr, True),
            lambda: F.conv1d(F.pad(stacked64, (0, span), mode="circular"),
                             bank_r.double()[None])),
        "modwt_symmetric_synthesis": (
            lambda: mc.symmetric_synthesis(sym_planes, hd, tl, LEVELS, fr, ops),
            lambda: mc.symmetric_synthesis_plain(sym_planes, hd, tl, LEVELS, fr, ops),
            lambda: F.conv1d(F.pad(sym_stacked, (g_sym, max(d_sym, 0))), sbank[None])),
        "modwt_symmetric_adjoint": (
            lambda: mc.symmetric_adjoint(c, LEVELS, fr, ops),
            lambda: mc.symmetric_adjoint_plain(c, LEVELS, fr, ops),
            lambda: F.conv1d(F.pad(c[:, None], (sbank.shape[1] - 1 - g_sym, g_sym)),
                             sbank.flip(-1)[:, None])),
        # the probe's call; the library call is rows 3 and 4's (the mirror is
        # no convolution)
        "modwt_mxu_analysis": (
            lambda: mx.run_analysis_mxu(x, LEVELS, fd, True, PROBE_TILE, "float32", False),
            lambda: mx.analysis_plain(x, LEVELS, fd, "periodic"),
            lambda: F.conv1d(F.pad(x[:, None], (span, 0), mode="circular"), bank_d[:, None])),
        "modwt_mxu_synthesis": (
            lambda: mx.run_synthesis_mxu(planes, LEVELS, fr, True, PROBE_TILE, "float32",
                                         False),
            lambda: mc.synthesis_plain(planes, LEVELS, fr, True),
            lambda: F.conv1d(F.pad(stacked, (0, span), mode="circular"), bank_r[None])),
    }
    #: bytes each kernel must move (each input read once, each output written
    #: once) and the FMAs its cascade does, per sample of one 128 x 65536 call
    plane_bytes = 4 * (LEVELS + 1)
    taps = w.filter_length
    per_sample = {  # (bytes, FMAs, FLOP/s of their type)
        "modwt_analysis": (4 + plane_bytes, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_synthesis": (plane_bytes + 4, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_denoise": (8, 4 * taps * LEVELS, FP32_FLOPS),
        "modwt_exact_analysis": (4 + 2 * plane_bytes, 2 * taps * LEVELS, FP64_FLOPS),
        "modwt_exact_synthesis": (2 * plane_bytes + 8, 2 * taps * LEVELS, FP64_FLOPS),
        "modwt_symmetric_synthesis": (plane_bytes + 4, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_symmetric_adjoint": (4 + plane_bytes, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_mxu_analysis": (4 + plane_bytes, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_mxu_synthesis": (plane_bytes + 4, 2 * taps * LEVELS, FP32_FLOPS),
    }
    extra_bytes = {"modwt_symmetric_synthesis": 4 * BATCH * (span_l + span_r)}
    ms_of, bound = {}, {}
    for name, (kernel, plain, library_call) in timed.items():
        ms_of[name] = (median_ms(kernel), median_ms(plain),
                       None if library_call is None else median_ms(library_call))
        nbytes, fmas, rate = per_sample[name]
        t_bytes = (samples * nbytes + extra_bytes.get(name, 0)) / HBM_BPS * 1e3
        t_ops = samples * fmas * 2 / rate * 1e3
        bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        k_ms, p_ms, l_ms = ms_of[name]
        print(f"  {name}: kernel {k_ms:.4f} ms "
              f"({samples / k_ms / 1e3:.1f} Msamples/s, "
              f"{samples * nbytes / k_ms / 1e6:.1f} GB/s), plain {p_ms:.4f} ms, library "
              f"{'-' if l_ms is None else f'{l_ms:.4f} ms'}, bound {bound[name][0]:.4f} ms "
              f"({bound[name][1]}; {100 * bound[name][0] / k_ms:.1f}% of it)", flush=True)
    # the cascade analysis in both edges the card's paths use (the mirror is
    # the symmetric route's launch); "ms" is the probe's periodic call
    modes = {edge: median_ms(lambda edge=edge: mx.cascade_analysis(x, LEVELS, fd, edge))
             for edge in ("periodic", "mirror")}
    print(f"  modwt_mxu_analysis by edge: {modes} ms", flush=True)
    # the symmetric synthesis at config #3's depth, sym8 J=4 (the row above
    # is db4 J=6); its bound as the row's: the planes in, x out, the splices
    w8 = vt.wavelet("sym8")
    ops8, fr8 = ms.symmetric_level_ops(w8, 4), _kernel_filters(w8, synthesis=True)
    res8 = vt.modwt_multilevel(x, "sym8", levels=4, boundary="symmetric")
    planes8 = (*res8.details, res8.approx)
    sl8, sr8 = mc.symmetric_spans(w8.filter_length, ops8)
    hd8, tl8 = torch.zeros(BATCH, sl8, device=dev), torch.zeros(BATCH, sr8, device=dev)
    t_bytes = (samples * 4 * (4 + 2) + 4 * BATCH * (sl8 + sr8)) / HBM_BPS * 1e3
    t_ops = samples * 2 * w8.filter_length * 4 * 2 / FP32_FLOPS * 1e3
    sym8_row = {
        "case": f"sym8 J=4 {BATCH}x{N}",
        "ms": median_ms(lambda: mc.symmetric_synthesis(planes8, hd8, tl8, 4, fr8, ops8)),
        "plain_ms": median_ms(
            lambda: mc.symmetric_synthesis_plain(planes8, hd8, tl8, 4, fr8, ops8), 1, 5),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  modwt_symmetric_synthesis {sym8_row['case']}: kernel {sym8_row['ms']:.4f} ms, "
          f"plain {sym8_row['plain_ms']:.4f} ms, bound {sym8_row['bound_ms']:.4f} ms "
          f"({sym8_row['bound_by']}; {100 * sym8_row['bound_ms'] / sym8_row['ms']:.1f}% of it)",
          flush=True)
    del res8, planes8

    # the 2-D level kernels at every level 1-6 of db4 on the 2-D path's
    # images, periodic (level 1 the row, every level in "levels"); library call: F.conv2d of the circularly padded input
    # with the [4, 1, L, L] outer products of the level's taps (synthesis:
    # [1, 4, L, L] on the four padded planes) at dilation 2^(j-1)
    import numpy as np

    fa2, fs2 = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    planes4 = [torch.randn(*IMG, device=dev, generator=gen) for _ in range(4)]
    stacked4 = torch.stack(planes4, dim=1)
    lo_a, hi_a = np.array(fa2[0]), np.array(fa2[1])
    lo_s, hi_s = np.array(fs2[0]), np.array(fs2[1])
    # (H filter, W filter) of ll, lh, hl, hh
    bank_a = torch.tensor(np.stack([np.outer(fh[::-1], fw[::-1]) for fh, fw in (
        (lo_a, lo_a), (lo_a, hi_a), (hi_a, lo_a), (hi_a, hi_a))]),
        dtype=torch.float32, device=dev)[:, None]
    bank_s = torch.tensor(np.stack([np.outer(fh, fw) for fh, fw in (
        (lo_s, lo_s), (lo_s, hi_s), (hi_s, lo_s), (hi_s, hi_s))]),
        dtype=torch.float32, device=dev)[None]
    pixels = math.prod(IMG)
    # each input read once and each output written once: one plane in and
    # four out (analysis) or four in and one out (synthesis); 6 L FMAs a pixel
    t_bytes2 = 20 * pixels / HBM_BPS * 1e3
    t_ops2 = 12 * taps * pixels / FP32_FLOPS * 1e3
    bound2 = (max(t_bytes2, t_ops2), "bytes" if t_bytes2 >= t_ops2 else "operations")
    deep = {}
    by_level = {name: [] for name in TWOD_PATH}
    for level in range(1, LEVELS + 1):
        sp = 1 << (level - 1)
        pad = sp * (taps - 1)
        twod = {
            "modwt2_analysis": (
                lambda: k2.analysis2_level(img, fa2, sp, "periodic"),
                lambda: k2.analysis2_level_plain(img, fa2, sp, "periodic"),
                lambda: F.conv2d(F.pad(img[:, None], (pad, 0, pad, 0), mode="circular"),
                                 bank_a, dilation=sp)),
            "modwt2_synthesis": (
                lambda: k2.synthesis2_level(*planes4, fs2, sp, k2.FORWARD_OPS, "periodic"),
                lambda: k2.synthesis2_level_plain(*planes4, fs2, sp, k2.FORWARD_OPS,
                                                  "periodic"),
                lambda: F.conv2d(F.pad(stacked4, (0, pad, 0, pad), mode="circular"),
                                 bank_s, dilation=sp)),
        }
        lib_err = max(max_err(twod["modwt2_analysis"][2]()[:, 0],
                              twod["modwt2_analysis"][0]()[0]),
                      max_err(twod["modwt2_synthesis"][2]()[:, 0],
                              twod["modwt2_synthesis"][0]()))
        check(lib_err <= 1e-4, f"level {level}: F.conv2d computes the 2-D kernels' "
                               f"function ({lib_err:.3e})")
        for name, (kernel, plain, library_call) in twod.items():
            times = (median_ms(kernel), median_ms(plain, 1, 5), median_ms(library_call, 1, 5))
            by_level[name].append({"level": level, "ms": times[0], "plain_ms": times[1],
                                   "library_ms": times[2], "bound_ms": bound2[0]})
            if level == 1:
                ms_of[name], bound[name] = times, bound2
            elif level == LEVELS:
                deep[name] = by_level[name][-1]
            print(f"  {name} level {level}: kernel {times[0]:.4f} ms "
                  f"({20 * pixels / times[0] / 1e6:.1f} GB/s), plain {times[1]:.4f} ms, "
                  f"library {times[2]:.4f} ms, bound {bound2[0]:.4f} ms ({bound2[1]}; "
                  f"{100 * bound2[0] / times[0]:.1f}% of it)", flush=True)
    del planes4, stacked4
    for name, rows in by_level.items():
        for j in (4, LEVELS):
            total = sum(r["ms"] for r in rows[:j])
            print(f"  {name} levels 1-{j}: {total:.4f} ms against a bound of "
                  f"{j * bound2[0]:.4f} ms ({100 * j * bound2[0] / total:.1f}% of it)",
                  flush=True)

    def public_round_trip(**how):
        return vt.imodwt_multilevel(
            vt.modwt_multilevel(x, WAVELET, levels=LEVELS, **how), WAVELET, **how)

    def round_trip_2d(levels):
        return vt.imodwt2_multilevel(vt.modwt2_multilevel(img, WAVELET, levels=levels),
                                     WAVELET)

    xg = noisy.clone().requires_grad_(True)
    y_fused = vt.fused_denoise_multilevel(xg, WAVELET, levels=LEVELS, thresholds=th,
                                          mode="soft")

    def probe_round_trip(precision):
        return mx.run_synthesis_mxu(
            mx.run_analysis_mxu(x, LEVELS, fd, True, PROBE_TILE, precision, False),
            LEVELS, fr, True, PROBE_TILE, precision, False)

    for label, fn, count in (
        ("modwt_multilevel + imodwt_multilevel", public_round_trip, samples),
        *((f"run_analysis_mxu + run_synthesis_mxu, precision='{p}'",
           lambda p=p: probe_round_trip(p), samples) for p in mx.PRECISIONS),
        ("modwt_multilevel + imodwt_multilevel, precision='exact'",
         lambda: public_round_trip(precision="exact"), samples),
        ("modwt_multilevel + imodwt_multilevel, boundary='symmetric'",
         lambda: public_round_trip(boundary="symmetric"), samples),
        ("modwt_roundtrip_fused", lambda: vt.modwt_roundtrip_fused(x, WAVELET, levels=LEVELS),
         samples),
        ("denoise_multilevel universal soft", lambda: vt.denoise_multilevel(
            noisy, WAVELET, levels=LEVELS, method="universal", mode="soft"), samples),
        (f"swt_denoise sym8 J=4 symmetric {BATCH}x{N}", lambda: vt.swt_denoise(
            noisy, "sym8", levels=4, boundary="symmetric"), samples),
        ("swt_denoise sym8 J=4 symmetric 1x16384 (plain synthesis)", lambda: vt.swt_denoise(
            noisy_16k, "sym8", levels=4, boundary="symmetric"), 16384),
        ("fused_denoise_multilevel soft, backward alone", lambda: torch.autograd.grad(
            y_fused, xg, weights[0], retain_graph=True), samples),
        ("modwt2_multilevel + imodwt2_multilevel db4 J=4 8x2048x2048",
         lambda: round_trip_2d(4), pixels),
        ("modwt2_multilevel + imodwt2_multilevel db4 J=6 8x2048x2048",
         lambda: round_trip_2d(LEVELS), pixels),
        ("denoise2 db4 J=4 universal soft 8x2048x2048",
         lambda: vt.denoise2(noisy_img, WAVELET, levels=4), pixels),
    ):
        t_ms = median_ms(fn)
        print(f"  {label}: {t_ms:.4f} ms ({count / t_ms / 1e3:.1f} Msamples/s)",
              flush=True)

    bank_ms, bank_bound, bank_cases = bank_timing(dev, gen)
    for name, rows in cwt_timing(dev, gen).items():
        bank_cases[name] += rows
    cwt_analysis_timing(dev, gen)
    bank_cases["modwt_symmetric_synthesis"] = [sym8_row]
    ms_of.update(bank_ms)
    bound.update(bank_bound)
    stream_ms, stream_bound = streaming_timing(dev, gen)
    ms_of.update(stream_ms)
    bound.update(stream_bound)
    tiled_ms, tiled_bound = tiled_timing(dev, gen)
    ms_of.update(tiled_ms)
    bound.update(tiled_bound)
    multiprocess_timing(dev, gen, smi, mp_ranks)
    analysis_timing(dev, gen)
    optimize_timing(dev, gen)
    print(f"  the run so far: {time.perf_counter() - run_start:.1f} s", flush=True)

    print("phase 5: the examples on the card, against the JAX examples' recordings",
          flush=True)
    t0 = time.perf_counter()
    examples_path(launches)
    print(f"  phase 5 took {time.perf_counter() - t0:.1f} s; the run so far: "
          f"{time.perf_counter() - run_start:.1f} s", flush=True)

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "mirror_launches": {p: got.get(name, 0) for p, got in mirror_launches.items()},
            "max_abs_err": worst[name],
            **({"max_abs_err_bf16": worst_bf16[name]} if name in BF16_ROWS else {}),
            "ms": ms_of[name][0],
            "plain_ms": ms_of[name][1],
            "bound_ms": bound[name][0],
            "bound_by": bound[name][1],
            "library_ms": ms_of[name][2],
            **({"deepest": deep[name], "levels": by_level[name]} if name in deep else {}),
            **({"ms_by_edge": modes} if name == "modwt_mxu_analysis" else {}),
            **({"cases": bank_cases[name]} if name in bank_cases else {}),
        }
        for name, (source, replaces) in KERNELS.items()
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [RANK_WORKER]:
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
