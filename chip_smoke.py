#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and nvcc. Imports torch, numpy and the port only (no JAX). Phases, each
printing its own lines:

1. device: the card's name and power limit (nvidia-smi); the kernel and
   model checks run float32 with TF32 off in cuDNN and cuBLAS; the host's
   CPU count, and the host data plane (``csrc/dataplane.cpp``, g++) built,
   with what it decodes;
2. build: every kernel of the paths from the checkout's sources, one nvcc
   per source, all started together (timed, with ptxas' register and spill
   lines): K1 ``dilated_residual``, K2 ``stem_pool``, Q1 ``qconv_bn``, K3
   ``window_mhsa``, K4 ``mlp_block``, K5 ``swin_block`` (the int8 branches
   of K3, K4 and K5 live in the same three sources, and K6's training
   branches are K3's and K4's float entry points without the residual),
   K7 ``attention``, K9 ``fused_norm``, K10 ``window_attention``, K8
   ``flash_attention`` (its forward, dQ and dK/dV kernels), P1
   ``int8_kernel_probe`` (its bf16, int8w and int8 GEMMs) and P2
   ``swin_pack_probe`` (its pack<g> and batched attention);
3. kernels: each kernel against its plain PyTorch version on the card:
   - K1 (bf16: a thread-block cluster per 64-row tile, the columns split
     among its CTAs, both products on wgmma fed by TMA, the hidden tile
     exchanged through distributed shared memory; float32 the FMA kernel)
     at every (dilation, causal) pair of the main path, B=4, T=256, C=512,
     in bf16 and float32, plus ragged shapes and C = 128 and 1024, the
     previous design (``dilated_residual_prev_cuda``) too at the main
     shapes; the plan and the clusters the card holds at once; its time
     and device time in turns with the previous design and the plain
     version at the offline shape (d = 1, 16, 1024) and the push's at
     streams 1 and 16 (causal, d = 16, 1024), TFLOP/s and the share of the
     bound; ptxas' registers and spills per instantiation;
   - K2 (bf16: a persistent implicit GEMM on wgmma, A built in registers
     from the staged input rows, each conv row computed once; float32 the
     FMA kernel) in bf16 and float32 at N x 256x448 frames for N = 1, 4
     and 1024 and at the JAX kernel test's ragged shapes and batch sizes,
     both designs; its time and device time in turns with the previous
     design (``stem_pool_prev_cuda``) and the plain version at N = 1, 64
     and 1024, TFLOP/s and the share of the bound; registers and spills;
   - Q1 at each of ResNet18's 19 int8 convolutions at 256x448 (N = 2
     frames), the 3-channel 7x7/2 stem and odd sizes at stride 2, through
     both paths (the quantize pass + wgmma where Cin % 16 == 0, which
     must be every ResNet18 shape, and the loop at every shape): the
     quantize pass's codes, the int8 codes, the int32 sums and the outputs
     equal the exact plain version's bit for bit, each call on the path
     ``qconv_path`` names; both paths' times (and device times) beside the
     plain version's and the bf16 cuDNN convolution's at N = 64, in turns,
     and the 19 convolutions' total beside the bound;
   - K3 (window attention half), shifted and not, at the SwinL-384 stage-2
     shape, the SwinL-224 window-7 stage-0 shape and a ragged map; K4 (MLP
     half) at the stage-2 and stage-3 shapes and a ragged token count; K5
     (whole block) at stages 0 and 1, shifted and not; bf16 and float32,
     their products on the Swin GEMM core (``swin_gemm.cuh``: a LayerNorm
     pass, then the TMA-fed wgmma GEMM); in bf16 also the outputs in which
     the core and the loop it replaced (the ``*_loop_cuda`` wrappers)
     differ, counted with the largest difference; times of the kernel, the
     loop and the plain version in turns (K5 also beside K3 then K4);
   - the window-attention phase alone (``csrc/window_attn.cuh``: each
     warp's 16-query strips of scores in registers; the attention of K3,
     K5 and K6 and the body of K10) on K3's packed qkv at Swin-L-384's
     four stage shapes, Swin-L-224's window-7 stage 0, a ragged map and a
     window of 4, shifted and not, bf16 and float32: against the plain
     version in float32 rounded once (K10's bar) and in the working dtype
     (REL_TOL), each window's absmax (the int8 branch's proj scales) equal
     to its outputs' largest magnitude; its time at the four stage shapes,
     shifted and not, beside the plain version, SDPA (the yardstick only)
     and the bound, in turns; ptxas' registers and spills of every
     instantiation;
   - the int8 branches of K3 (stage 2, shifted and not, and the window-7
     shape), K4 (stages 2 and 3) and K5 (stages 0 and 1, shifted and not)
     in bf16 and float32: the share of outputs more than one int8 step
     from the plain version's, the max error and the correlation, and
     every output equal to the ``mma.sync`` loop's bit for bit; times
     beside the loop's, the plain versions' and the float kernels';
   - Q1 as the int8 teacher's Dense layers (1x1 over (M, 1, 1, K)) at
     their shapes, both paths (the wgmma one with its TMA producer) equal
     to the plain version bit for bit; at each shape the new path's, the
     loop's, the plain version's and ``torch._int_mm``'s times in turns;
   - K7 (full attention; ``csrc/attention_common.cuh``: in bf16 a
     producer warpgroup feeding K and V (TMA for MS-TCT's views, else
     cp.async) through an mbarrier ring to wgmma consumers, in float32 a
     register-tiled FMA loop; the keys split over blocks, merged through
     the logsumexp, where ``attention_plan`` says) in bf16 and float32 at
     MS-TCT's (1, 8, T, D) for D = 32, 48, 72, 108 and T = 1000, 2048,
     5400, a batch of training windows (32, 8, 256, D) and Tq != Tk, on q,
     k, v laid out as MS-TCT passes them and contiguous, and split at the
     ragged shapes, against the plain version in float32 rounded once and
     (bf16) the plain version in bf16; each head's output bit for bit the
     same when its neighbouring heads and the next video are non-finite;
     the outputs that differ from the previous design
     (``attention_prev_cuda``) counted; in turns with the
     previous design, the plain version and SDPA (the yardstick only) at
     (1, 8, 8192, D) for each D and at D = 108 over the eval lengths and
     the training window, beside the bound and the TFLOP/s; at
     (1, 8, 8192, D) 64 query rows a block against 128;
   - K8 (flash attention: the forward, K7's kernels writing the lse; dQ
     and dK/dV, on wgmma in bf16 from the same producer machinery, FMA in
     float32) in bf16 and float32 at K8_CHECK, the ragged shapes and the
     autograd Function against the plain versions; the outputs, lse and
     gradients that differ from the previous design's counted; each
     kernel in turns with the previous design's, the plain versions and
     SDPA's forward and forward + backward, beside the bounds;
   - K9 (fused scale-bias-act) in bf16 and float32 at each of the seven
     distinct shapes of TResNet-L-448 at B = 16 and both slopes, at ragged
     shapes, on an odd-offset view and a channels_last map viewed as NHWC,
     against the plain version in float32 rounded once (and a strided view
     must raise); its time at each shape and summed over the 52 launches of
     a predict, beside the plain version's and the bound;
   - K10 (window attention) in bf16 and float32 at Swin-L-384's four stage
     shapes, shifted and not, Swin-L-224's window-7 stage 0 and ragged
     masks (nW < 8, N = 49), through both TPU entry points, against the
     plain version in float32 rounded once and in bf16; its time at the
     stage shapes and summed over the 24 launches of a forward, and in
     float32 at stage 0, beside the plain version's, SDPA's (the yardstick
     only) and its bound;
   - K6 (the training branches ``window_mhsa_branch`` and
     ``mlp_block_branch``: K3 and K4 at ``res_add=False``) in bf16 and
     float32 at the Swin-L-384 training step's batch-8 shapes of stages
     0-2 (the attention branch shifted and not) and a ragged map and token
     count, against the plain versions at ``res_add=False`` (bf16 also
     against the loop, the differences counted); each branch Function's
     gradients against autograd of the plain version on the card; its
     time at each stage beside the loop's, the plain version's and the
     bound, and summed over the 44 launches of each branch in a step;
   - P1 (the int8 kernel probe's bf16, int8w and int8 GEMMs) at the
     probe's twelve Swin-L shapes and ragged ones, int8 bit for bit
     against the plain version and the loop, the others within REL_TOL
     of the plain version (bf16's differences from the loop counted);
     M % blk != 0 and N % 64 != 0 refused; then at each of the twelve
     shapes bf16 and int8 on the Swin GEMM core and on the loop,
     ``torch.matmul`` and ``torch._int_mm`` in turns;
   - P2 (the head-grouping probe's pack<g> and batched) at its stage-1 and
     stage-3 shapes and a window of 7, each with relative-position tables
     of std 0.02 and 0.5: the attention half alone (``res_add=False``) and
     the whole output, against the plain version's and K3's; a group not
     dividing the heads refused; pack2 and batched at stage 1 and pack4
     at stage 3 with their products on the core and on the loop, in turns;
   - the Swin GEMM core's persistent walk: each epilogue (bias, bias +
     GELU, rounded residual, float32 residual, scale; the int8 ones with
     them) is held above at a product where every resident block walks at
     least 3 output tiles;
4. model: the full-width float32 EndToEndRecognizer (ResNet18, 11 + 3x10
   TCN layers, 512 maps) on the card against the same module on the CPU,
   the full-width int8 recognizer (``make_int8_e2e``, fused stem, bf16) on
   the card against the same quantized module on the CPU, each on a
   (1, 16, 256, 448, 3) clip, the full-width float32
   Q2L(swin_L_384_22k, "i") on the card against the CPU on one frame, and
   the same Q2L as the int8 teacher (``quant_eval``, ``s2d_embed``, Dense
   layers of >= 512 inputs on Q1, calibrated on the CPU) on the card
   against the CPU, the full-width float32 MSTCT on 1536-d features
   on the card against the CPU on one 1,800-frame video, the full-width
   float32 Q2L(tresnet_l, "i") (BatchNorm drawn from a seed) on one
   448x448 frame and the full-width float32 Swin-L-384 with
   ``use_fused_attn`` on one 384x384 frame, each on the card against the
   CPU; one float32 training step of the full-width Q2L(swin_L_384_22k,
   "i", ``fused_train``, remat "dots") at batch 1 with drop rates 0 on the
   card (K6) against the CPU: the loss and the gradient norms of one
   parameter per stage, the head and all; the same at loss "all", rates
   (1, 0.5, 0.1), with seeded Res18-wide teacher arrays: every loss term,
   the KD block's gradient too, and the KD block's outputs of an eval
   forward with the teacher features; one float32 training step of the
   full-width MSTCT (``make_mstct_train_step``) at batch 2 of 256 frames,
   dropout off, on the card (K7) against the CPU: the loss and the gradient
   norms;
5. offline serving at 4 x 256 frames of 256x448, uint8 in: the bf16
   InferenceSession, the int8 one (``quantize=True``) with its float stem,
   and the int8 one with the fused stem: launches of each kernel per
   predict (Q1 19 per int8 predict, each a quantize pass and the
   cp.async-fed wgmma, no loop), ms, frames/s, peak device memory;
6. streaming at context 256, streams 1 and 16: the bf16 StreamingSession
   and the int8 one with the fused stem, launches per push (Q1 as in 5)
   and ms;
7. teacher serving: ``TeacherSession.create()`` at its defaults (Swin-L-384
   Q2L, bf16) and ``TeacherSession.create(quantize=True)`` (the int8
   teacher), predicting 16 uint8 frames of 384x384 in turns: launches per
   predict (bf16: K3 18, K4 20, K5 4; int8: K5 4, K3 int8 18, K4 int8 20,
   Q1 26, each a quantize pass and the TMA-fed wgmma, no loop), ms,
   frames/s, peak device memory; then path A,
   ``TeacherSession(backbone="tresnet_l", img_size=448)`` in bf16 on 16
   uint8 frames: K9 52 launches per predict and no other kernel, ms,
   frames/s, device memory;
8. the MS-TCT driver (``cli.temporal_mstct.main``) in process, ``-e -d``
   at float32 and at bfloat16 on a synthetic CholecT45 tree (the nine
   fold-1 test videos at 1,000-6,000 frames of random 1536-d features, the
   other videos at 64): ms per video, frames/s, K7 launches (8 per video),
   peak device memory, the test mAP and both dumps;
9. breakdown: input, backbone and TCN time of one offline forward and of
   one push, for the bf16 and the int8 sessions; input, patch embed, each
   Swin stage, norm and the Q2L transformer and heads of one predict of
   each teacher, and its device time by kernel from torch.profiler; one
   MSTCT forward on 6,000 frames in each dtype by kernel kind (K7, GEMMs,
   convolutions, the rest) with the busy share, and by module type; and a
   forward at a length not run before against the same length again;
   input, stem, each stage and the Q2L head of one TResNet-L predict, its
   device time by kernel and K9's share;
10. path B, a configuration and not a serving path: the bf16 forward of 16
   frames of 384x384 through ``build_swin("swin_L_384_22k",
   use_fused_attn=True)``: K10 24 launches and no K3, K4 or K5, ms per
   forward beside the default plan's at the same weights, in turns;
11. the teacher's training step (``train.make_spatial_train_step``, as
   ``scripts/train_bench.py`` drives the JAX one) on Q2L(swin_L_384_22k,
   "i", bf16, remat "dots") at batch 8 of 384x384 seeded frames with
   seeded multi-hot labels, SGD at lr 1e-2 with weight decay 1e-5: 20
   steps of the ``fused_train`` plan (K6: 44 launches of each branch per
   step, the forward and the remat replay) and of the plain plan, in
   turns, from the same weights and generator seed: launches per step, ms
   per step (the median of 10 after 2 warm-up steps), frames/s, peak
   device memory, the losses (finite, falling, the two plans within 8 bf16
   ulps of each other); then the trained module's eval forward (K5, K3 +
   K4, no K6) against the plain eval plan, and one step under
   torch.profiler by kind (K6, cuBLAS GEMMs, the rest) with the busy
   share.

12. K8's op path, as a user calls it: ``flash_attention`` forward and
   backward at the training window for each D and ``flash_attention_pallas``
   over a 5,400-frame video, bf16: one forward with the lse, one dQ, one
   dK/dV and one forward without the lse per D;
13. MS-TCT training: the driver ``-t --window 256 -b 32`` in process at
   full width on a tree whose 31 training videos hold 300-2,000 frames (one
   180, shorter than the window: the short-window path), float32 and bf16,
   2 epochs, then ``--resume`` for one more: K7 launches (a step forwards
   its full windows together and the short one alone, 8 launches each;
   8 per validation video), the steps (2, then 3), the losses, wall time
   and peak device memory; then, after the main paths, the step on one
   fixed batch of 32 windows of 256 frames, 20 steps per dtype: ms per step
   host to host, frames/s, peak device memory, the loss falling, a
   profiled step by kind, and the checkpoint written, restored into a fresh
   state and equal;
14. the probe drivers, as a user runs them: ``main()`` of
   ``computervision_codes_tpu_torch.scripts.int8_kernel_probe`` (P1 at
   the JAX probe's twelve shapes, each variant beside its plain version,
   ``torch.matmul`` / ``torch._int_mm`` and its bound) and of
   ``scripts.swin_pack_probe`` (K3's loop, each pack<g> and batched at
   stages 1 and 3), every row held to its plain version.
15. the frame source and the video inference CLI (``phase_frames``,
   after phase 7): (a) a PNG video of 1,100 frames of 256x448 through
   ``cli.infer.main`` offline with ``--random_init --quantize --device
   cuda`` (two predicts of 4 x 256, the second padded): the per-frame
   probabilities equal to the same session's ``predict`` on the frames in
   memory padded the same way, K1 41 and Q1 19 (conv path, each after a
   quantize pass, no loop) per predict; ``--streaming`` over its first 64
   frames equal to direct ``push`` calls; (b) 256 PNG frames of 854x480:
   ``decode_batch_u8`` to 256x448 at 1, 8 and every host thread (frames/s,
   warm reads), ``cli.infer`` end to end over 2,048 of them (decode
   overlapped with predict) beside the same int8 session's predict alone;
   (c) ``cli.common.evaluate_videos`` over a 64-frame PNG tree of
   384x384 with the bf16 Swin-L-384 teacher at batch 16 (a finite mAP, K3,
   K4 and K5 per predict as in phase 7), and ``prefetch_to_device`` equal
   to the host batches of ``batch_iterator`` (eval and train).
16. the frame-level training drivers (``phase_spatial_drivers``, after
   phase 11) on one PNG tree of fold 1 (8 frames of 384x384 a video):
   (a) ``cli.spatial_transformer.main`` at full width, Swin-L-384 Q2L,
   ``--loss_type all --rates 1 0.5 0.1 --teacher_dim 512 -b 8 --dtype
   bfloat16 --fused_train --remat``, on seeded Res18 and Res18TCN stores:
   ``-t -e -d`` (K6 88 launches and 176 wgmma products a step; K5 4, K3
   18, K4 20 a validation, test and dump forward; no loop product), every
   loss term finite, the mAP in [0, 1], a 45-video dump of finite
   (8, 1536) float32; ``-e -d --quant_eval`` (the int8 branches as the
   int8 teacher's plan, its dump not equal to the float one); ``--resume``
   for one more epoch (the step count continues); (b)
   ``cli.spatial_cnn.main`` at its defaults (ResNet18, 256x448, float32,
   ``-b 32``) with ``--loss_type all`` on (a)'s dump and a seeded
   Q2LMSTCT store: ``-t -e -d``, then one epoch each of ``--optimizer
   sam`` and ``--qat`` (losses finite, running statistics moved, a
   45-video (8, 512) dump), the ``--qat`` eval equal to a forward over
   quantize -> dequantize weights computed here, and no launch of any
   kernel of the port; of each run the epoch's frames over the wall time
   of its training loop (end to end), the period between steps and an eval
   forward's span on the card's clock (CUDA events; nothing synchronises
   between steps), and the peak memory.
17. the temporal TCN driver at full width (``phase_tcn_driver``; 512-d
   non-negative features of 45 videos of 1,000-6,000 frames, 11 + 3 x 10
   layers at 512 maps, float32, ``-l 0.001``): MT4MTLKD's tenco mode ``-t
   -e --mask``, TERL's TCN_black ``-t -e --dedup_black --loss_type single
   --weight_source balancing``, then ``--resume``; K1 0 launches a
   training step and 41 an eval forward; before it ``phase_model_tcn``: an
   eval forward and a training step (dropouts and mask 0) on the card
   against the CPU;
18. TERL's learnT driver at full width (``phase_terl_driver``; Swin-T 224,
   moco_dim 768, a queue of 16384, ``--mlp``, bf16, synthetic PNG frames):
   ``-t -e --fused_train`` (K6 12 + 12 and the key encoder's K3 + K4 12
   + 12 a step), ``-t -e``, ``-t --ht``, ``--cam_dump``; K3 + K4 12 + 12
   an eval forward, no loop product; before it ``phase_model_terl``: one
   float32 ``kcl_k=0`` step on the card against the CPU.
19. the backbone zoo and augmentation on the device: beside phase 3,
   ``phase_q1_tresnet`` holds Q1 at each of the int8 TResNet-L-448's 17
   distinct convolutions (85 a forward: 42 on the TMA producer, 22 on
   cp.async, the 21 with Cin 76 or 152 on the mma.sync loop), bf16 and
   float32, with no activation and the leaky epilogue at 1e-2 and 1e-3,
   on its path and on the loop, against the plain version bit for bit,
   and times each shape on its path, on the loop and plain at batch 16;
   beside phase 4, ``phase_model_zoo`` holds the float32 CvT-w24-384 and
   the int8 TResNet-L-448 on the card against the CPU, and
   ``phase_device_augment`` the device augmentation with fixed draws
   (ops exact, rotations within a level) and times a batch of 32 frames
   at 256x448; on the main path, ``phase_zoo_sessions`` predicts with
   CvT-w24-384 teacher sessions in bf16 and int8 (Q1's TMA path under
   193 Dense calls; the attention the plain version, no K7) and the
   TResNet-L-448 session with ``quantize=True`` (K9 52, Q1 19),
   ``phase_int8_tresnet`` runs the int8 TResNet-L backbone (Q1 by path a
   forward, fidelity to the bf16 backbone, both timed in turns) and
   ``scripts.zoo_bench``'s rows, ``phase_zoo_drivers`` the teacher
   driver's ``-t`` at CvT-w24-384 and TResNet-L-448, and
   ``phase_augment_drivers`` the student's and TERL's epochs without and
   with ``--device_augment``, in turns.
20. the parallel paths and the servables at world size 1 on NCCL (a
   ``file://`` store in a temporary directory; ``phase_parallel``, after
   phase 15): (a) ``InferenceSession.create(mesh=...)`` bf16 and int8
   fused stem against phase 5's meshless sessions, bit for bit, K1 41 (Q1
   19, K2 1) a predict, in turns; (b) ``export`` and ``load_exported`` of
   those two and of bf16 and int8 ``StreamingSession``s (the TCN's depth
   cut), bit for bit, the load's time; ``cli.export --quantize`` from a
   checkpoint the port wrote and ``cli.infer --servable`` over 300 PNG
   frames, equal to phase 5's int8 float-stem session (no calibration in
   the load: Q1 19 a predict); (c) ``parallel.long_video.eval_sharded`` of
   the full-width MS-TCT over a 4,096-frame video, gathered (K7 8) and ring
   (K8's forward 8), and of the bf16 session's TCN (K1 41 on the
   halo-extended shard), against the unsharded forwards; (d) a DP step of
   the ResNet18 student and a TP step of Swin-T/Q2L against their
   single-device steps, and a pipelined Swin-T stage against its blocks in
   order; (e) ``utils.profiling.trace`` around one predict, whose Chrome
   trace names K1's kernel 41 times. More ranks than one need more cards:
   the CPU tests hold every collective at 2 and 4 gloo ranks.
Beside phase 3, ``phase_swin_widths`` times K3-K6 at Swin-T's and the
nano's widths (C 96, 192, 32: N tiles of 96 and 32) against their plain
versions with each launch's products per path, and
``phase_teacher_swin_t`` predicts with a bf16 Swin-T ``TeacherSession``.

Phases 5-6 (the student's main path), phase 7 (the Swin teachers', then
path A), phase 15 (the video inference CLI's, then the dataset path's), phase
16 (the teacher's training driver's, then the student's), phases 17 and 18
(the TCN driver's, TERL's), phase 20 (the parallel paths', each call
under test counted from just before it), the Swin-T teacher's predict,
phase 8 (MS-TCT's), phase 10 (path B), phase 11 (the teacher's
training), phase 12 (K8's op path), phase 13 (MS-TCT training) and phase
14 (the probe drivers) each start with every launch count set to 0 and read them just after, and each
kernel must have launched on its path (Q1's per path too: on the student's
paths the cp.async-fed wgmma, on the teacher's the TMA-fed one, each after
a quantize pass, and the loop on none; the Swin GEMM core's products per
path: on the teachers and the training steps wgmma only, none on the
loops or the FMA loop, and each library's C counts equal to the counts
``ops/swin_gemm.py``'s rule gives its wrappers; the window-attention
phase's launches, "window_attn": 22 per predict of either Swin teacher,
24 per path-B forward, 44 per training step, each library's C counts equal
to its wrappers'; K1's and K2's launches per design, the previous
designs' on no path and each library's C counts equal to its wrappers';
K7's and K8's launches per design, the previous design's
on no path, each library's C counts per kernel and design equal to its
wrappers', and one MS-TCT forward 8 K7 launches of the current design);
K5's int8
branch runs on no serving path (it serves dims >= ``quant_min_dim``, 768, and K5
only dims <= 384), so its count is 0 there and only phase 3 launches it. Then one JSON line
with the kernels (each with its bound: the larger of its operations at the
H100's published peak for their type and its bytes at 3.35 TB/s; Q1's
entry is the new path's 19-convolution total at N = 64 with the loop's,
the device times, ``launches_by_path`` and the Dense readings beside; K7's
entry is bf16 at (1, 8, 8192, 108) on MS-TCT's views, with the previous
design's time as ``prev_ms``, its float32 readings at that shape under
``float32``, every timed shape under ``by_shape``, the differences from
the previous design and ptxas' registers and spills; K6's two entries are bf16 at Swin-L-384's stage 2
at batch 8, shifted, with each stage's time and the sums over a training
step beside; K8's three entries are bf16 at (1, 8, 8192, 108) with their
float32 and training-window readings and the previous design's times
(``prev_ms``) beside, the backward kernels'
``plain_ms`` the plain backward that computes dq, dk and dv together and
their ``library_ms`` null, SDPA's forward + backward beside; P1's three
entries at MLP1 s3 (9216 x 768 x 3072), ``library_ms`` ``torch.matmul``
or ``torch._int_mm``, with every shape's ms beside; P2's two entries,
pack2 and batched at stage 1, ``library_ms`` null, with every stage's
formulations beside; K3-K6's, P1's and P2's entries with the loop's time
as ``loop_ms``; ``swin_gemm``, the Swin GEMM core: bf16 at MLP1 s3 beside
``torch.matmul``, int8 beside ``torch._int_mm``, its times at every P1
shape, K3/K4/K5/K6 against the loop and its products per path on each
main path; ``window_attn``, the window-attention phase: bf16 at Swin-L-384
stage 0 shifted beside SDPA, every stage shape's times, float32, the
registers and its launches per path), and the last
line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero and the
last line is not printed. Without a CUDA card, or outside a checkout, it
exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PACKAGE = "computervision_codes_tpu_torch"
sys.path.insert(0, str(ROOT))
try:  # the card's published peaks and the event timer, shared with the probes
    from computervision_codes_tpu_torch.utils.timing import (
        PEAK_BYTES_S, PEAK_OPS_S, bound, bound_mixed, cuda_ms)
except ImportError:
    print(f"FAIL: {PACKAGE}/ not found beside {Path(__file__).name}: run "
          f"from a checkout of the repository", file=sys.stderr)
    sys.exit(1)
DEVICE = "cuda"
# name -> the TPU kernel (or, for Q1, the XLA op and epilogue) it replaces;
# the "_q8" names are the int8 branches of K3, K4 and K5
KERNELS = {
    "dilated_residual": "computervision_codes_tpu/ops/dilated_conv.py:88",
    "stem_pool": "computervision_codes_tpu/ops/stem_pool.py:148",
    "qconv_bn": "computervision_codes_tpu/ops/quant.py:41 + :63",
    "window_mhsa": "computervision_codes_tpu/ops/window_mhsa.py:209",
    "mlp_block": "computervision_codes_tpu/ops/mlp_block.py:139",
    "swin_block": "computervision_codes_tpu/ops/swin_block.py:133",
    "window_mhsa_q8":
        "computervision_codes_tpu/ops/window_mhsa.py:158-159,181-183",
    "mlp_block_q8": "computervision_codes_tpu/ops/mlp_block.py:59-71,85-88",
    "swin_block_q8":
        "computervision_codes_tpu/ops/swin_block.py:76-78,94-96,107-111",
    "attention": "computervision_codes_tpu/ops/attention.py:61",
    "fused_scale_bias_act": "computervision_codes_tpu/ops/fused_norm.py:44",
    "window_attention":
        "computervision_codes_tpu/ops/window_attention.py:57 + :107",
    "window_mhsa_branch": "computervision_codes_tpu/ops/swin_train.py:33",
    "mlp_block_branch": "computervision_codes_tpu/ops/swin_train.py:69",
    "flash_attention_fwd":
        "computervision_codes_tpu/ops/attention.py:147 + :351",
    "flash_attention_dq": "computervision_codes_tpu/ops/attention.py:390",
    "flash_attention_dkv": "computervision_codes_tpu/ops/attention.py:418",
    "probe_gemm_bf16": "scripts/int8_kernel_probe.py:78",
    "probe_gemm_int8w": "scripts/int8_kernel_probe.py:80",
    "probe_gemm_int8": "scripts/int8_kernel_probe.py:83",
    "mhsa_pack": "scripts/swin_pack_probe.py:177",
    "mhsa_batched": "scripts/swin_pack_probe.py:198",
    "swin_gemm": "computervision_codes_tpu/ops/window_mhsa.py:273, "
                 "ops/mlp_block.py:201, ops/swin_block.py:187 (the products "
                 "inside them); scripts/int8_kernel_probe.py:78,83",
    "window_attn": "computervision_codes_tpu/ops/window_mhsa.py:73 "
                   "(packed_window_attention, the attention of :273's "
                   "_kernel, which K5 and K6 run too) + "
                   "ops/window_attention.py:39, :85 (K10's _kernel, "
                   "_kernel_multi)",
}
# the CUDA source of each (csrc/<source>.cu); K6's branches are K3's and
# K4's float entry points without the residual
SOURCES = {name: name.removesuffix("_q8").removesuffix("_branch")
           for name in KERNELS} | {"fused_scale_bias_act": "fused_norm"} | {
    f"flash_attention_{k}": "flash_attention" for k in ("fwd", "dq", "dkv")
} | {f"probe_gemm_{k}": "int8_kernel_probe"
     for k in ("bf16", "int8w", "int8")} | {
    k: "swin_pack_probe" for k in ("mhsa_pack", "mhsa_batched")}
# the Swin GEMM core is a header that K3, K4, K5 (K6), P1 and P2 include;
# its launches are its wgmma products, counted per path by ops/swin_gemm.py
HEADERS = {"swin_gemm": "swin_gemm.cuh", "window_attn": "window_attn.cuh"}
OFF_MAIN_PATH = {"swin_block_q8"}  # no serving path reaches it
# the int8 branches against their plain versions: an int8 code of an input
# can move by one where the kernel's float32 sums (LayerNorm statistics,
# epilogues, expf) differ in the last bits from the plain version's; that
# moves an output by about one int8 step (max|ref| / 127) of its scale.
# So at most 1e-4 of the outputs more than one step off, none more than
# two, and a correlation of at least 0.9999
Q8_MAX_SHARE, Q8_MAX_STEPS, Q8_MIN_CORR = 1e-4, 2.0, 0.9999
LAYERS_PER_FORWARD = 11 + 3 * 10  # dilated layers of the default TCN
INT8_CONVS = 19  # ResNet18: 16 block convs + 3 downsamples
# the serving geometry: (B, T, H, W) offline, K1 at (B, T, C)
OFFLINE = (4, 256, 256, 448)
LAYER = (4, 256, 512)
MODEL_CLIP = (1, 16, 256, 448)
OFFLINE_CALLS = 6  # per session; the first warms up
STREAM_CONTEXT, STREAM_COUNTS, PUSHES = 256, (1, 16), 8
# bf16 keeps 8 significant bits; the plain bf16 version rounds about six
# times per element, the kernel twice, so allow 8 ulps at the output's
# largest magnitude. float32: sums of up to 1536 products taken in another
# order, far inside 1e-4 relative to the largest magnitude.
REL_TOL = {torch.bfloat16: 8 * 2.0 ** -8, torch.float32: 1e-4}
# K1 beyond C = 512: (B, T, C, dilation, causal) at the narrowest and the
# widest C the kernel takes (clusters of 2 and of 8 CTAs of 128 columns,
# and at C = 128 of one CTA where the layer's clusters outnumber the card's)
K1_WIDTHS = [(2, 70, 128, 16, False), (2, 70, 128, 1, True),
             (1, 300, 1024, 4, True), (2, 130, 1024, 64, False),
             (72, 64, 128, 3, True)]  # more clusters than fit: one CTA each
# K1's plan held to the C library's at (B, T, C): the offline and push
# shapes (one wave of 64-column clusters at streams 1, 128-column ones
# beyond) and the narrowest and widest C
K1_PLANS = [(4, 256, 512), (1, 256, 512), (16, 256, 512), (1, 256, 128),
            (2, 300, 1024)]
# K1's timed shapes at T = 256, C = 512, bf16: (B, dilation, causal), the
# offline predict's (B = 4) and the push's at streams 1 and 16 (causal)
K1_TIMED = [(4, 1, False), (4, 16, False), (4, 1024, False),
            (1, 16, True), (1, 1024, True), (16, 16, True), (16, 1024, True)]
# full model, float32, card vs CPU: 17 convolutions and 41 residual layers
# with sums in another order (and other cuDNN algorithms)
MODEL_REL_TOL = 1e-3
# int8 model, bf16, card vs CPU: K2's float32 sums in another order can
# move a bf16 activation by one ulp, and so an int8 code of the next layer
# by one, and K1 and the bf16 TCN round differently from their plain
# versions, so the bound is a correlation of each output with the CPU's
INT8_MODEL_MIN_CORR = 0.999
# K2: float32 sums of 147 products in another order (the JAX kernel test's
# 2e-5 absolute); bf16: both sides round the same float32 sum once, so one
# bf16 ulp of the largest output
STEM_F32_ATOL = 2e-5
STEM_CASES = ([(4, 256, 448), (1024, 256, 448)]
              + [(2, 32, 56), (2, 16, 16), (2, 24, 40)]
              + [(n, 16, 16) for n in (9, 10, 11, 16, 22)])
STEM_TIME_N = (1, 64, 1024)  # the push, a batch, the offline predict
Q1_CHECK_N, Q1_TIME_N = 2, 64
# the wgmma path's persistent walk, bit for bit: each case at the frames
# that give every resident block at least this many output tiles
Q1_WALK_TILES = 3
# Q1 beyond ResNet18's block convs: (what, Cin, Cout, k, stride, pad, H, W)
Q1_EXTRA = [("stem 7x7/2 Cin=3", 3, 64, 7, 2, 3, 256, 448),
            ("odd 7x7/2 Cin=3", 3, 64, 7, 2, 3, 17, 29),
            ("odd 3x3/2", 64, 128, 3, 2, 1, 33, 57),
            ("odd 1x1/2", 64, 128, 1, 2, 0, 33, 57),
            ("odd 3x3/2 Cin=24", 24, 40, 3, 2, 1, 9, 11)]
TASK_SIZES = {"ivt": 100, "i": 6, "v": 10, "t": 15}
# the teacher: TeacherSession.create() at its defaults (Swin-L-384 Q2L,
# loss "i", bf16), B x img x img uint8 frames per predict; per predict K5
# runs at stages 0-1 (4 blocks), K3 + K4 at stage 2 (18), K4 at stage 3
# (2), and the window-attention phase ("window_attn") once per K3 and K5
# launch (22)
TEACHER_BACKBONE, TEACHER_BATCH, TEACHER_IMG = "swin_L_384_22k", 16, 384
TEACHER_LAUNCHES = {"window_mhsa": 18, "mlp_block": 20, "swin_block": 4,
                    "window_attn": 22}
# the int8 teacher (quantize=True): K5 float at stages 0-1, the int8 K3 +
# K4 at stage 2 (18 each; the phase 22 again), the int8 K4 after the plain
# attention half at stage 3 (2), and Q1 for the 26 Dense layers of >= 512
# inputs (3 patch merges, stage 3's qkv and proj, the input projection, 6
# in the encoder layer and 12 in the two decoder layers)
TEACHER_Q8_LAUNCHES = {"swin_block": 4, "window_mhsa_q8": 18,
                       "mlp_block_q8": 20, "qconv_bn": 26, "window_attn": 22}
# the Swin GEMM core's wgmma products per predict of either teacher (4 per
# K5 launch, 2 per K3 and K4: 16 + 36 + 40) and of the float32 int8
# teacher (its int8 K3 and K4 only: K5's float32 products take the FMA
# loop)
TEACHER_GEMMS = {"swin_gemm": 92}
TEACHER_Q8_F32_GEMMS = {"swin_gemm": 76}
TEACHER_CALLS = 6  # the first warms up
TEACHER_MODEL_FRAMES = 1  # full-width float32 Q2L, card vs CPU
TEACHER_MODEL_REL_TOL = 1e-3  # 24 blocks and the decoder, sums reordered
# int8 teacher, float32, card vs CPU: as the int8 student, the correlation
# of each output with the CPU's (codes may move by one, see Q8_*); the
# int8 student's card runs reached 0.99986
TEACHER_Q8_MIN_CORR = 0.9998
# kernel checks: (what, B, Hp=Wp, C, heads, window) for K3 and K5, shifted
# by window // 2 and not; (what, tokens, C, hidden) for K4
# Swin-T-224's stages 0 and 1 (C 96 and 192, window 7) and the nano's stage
# 0 (C 32, window 4) at batch 16: C 96 and 32 are the widths off 64, whose
# products (N 288, 96 and 32) take the Swin GEMM core's N tiles of 96 and 32
SWIN_WIDTH_CASES = [("SwinT-224 stage 0", 16, 56, 96, 3, 7),
                    ("SwinT-224 stage 1", 16, 28, 192, 6, 7),
                    ("nano-64 stage 0", 16, 16, 32, 1, 4)]
# one bf16 predict of the Swin-T-224 teacher: window 7 is odd, so each of
# the 12 blocks is K3 + K4 ("split"), 4 wgmma products and an attention
# phase each
SWIN_T_TEACHER_LAUNCHES = {"window_mhsa": 12, "mlp_block": 12,
                           "window_attn": 12, "swin_gemm": 48,
                           "swin_gemm wgmma": 48}
K3_CASES = [("SwinL-384 stage 2", 16, 24, 768, 24, 12),
            ("SwinL-224 stage 0, window 7", 16, 56, 192, 6, 7),
            ("ragged, 3 x 21x14", 3, (21, 14), 64, 2, 7), *SWIN_WIDTH_CASES]
K4_CASES = [("SwinL-384 stage 2", 16 * 24 * 24, 768, 3072),
            ("SwinL-384 stage 3", 16 * 12 * 12, 1536, 6144),
            ("ragged tokens", 1000, 192, 768),
            *((what, b * hw * hw, c, 4 * c)
              for what, b, hw, c, _, _ in SWIN_WIDTH_CASES)]
K5_CASES = [("SwinL-384 stage 0", 16, 96, 192, 6, 12),
            ("SwinL-384 stage 1", 16, 48, 384, 12, 12), *SWIN_WIDTH_CASES]
# the window-attention phase alone (csrc/window_attn.cuh, the attention
# of K3, K5, K6 and K10's body) on K3's packed qkv: (what, B, map side or
# (Hp, Wp), heads, window), shifted by window // 2 and not where the map
# holds more than one window; timed at the first four (Swin-L-384's
# stages), in float32 at stage 0
ATTN_CASES = [("SwinL-384 stage 0", 16, 96, 6, 12),
              ("SwinL-384 stage 1", 16, 48, 12, 12),
              ("SwinL-384 stage 2", 16, 24, 24, 12),
              ("SwinL-384 stage 3", 16, 12, 48, 12),
              ("SwinL-224 stage 0, window 7", 16, 56, 6, 7),
              ("ragged, 3 x 21x14", 3, (21, 14), 2, 7),
              ("window 4", 2, 8, 2, 4)]
# the int8 branches: K3 at stage 2 and the window-7 shape (padded queries),
# K4 at stages 2 and 3, K5 at stages 0 and 1
K3_Q8_CASES = K3_CASES[:2]
K4_Q8_CASES = K4_CASES[:2]
K5_Q8_CASES = K5_CASES[:2]
# the int8 teacher's Dense layers on Q1 at batch 16: (what, M, K, N)
Q1_DENSE = [("stage-3 attn qkv", 16 * 144, 1536, 4608),
            ("merge0 reduction", 16 * 48 * 48, 768, 384),
            ("merge2 reduction", 16 * 144, 3072, 1536),
            ("Q2L linear1", 16 * 144, 1536, 8192),
            ("Q2L linear2", 16 * 144, 8192, 1536),
            ("decoder q_proj, 6 queries", 16 * 6, 1536, 1536)]
Q1_DENSE_TIMED = "Q2L linear1"  # the largest (with linear2) by operations
Q1_HOST_CALLS = 500  # calls timed on the host clock at the smallest Dense
# K7 (attention): MS-TCT's head dims at its full width (dims 256, 384, 576,
# 864 over 8 heads), whole videos of these lengths, a batch of training
# windows (B, H, T), and keys fewer than queries (B, H, Tq, Tk); times at
# (1, 8, K7_TIME_T, D), the longest bucket of the JAX driver
K7_DIMS = (32, 48, 72, 108)
K7_LENGTHS = (1000, 2048, 5400)
K7_WINDOW = (32, 8, 256)
K7_RAGGED = (2, 8, 1000, 777)
K7_TIME_T = 8192
# the kernel against the plain version in float32, rounded once: 2 bf16
# ulps of the output's largest magnitude (the kernel rounds its weights to
# bf16 before the PV product, within about 2^-9 of max|v|), 1e-5 of it in
# float32 (sums in another order). Against the bf16 plain version, which
# rounds q * scale and every score to bf16 before the softmax (a score s
# moves by up to 2^-9 |s|, and each weight exp(s - m) with it), 8 ulps
K7_BF16_ULPS, K7_F32_REL, K7_PLAIN_BF16_ULPS = 2, 1e-5, 8
# the SFUs' exp rate (16 per clock per SM, 132 SMs, 1.98 GHz boost; H100
# SXM data sheet): at D = 32 and 48 the exponentials, not the tensor
# cores, bound K7
PEAK_EXP_S = 16 * 132 * 1.98e9
# MS-TCT at the driver's full width on 1536-d Q2L features: K7 launches per
# forward (4 stages x 2 blocks), the card-vs-CPU model check's video, and
# the main path's tree: the nine fold-1 test videos at lengths spread over
# 1,000-6,000 frames, every other video at 64 (``--dump`` evaluates all)
MSTCT_IN, MSTCT_LAUNCHES, MSTCT_MODEL_T = 1536, 8, 1800
MSTCT_TEST_LENGTHS = tuple(int(t) for t in np.linspace(1000, 6000, 9))
MSTCT_OTHER_LENGTH = 64
MSTCT_KW = {}  # MSTCT's defaults: the driver's full width
MSTCT_CLASSES, MSTCT_EMBED = 100, 512
# path A: TeacherSession(backbone="tresnet_l", img_size=448), bf16, B
# uint8 frames per predict; K9 runs every activated ABN: 52 per forward
# (stem 1, nine basic blocks 1 each, 21 bottlenecks 2 each)
TRESNET, TRESNET_IMG, TRESNET_BATCH = "tresnet_l", 448, 16
TRESNET_SPEC = dict(width=76, layers=(4, 5, 18, 3))  # models.tresnet's
TRESNET_LAUNCHES = {"fused_scale_bias_act": 52}
# K9 against its plain version evaluated in float32 from the same rounded
# constants, rounded once: the same float32 operations in the same order
# (no FMA contraction in the kernel), so bit for bit; the bounds, 1e-6 of
# max|ref| in float32 and one bf16 ulp of it in bf16, would show a
# contraction. Ragged shapes (B, H, W, C): C = 3, an odd row count at C =
# 76, C not a multiple of 8 (20, 6: 8- and 4-byte loads), a thin batch
K9_F32_REL, K9_BF16_ULPS = 1e-6, 1
K9_RAGGED = [(3, 7, 5, 3), (1, 13, 11, 76), (2, 9, 7, 20), (2, 5, 3, 6),
             (4, 3, 3, 608)]
# path B: build_swin("swin_L_384_22k", use_fused_attn=True), a bf16 eval
# forward of 16 frames: every block's attention core on K10, 24 launches
# (2 + 2 + 18 + 2 blocks, each one launch of the window-attention phase's
# body, "window_attn"), no K3, K4 or K5
SWIN_FUSED_LAUNCHES = {"window_attention": 24, "window_attn": 24}
SWIN_FUSED_CALLS = 3  # timed forwards of each plan, in turns
# K10 at Swin-L-384's four stage shapes and Swin-L-224's window-7 stage 0:
# (what, B, map side, heads, window, blocks of the stage at Swin-L-384);
# ragged: (what, B*nW, heads, N, nW) with a random 0/-100 mask of nW
# windows, window w taking mask[w mod nW] (the multi kernel's tiling)
K10_CASES = [("SwinL-384 stage 0", 16, 96, 6, 12, 2),
             ("SwinL-384 stage 1", 16, 48, 12, 12, 2),
             ("SwinL-384 stage 2", 16, 24, 24, 12, 18),
             ("SwinL-384 stage 3", 16, 12, 48, 12, 2),
             ("SwinL-224 stage 0, window 7", 16, 56, 6, 7, 0)]
K10_RAGGED = [("nW 3 of 15 windows, N 49", 15, 2, 49, 3),
              ("nW 2 of 6 windows, N 144", 6, 4, 144, 2),
              ("nW 5 of 10 windows, N 16", 10, 3, 16, 5),
              ("no mask, N 100", 7, 2, 100, 1)]
# as K7: against the plain version in float32, rounded once, 2 bf16 ulps of
# max|ref| (P rounded to bf16 before the PV product) and 1e-5 of it in
# float32; against the bf16 plain version (q * scale and the scores in
# bf16) 8 ulps
K10_BF16_ULPS, K10_F32_REL, K10_PLAIN_BF16_ULPS = 2, 1e-5, 8
# K6, the training branches (K3 and K4 without the residual), at the
# shapes of the Swin-L-384 training step at batch 8: (what, B, map side,
# C, heads, window, blocks of the stage) for the attention branch, shifted
# and not, and (what, tokens, C, hidden, blocks) for the MLP branch, plus
# a ragged map and token count; the gradient check at (what, B, side, C,
# heads, window) and (what, tokens, C, hidden)
TRAIN_BATCH, TRAIN_IMG = 8, 384
K6_ATTN_CASES = [("SwinL-384 stage 0, batch 8", 8, 96, 192, 6, 12, 2),
                 ("SwinL-384 stage 1, batch 8", 8, 48, 384, 12, 12, 2),
                 ("SwinL-384 stage 2, batch 8", 8, 24, 768, 24, 12, 18),
                 ("ragged, 3 x 21x14", 3, (21, 14), 64, 2, 7, 0),
                 *((f"{what}, batch 8", 8, hw, c, heads, w, 0)
                   for what, _, hw, c, heads, w in SWIN_WIDTH_CASES)]
K6_MLP_CASES = [("SwinL-384 stage 0, batch 8", 8 * 96 * 96, 192, 768, 2),
                ("SwinL-384 stage 1, batch 8", 8 * 48 * 48, 384, 1536, 2),
                ("SwinL-384 stage 2, batch 8", 8 * 24 * 24, 768, 3072, 18),
                ("ragged tokens", 1000, 192, 768, 0),
                *((f"{what}, batch 8", 8 * hw * hw, c, 4 * c, 0)
                  for what, _, hw, c, _, _ in SWIN_WIDTH_CASES)]
K6_GRAD_ATTN = ("SwinL-384 stage 2, batch 2", 2, 24, 768, 24, 12)
K6_GRAD_MLP = ("SwinL-384 stage 2, batch 2", 2 * 24 * 24, 768, 3072)
# the training step (main path): make_spatial_train_step on Q2L(swin_L_384,
# "i", bf16, remat "dots", fused_train) at batch 8, SGD lr 1e-2, weight
# decay 1e-5 (scripts/train_bench.py:92-135); each K6 branch launches once
# per block of stages 0-2 (22) in the forward and once more in the remat
# replay; TRAIN_STEPS steps of each plan in turns on one fixed batch, the
# first TRAIN_WARM warming up and the next TRAIN_TIMED timed
TRAIN_LAUNCHES = {"window_mhsa_branch": 44, "mlp_block_branch": 44,
                  "window_attn": 44}
TRAIN_GEMMS = {"swin_gemm": 176}  # bf16: 2 products a branch launch
TRAIN_STEPS, TRAIN_WARM, TRAIN_TIMED = 20, 2, 10
TRAIN_POSITIVE = 0.3  # the share of positive labels, seeded multi-hot
# the fused and plain plans' losses at the same weights and generator
# seed: bf16 rounding apart, 8 bf16 ulps of max(1, loss)
TRAIN_LOSS_REL = REL_TOL[torch.bfloat16]
# the trained module's eval forward (K5, K3 + K4) against the plain eval
# plan, bf16: as tests/test_torch_swin.py holds the two packages' bf16
# paths, 4% of the largest magnitude and a correlation of at least 0.999
TRAIN_EVAL_REL, TRAIN_EVAL_CORR = 0.04, 0.999
# the float32 training step, card against CPU: the loss within 1e-4 of
# max(1, loss) (sums in another order); the gradient norms within 1e-2,
# relative: a ReLU unit of the Q2L FFN within float32 noise of 0 may flip
# between the two devices and move its weight row's gradient by a whole
# term. The parameters: one per Swin stage, the patch embed and the head
TRAIN_F32_LOSS_REL, TRAIN_F32_GRAD_REL = 1e-4, 1e-2
# loss "all": the KD partner's width (the Res18 student's 512 features)
# and the rates of the soft KL and the feature KD (phase 4 and the
# drivers' phase)
TRAIN_TEACHER_DIM, TRAIN_RATES = 512, (1.0, 0.5, 0.1)
TRAIN_GRAD_PARAMS = (
    "backbone.patch_embed.weight", "backbone.stage0_block1.attn.qkv.kernel",
    "backbone.stage1_block0.mlp.Dense_0.kernel",
    "backbone.stage2_block17.attn.relative_position_bias_table",
    "backbone.stage3_block1.mlp.Dense_1.kernel",
    "transformer.encoder0.linear1.kernel", "fc_i.W")
# K8 (flash attention), the JAX package's streaming training op, which no
# model calls: checked forward (out, lse) and backward (dQ, dK/dV) against
# the plain versions at MS-TCT's head dims, whole videos, the training
# window, T = 8192 and ragged Tq != Tk; timed at (1, 8, K8_VIDEO_T, D), the
# training window and (1, 8, K7_TIME_T, D) for every D, and the ragged
# shape. Bounds against the float32 plain version rounded once: the output
# as K7's, 2 bf16 ulps of max|ref| (P rounded to bf16 before PV) and 1e-5
# of it in float32; the gradients 4 bf16 ulps (P and dS rounded to bf16
# before their products, sums over up to 8,192 terms) and 1e-5 of max|ref|
# in float32; the lse absolute, 4e-3 in bf16 (the row sum adds the
# rounded weights: a relative error of about 2^-9) and 1e-5 in float32
# (one float32 ulp at lse ~ 9). The autograd Function on the card against
# autograd of attention_reference in float32: 2e-5 of max|ref|
K8_CHECK = ([(1, 8, t, t, d) for t in (1000, 5400) for d in K7_DIMS]
            + [K7_WINDOW[:2] + (K7_WINDOW[2],) * 2 + (d,) for d in K7_DIMS]
            + [(2, 8, 1000, 777, 27), (2, 8, 777, 1000, 108),
               (1, 8, K7_TIME_T, K7_TIME_T, 108)])
K8_VIDEO_T = 2048
K8_RAGGED = (2, 8, 1000, 777, 27)
K8_BF16_ULPS, K8_BF16_GRAD_ULPS, K8_F32_REL = 2, 4, 1e-5
K8_LSE_ATOL = {torch.bfloat16: 4e-3, torch.float32: 1e-5}
K8_AUTOGRAD_REL = 2e-5
# the K8 op path: flash_attention forward and backward at the training
# window (32, 8, 256, D) and flash_attention_pallas over a whole video
# (1, 8, K8_PATH_T, D), for each D, bf16: per D one forward with lse, one
# dQ, one dK/dV, and one forward without lse
K8_PATH_T = 5400
K8_PATH_LAUNCHES = {"flash_attention_fwd": 2 * len(K7_DIMS),
                    "flash_attention_dq": len(K7_DIMS),
                    "flash_attention_dkv": len(K7_DIMS)}
# MS-TCT training at the driver's full width on 1536-d features: the
# driver's -t on a tree whose training videos hold full 256-frame windows
# (one shorter video takes the short-window path), 2 epochs, then
# --resume for one more, in float32 and bf16; -b 32 over the fold's 31
# training videos is one step per epoch; K7 runs 8 times per forward of a
# length group and 8 per validation video. Then the step on one fixed
# batch of MSTCT_STEP_B windows of 256 frames, MSTCT_STEPS steps per dtype
# (the first 2 warm up): ms per step host to host, frames/s, peak device
# memory, the loss falling; a profiled step; the checkpoint round trip.
# Card against CPU: one float32 step at batch MSTCT_CPU_B, dropout off:
# the loss within 1e-4 and the gradient norms within 1e-3 (relative;
# float32 sums over up to 8,192 x 6,912 terms in another order, and no
# ReLU in MS-TCT to flip)
MSTCT_WINDOW, MSTCT_STEP_B, MSTCT_STEPS, MSTCT_CPU_B = 256, 32, 20, 2
MSTCT_TRAIN_LENGTHS = (300, 2000)  # the training videos' spread
MSTCT_SHORT_LENGTH = 180  # one training video shorter than the window
MSTCT_TRAIN_LOSS_REL, MSTCT_TRAIN_GRAD_REL = 1e-4, 1e-3
MSTCT_GRAD_PARAMS = (
    "encoder.merge1.proj.kernel", "encoder.stage1_block0.grb.q.kernel",
    "encoder.stage2_block1.lrb.linear1.kernel",
    "encoder.stage4_block1.grb.kv.kernel", "mixer.linear9.kernel",
    "classifier.linear_pred.kernel")
# P1 (the int8 kernel probe's GEMMs) and P2 (the window-MHSA head-grouping
# probe): besides the probes' own shapes, ragged (M, K, N, blk) for P1 (M
# not a multiple of the 128-row tile; N must be one of the 64-column tile)
# and a window of 7 (N = 49) for P2, as (what, B, H = W, C, heads, groups,
# w). P2 runs every case with the probe's relative-position table (std
# 0.02, a bias too small to show in the output) and with one of std 0.5, as
# the CPU test draws it. The kernels line reads P1 at P1_TIMED and P2 at
# stage 1 (pack2, batched)
P1_RAGGED = [(100, 64, 64, 50), (300, 96, 128, 100), (200, 160, 192, 40)]
P1_REFUSED_N = 48  # the kernels take N % 64 == 0 only
P1_TIMED = "MLP1 s3 (9216x768x3072)"
P2_RAGGED = ("SwinL-224 stage 0, window 7", 2, 56, 192, 6, (2, 3, 6), 7)
P2_TABLE_STDS = (0.02, 0.5)
P2_TIMED = ("MHSA stage1 (96^2, c=192, h=6)", "pack2")
# the Swin GEMM core (swin_gemm.cuh) against the loops it replaced on the
# main path (the "_loop" wrappers): int8 bit for bit, bf16 within REL_TOL
# of the plain version with the outputs where new and old differ counted.
# Its persistent walk: each epilogue held at a product where every resident
# block takes at least GEMM_WALK_TILES tiles (those shapes, bf16 and int8:
# (what, M, K, N, epilogue)); the kernels line reads the core at P1_TIMED
GEMM_WALK_TILES = 3
GEMM_WALK = [("K3 stage 2 QKV", 16 * 24 * 24, 768, 2304, "bias"),
             ("K3 stage 2 proj", 16 * 24 * 24, 768, 768, "round_res"),
             ("K4 stage 2 fc1", 16 * 24 * 24, 768, 3072, "bias_gelu"),
             ("K4 stage 2 fc2", 16 * 24 * 24, 3072, 768, "res_f32"),
             ("K6 stage 0 fc2", 8 * 96 * 96, 768, 192, "bias"),
             ("K5 stage 0 fc2", 16 * 96 * 96, 768, 192, "round_res"),
             ("P1 MLP1 s3", 9216, 768, 3072, "scale")]


# phase_frames, the frame source and the video inference CLI: (a) one PNG
# video of FRAMES_VIDEO frames at the serving geometry (the resize the
# identity) through cli.infer offline, int8 (``--random_init --quantize``,
# the float stem: K1 41 and Q1 19 per predict), at FRAMES_SPAN = (batch,
# clip_len): two predicts, the second padded; --streaming over its first
# FRAMES_STREAM frames; (b) the host's rates on FRAMES_RATE_N frames at
# CholecT45's 854x480, written as PNG at zlib level 6 with Paeth rows, and
# cli.infer end to end over FRAMES_E2E of them (the frames cycled: two full
# spans); (c) evaluate_videos over a FRAMES_TREE[0]-frame tree of
# FRAMES_TREE[1]-pixel squares with the bf16 teacher session
FRAMES_VIDEO, FRAMES_SPAN, FRAMES_STREAM = 1100, (4, 256), 64
FRAMES_HW = OFFLINE[2:]
FRAMES_RATE_N, FRAMES_RATE_HW, FRAMES_E2E = 256, (480, 854), 2048
FRAMES_TREE = (64, TEACHER_IMG)
FRAMES_DECODE_THREADS = (1, 8)  # and every CPU the process may use
# phase 16, the frame-level training drivers on one PNG tree (fold 1: 31
# training, 5 validation, 9 test videos) of SPATIAL_FRAMES frames a video
# at 384x384, which the student reads at its default 256x448. The teacher
# (cli.spatial_transformer) at full width: Swin-L-384 Q2L, loss "all",
# bf16, fused_train and remat, batch 8, the Res18 (512-d) and Res18TCN
# stores seeded; the student (cli.spatial_cnn) at its defaults (ResNet18,
# 256x448, float32, batch 32) distilling from the teacher's dump (the
# 1536-d feature bus) and a seeded Q2LMSTCT store. Both read every frame,
# so that the teacher's dump lines up row for row with the student's
# frames. Per training step K6 44 + 44 and 176 wgmma products; per eval
# forward (one per video at 8 frames) phase 7's counts
SPATIAL_FRAMES = 8
SPATIAL_TEACHER_BATCH, SPATIAL_STUDENT_BATCH = 8, 32
SPATIAL_STUDENT_DIM = 512  # ResNet18's pooled feature
SPATIAL_QUANT_MIN_DIM = 768  # --quant_eval's default: stages 2 and 3 int8
# per --quant_eval forward: the int8 teacher's Swin plan (K5 float at
# stages 0-1, the int8 K3 + K4 at stage 2, the int8 K4 at stage 3); the
# driver's twin keeps its Dense layers float, as the JAX driver's, so no Q1
SPATIAL_Q8_LAUNCHES = {k: n for k, n in TEACHER_Q8_LAUNCHES.items()
                       if k != "qconv_bn"}
SPATIAL_TEACHER_PATH = ("the teacher's training driver "
                        "(cli.spatial_transformer -t -e -d, -e -d "
                        "--quant_eval, --resume: bf16 Swin-L-384 Q2L, loss "
                        "all)")
# the --qat eval against a forward over the quantize -> dequantize
# weights computed here: the effective weights may differ by one float32
# ulp (w + (deq - w) against deq), so the probabilities within 1e-5
SPATIAL_QAT_ATOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def in_turns(fns: dict, reps: dict) -> tuple:
    """Median ms of each of ``fns`` over two runs each, in the order
    a, b, ..., b, a after a warm-up; returns (medians, runs)."""
    for fn in fns.values():
        cuda_ms(fn, 2)
    order = list(fns) + list(fns)[::-1]
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(round(cuda_ms(fns[name], reps[name]), 4))
    return {k: float(np.median(v)) for k, v in runs.items()}, runs


def bf16_ulp(top: float) -> float:
    """One bf16 ulp at magnitude ``top``."""
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def layer_inputs(b, t, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=g)
    w_taps = torch.randn(3, c, c, generator=g) / (3 * c) ** 0.5
    b1 = 0.1 * torch.randn(c, generator=g)
    w2 = torch.randn(c, c, generator=g) / c ** 0.5
    b2 = 0.1 * torch.randn(c, generator=g)
    return [a.to(DEVICE, dtype) for a in (x, w_taps, b1, w2, b2)]


def check_probs(probs: dict, lead: tuple, what: str) -> None:
    for k, n in TASK_SIZES.items():
        p = probs[k]
        check(p.shape == lead + (n,), f"{what} {k}: shape {p.shape}")
        check(bool(np.isfinite(p).all()), f"{what} {k}: non-finite")
        check(bool(((p >= 0) & (p <= 1)).all()), f"{what} {k}: outside [0,1]")


def timed_call(fn):
    """(result, ms) of one call that ends synchronised, from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def kernel_wrappers() -> dict:
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from computervision_codes_tpu_torch.ops import dilated_conv, quant
    from computervision_codes_tpu_torch.ops import stem_pool

    from computervision_codes_tpu_torch.ops import attention, mlp_block
    from computervision_codes_tpu_torch.ops import swin_block, window_mhsa

    from computervision_codes_tpu_torch.ops import fused_norm, swin_train
    from computervision_codes_tpu_torch.ops import window_attention
    from computervision_codes_tpu_torch.scripts import int8_kernel_probe
    from computervision_codes_tpu_torch.scripts import swin_pack_probe

    return {"dilated_residual": dilated_conv.dilated_residual_cuda,
            "stem_pool": stem_pool.stem_pool_cuda,
            "qconv_bn": quant.qconv_bn_cuda,
            "window_mhsa": window_mhsa.window_mhsa_cuda,
            "mlp_block": mlp_block.mlp_block_cuda,
            "swin_block": swin_block.swin_block_cuda,
            "window_mhsa_q8": window_mhsa.window_mhsa_q8_cuda,
            "mlp_block_q8": mlp_block.mlp_block_q8_cuda,
            "swin_block_q8": swin_block.swin_block_q8_cuda,
            "attention": attention.attention_cuda,
            "fused_scale_bias_act": fused_norm.fused_scale_bias_act_cuda,
            "window_attention": window_attention.window_attention_cuda,
            "window_mhsa_branch": swin_train.window_mhsa_branch_cuda,
            "mlp_block_branch": swin_train.mlp_block_branch_cuda,
            "flash_attention_fwd": attention.flash_attention_fwd_cuda,
            "flash_attention_dq": attention.flash_attention_dq_cuda,
            "flash_attention_dkv": attention.flash_attention_dkv_cuda,
            "probe_gemm_bf16": int8_kernel_probe.gemm_bf16_cuda,
            "probe_gemm_int8w": int8_kernel_probe.gemm_int8w_cuda,
            "probe_gemm_int8": int8_kernel_probe.gemm_int8_cuda,
            "mhsa_pack": swin_pack_probe.mhsa_pack_cuda,
            "mhsa_batched": swin_pack_probe.mhsa_batched_cuda}


def gemm_counts() -> dict:
    """The Swin GEMM core's products per path, summed over the libraries
    that include it (the wrappers' counts by ops/swin_gemm.py's rule)."""
    from computervision_codes_tpu_torch.ops import swin_gemm

    return {path: sum(c[path] for c in swin_gemm.launches.values())
            for path in swin_gemm.PATHS}


def attn_counts() -> int:
    """The window-attention phase's launches, summed over the libraries
    that run it (the wrappers' counts)."""
    from computervision_codes_tpu_torch.ops import window_attention

    return sum(window_attention.phase_launches.values())


def launches() -> dict:
    """Every kernel's launches; the Swin GEMM core's are its wgmma
    products, the window-attention phase's its launches in the current
    design."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()} | {
        "swin_gemm": gemm_counts()["wgmma"],
        "window_attn": attn_counts()}


def check_gemm_counts(what: str) -> dict:
    """The C libraries' own counts per path equal the wrappers' counts by
    the rule; returns the summed counts."""
    from computervision_codes_tpu_torch.ops import swin_gemm

    for lib in swin_gemm.LIBRARIES:
        got = swin_gemm.library_launches(lib)
        check(got == swin_gemm.launches[lib],
              f"{what}: {lib}'s C library counts {got}, the rule "
              f"{swin_gemm.launches[lib]}")
    return gemm_counts()


def check_attn_counts(what: str) -> int:
    """Each C library's own attention-phase launches equal its wrappers'
    counts; returns the summed count."""
    from computervision_codes_tpu_torch.ops import window_attention

    for lib in window_attention.PHASE_LIBRARIES:
        got = window_attention.library_phase_launches(lib)
        check(got == window_attention.phase_launches[lib],
              f"{what}: {lib}'s C library counts attention phases {got}, "
              f"its wrappers {window_attention.phase_launches[lib]}")
    return attn_counts()


def q1_counts() -> dict:
    """Q1's count per path, as "qconv_bn <path>"."""
    return {f"qconv_bn {name}": n for name, n in q1_launches().items()}


def design_counts() -> dict:
    """K7's and K8's launches per kernel and design ("fwd new", "merge
    new", ..., "dkv prev"), summed over the two libraries (the wrappers'
    counts)."""
    from computervision_codes_tpu_torch.ops import attention

    keys = next(iter(attention.design_launches.values()))
    return {k: sum(c[k] for c in attention.design_launches.values())
            for k in keys}


def check_design_counts(what: str) -> dict:
    """Each attention library's own launches per kernel and design equal
    its wrappers' counts; returns the summed counts."""
    from computervision_codes_tpu_torch.ops import attention

    for lib in attention.LIBRARIES:
        got = attention.library_design_launches(lib)
        check(got == attention.design_launches[lib],
              f"{what}: {lib}'s C library counts {got}, its wrappers "
              f"{attention.design_launches[lib]}")
    return design_counts()


def path_launches() -> dict:
    """Every kernel's count, Q1's per path, the Swin GEMM core's per path
    (as "swin_gemm <path>"), K7's and K8's split merges (as "attention
    merge") and the previous designs' launches (K7's and K8's as
    "attention prev", K1's and K2's as "dilated_residual prev" and
    "stem_pool prev")."""
    from computervision_codes_tpu_torch.ops import dilated_conv, stem_pool

    d = design_counts()
    return launches() | q1_counts() | {
        "dilated_residual prev": dilated_conv.design_launches["prev"],
        "stem_pool prev": stem_pool.design_launches["prev"]} | {
        f"swin_gemm {path}": n for path, n in gemm_counts().items()} | {
        "attention merge": d["merge new"],
        "attention prev": sum(n for k, n in d.items() if k.endswith("prev"))}


def launched_since(before: dict) -> dict:
    now = launches()
    return {name: now[name] - before[name] for name in now}


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"[device] {torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; float32 checks with TF32 off "
          f"(cudnn.allow_tf32=False, matmul precision 'highest')")
    from computervision_codes_tpu_torch.data import native

    t0 = time.perf_counter()
    route = native.route()  # builds csrc/dataplane.cpp with g++
    print(f"[device] host CPUs {len(os.sched_getaffinity(0))} (the process's "
          f"affinity); data plane {PACKAGE}/csrc/dataplane.cpp built with "
          f"g++ in {time.perf_counter() - t0:.2f} s: {route}")
    return card


def phase_build() -> None:
    from computervision_codes_tpu_torch.ops import _build

    sources = list(dict.fromkeys(v for k, v in SOURCES.items()
                                 if k not in HEADERS))
    t0 = time.perf_counter()
    seconds = _build.build(sources)
    print(f"[build] {len(sources)} sources, one nvcc each, in parallel: "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name in sources:
        print(f"[build] {name}.cu -> {_build.library_path(name).name} in "
              f"{seconds[name]:.2f} s")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name} ptxas: {line.strip()}")
    for name, row in attn_registers().items():
        print(f"[build] window_attn {name}: {row}")
    for lib in ("attention", "flash_attention"):
        for name, row in attention_registers(lib).items():
            print(f"[build] {lib} {name}: {row}")


def attn_registers() -> dict:
    """ptxas' registers and spills of each instantiation of the
    window-attention phase's kernels (K3's and K10's), by library, dtype and
    16-query strips."""
    from computervision_codes_tpu_torch.ops import _build

    kernels = {"window_attn_regs_kernel": "K3 phase",
               "window_attention_kernel": "K10"}
    rows, current = {}, None
    for lib in ("window_mhsa", "window_attention"):
        for line in _build.build_logs.get(lib, "").splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                current = m.group(1)
                continue
            if current is None:
                continue
            if "spill" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                kind = next((v for k, v in kernels.items()
                             if re.search(rf"\d{k}I", current)), None)
                if kind:
                    dtype = "bf16" if "nv_bfloat16" in current else "f32"
                    nt = re.search(r"Li(\d+)E", current)
                    key = f"{kind} {dtype}" + (f" NT={nt.group(1)}"
                                               if nt else "")
                    rows[key] = f"{regs} registers; {spill}"
                current = None
    return rows


def k12_registers() -> dict:
    """ptxas' registers and spills of each instantiation of K1's and K2's
    kernels: the current design ("new") and the previous one ("prev"), by
    dtype and template argument."""
    from computervision_codes_tpu_torch.ops import _build

    kinds = {"k1_kernelILi64E": "K1 new bf16, 64-column slices",
             "k1_kernelILi128E": "K1 new bf16, 128-column slices",
             "dilated_residual_kernelI13__nv_bfloat16E": "K1 prev bf16",
             "dilated_residual_kernelIfE": "K1 float32 (both designs)",
             "stem_wgmma_kernelILi16E": "K2 new bf16, 16-byte copies",
             "stem_wgmma_kernelILi8E": "K2 new bf16, 8-byte copies",
             "stem_pool_kernelI13__nv_bfloat16E": "K2 prev bf16",
             "stem_pool_kernelIfE": "K2 float32 (both designs)"}
    rows, current, spill = {}, None, ""
    for lib in ("dilated_residual", "stem_pool"):
        for line in _build.build_logs.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1)
                continue
            if current is None:
                continue
            if "spill" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                kind = next((v for k, v in kinds.items() if k in current),
                            None)
                if kind:
                    rows[kind] = f"{regs} registers; {spill}"
                current = None
    return rows


def k1_work(b, t, c) -> dict:
    """K1's bound at (b, t, c) in bf16: 8 b t c^2 FLOP, its bytes x and y
    and the weights once."""
    return bound(8 * b * t * c * c,
                 2 * (2 * b * t * c + 4 * c * c + 2 * c), "bf16")


def check_design_pairs(what: str) -> None:
    """K1's and K2's C libraries count the launches per design that their
    wrappers count (each library only where this process loaded it)."""
    from computervision_codes_tpu_torch.ops import _build, dilated_conv
    from computervision_codes_tpu_torch.ops import stem_pool

    for name, mod in (("dilated_residual", dilated_conv),
                      ("stem_pool", stem_pool)):
        if _build.loaded(name) is None:
            check(all(n == 0 for n in mod.design_launches.values()),
                  f"{what}: {name} counts {mod.design_launches} unloaded")
            continue
        got = mod.library_design_launches()
        check(got == mod.design_launches,
              f"{what}: {name}'s C library counts {got}, its wrappers "
              f"{mod.design_launches}")


def phase_k1(card: str) -> dict:
    """K1 in both designs against the plain version: every (dilation,
    causal) pair of the main path and ragged shapes (the current design in
    bf16 and float32, the previous at the main shapes), C = 128 and 1024;
    then the times in turns (new, previous, plain) at the offline and
    streaming shapes in bf16, with device times, TFLOP/s and the share of
    the bound, and the instantiations' registers and spills."""
    from computervision_codes_tpu_torch.ops import _build
    from computervision_codes_tpu_torch.ops.dilated_conv import (
        dilated_residual_cuda, dilated_residual_plan,
        dilated_residual_prev_cuda, dilated_residual_reference)

    b0, t0, c = LAYER
    cases = [(b0, t0, c, 2 ** i, causal) for causal in (False, True)
             for i in range(11)]
    # ragged: T not a multiple of the 64-row tile, T = 1, B = 3, d >= T
    cases += [(b, t, c, d, causal) for causal in (False, True)
              for b, t, d in ((3, 37, 1), (3, 37, 16), (3, 37, 64),
                              (1, 1, 1), (1, 1, 1024), (2, 300, 128))]
    cases += K1_WIDTHS
    worst_main = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst = (0.0, None)
        prev_checked = 0
        for n, (b, t, cc, d, causal) in enumerate(cases):
            args = layer_inputs(b, t, cc, dtype, seed=n)
            want = dilated_residual_reference(*args, d, causal)
            tol = REL_TOL[dtype] * max(1.0, want.float().abs().max().item())
            designs = [("new", dilated_residual_cuda)]
            if (b, t, cc) == (b0, t0, c):
                designs.append(("prev", dilated_residual_prev_cuda))
                prev_checked += 1
            for name, fn in designs:
                got = fn(*args, d, causal)
                check(bool(torch.isfinite(got).all()),
                      f"K1 {name} non-finite output {dtype} "
                      f"{(b, t, cc, d, causal)}")
                err = (got.float() - want.float()).abs().max().item()
                check(err <= tol, f"K1 {name} {dtype} {(b, t, cc, d, causal)}"
                                  f": max_abs_err {err} > tol {tol}")
                if name == "new" and err / tol >= worst[0]:
                    worst = (err / tol, (b, t, cc, d, causal, err, tol))
                if name == "new" and dtype == torch.bfloat16 and \
                        (b, t, cc) == (b0, t0, c):
                    worst_main = max(worst_main, err)
        print(f"[kernels] K1 {str(dtype)[6:]}: {len(cases)} cases within "
              f"tolerance ({REL_TOL[dtype]:g} x max|ref|), the previous "
              f"design too at the {prev_checked} main-shape cases; worst "
              f"(b, t, c, d, causal, err, tol) = {worst[1]}")
    lib = _build.load_library("dilated_residual")
    for b, t, cc in K1_PLANS:
        out = (ctypes.c_int * 4)()
        check(lib.dilated_residual_plan(b, t, cc, out) == 0,
              f"K1 plan query failed at {(b, t, cc)}")
        plan = dilated_residual_plan(b, t, cc, torch.bfloat16,
                                     out[3] or None)
        check(list(out)[:3] == [plan["slice"], plan["cluster"],
                                plan["stages"]],
              f"K1 {(b, t, cc)}: C plan {list(out)[:3]} != Python {plan}")
        print(f"[kernels] K1 plan (B, T, C) = {(b, t, cc)}: slices of "
              f"{out[0]} columns, clusters of {out[1]} CTAs, {out[2]} "
              f"stages, grid {plan['grid']}; the card holds {out[3]} "
              f"clusters of 64-column CTAs at once")
    for kind, row in k12_registers().items():
        if kind.startswith("K1"):
            print(f"[kernels] {kind}: {row}")

    times = {}
    for b, d, causal in K1_TIMED:
        args = layer_inputs(b, t0, c, torch.bfloat16, seed=99)
        ms, runs = in_turns(
            {"new": lambda: dilated_residual_cuda(*args, d, causal),
             "prev": lambda: dilated_residual_prev_cuda(*args, d, causal),
             "plain": lambda: dilated_residual_reference(*args, d, causal)},
            {"new": 50, "prev": 50, "plain": 50})
        dev = {name: device_ms(lambda: fn(*args, d, causal), 20)
               for name, fn in (("new", dilated_residual_cuda),
                                ("prev", dilated_residual_prev_cuda))}
        work = k1_work(b, t0, c)
        times[b, d, causal] = ms | {f"{k}_device": v for k, v in dev.items()}
        flop = 8 * b * t0 * c * c
        print(f"[kernels] K1 time bf16 (B, T, C) = ({b}, {t0}, {c}) d={d} "
              f"causal={causal}: new {ms['new']:.4f} ms (device "
              f"{dev['new']:.4f}: {flop / dev['new'] / 1e9:.1f} TFLOP/s, "
              f"{work['bound_ms'] / dev['new']:.1%} of the bound "
              f"{work['bound_ms']:.4f} ms), previous {ms['prev']:.4f} "
              f"(device {dev['prev']:.4f}), plain {ms['plain']:.4f}; runs "
              f"{runs}; {card}")
    main = times[b0, 16, False]
    return {"max_abs_err": worst_main, "ms": main["new"],
            "plain_ms": main["plain"], **k1_work(b0, t0, c),
            "library_ms": None, "prev_ms": main["prev"],
            "device_ms": main["new_device"],
            "prev_device_ms": main["prev_device"],
            "by_shape": {f"B={b} d={d} causal={causal}": v
                         for (b, d, causal), v in times.items()},
            "registers": {k: v for k, v in k12_registers().items()
                          if k.startswith("K1")}}


def stem_inputs(n, h, w, dtype, seed):
    """Frames (N, H, W, 3), a BN-folded-like stem kernel and bias, made on
    the card from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(n, h, w, 3, generator=g, device=DEVICE).to(dtype)
    wt = (0.1 * torch.randn(7, 7, 3, 64, generator=g, device=DEVICE)
          ).to(dtype)
    bias = 0.5 * torch.randn(64, generator=g, device=DEVICE)
    return x, wt, bias


def k2_work(n, h, w) -> dict:
    """K2's bound at n frames of h x w in bf16: the 147-tap convolution's
    FLOP, its input, output and weight bytes."""
    return bound(2 * n * (h // 2) * (w // 2) * 64 * 147,
                 2 * (n * h * w * 3 + n * (h // 4) * (w // 4) * 64
                      + 147 * 64) + 4 * 64, "bf16")


def phase_k2(card: str) -> dict:
    """K2 in both designs against the plain version at every STEM_CASES
    shape and one frame (the push), bf16 and float32; then the times in
    turns (new, previous, plain) in bf16 at STEM_TIME_N frames, with device
    times, TFLOP/s and the share of the bound, and the instantiations'
    registers and spills."""
    from computervision_codes_tpu_torch.ops.stem_pool import (
        stem_pool_cuda, stem_pool_plan, stem_pool_prev_cuda,
        stem_pool_reference)

    main_err = 0.0
    cases = STEM_CASES + [(1,) + OFFLINE[2:]]
    for dtype in (torch.bfloat16, torch.float32):
        worst = (-1.0, None)
        for seed, (n, h, w) in enumerate(cases):
            args = stem_inputs(n, h, w, dtype, seed)
            want = stem_pool_reference(*args)
            top = want.float().abs().max().item()
            tol = STEM_F32_ATOL if dtype == torch.float32 else bf16_ulp(top)
            for name, fn in (("new", stem_pool_cuda),
                             ("prev", stem_pool_prev_cuda)):
                got = fn(*args)
                check(got.shape == want.shape == (n, h // 4, w // 4, 64),
                      f"K2 {name} {dtype} {(n, h, w)}: shape "
                      f"{tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()),
                      f"K2 {name} {dtype} {(n, h, w)}: non-finite")
                err = (got.float() - want.float()).abs().max().item()
                check(err <= tol, f"K2 {name} {dtype} {(n, h, w)}: "
                                  f"max_abs_err {err} > tol {tol} "
                                  f"(max|ref| {top})")
                if name == "new" and err / tol >= worst[0]:
                    worst = (err / tol, ((n, h, w), err, tol))
                if name == "new" and dtype == torch.bfloat16 and \
                        (n, h, w) == (1024,) + OFFLINE[2:]:
                    main_err = err
                del got
            del args, want
        print(f"[kernels] K2 {str(dtype)[6:]}: {len(cases)} shapes within "
              f"tolerance ("
              f"{'2e-5 absolute' if dtype == torch.float32 else '1 ulp of max|ref|'}"
              f"), both designs; worst of the current ((N, H, W), err, tol) "
              f"= {worst[1]}")
    for kind, row in k12_registers().items():
        if kind.startswith("K2"):
            print(f"[kernels] {kind}: {row}")
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    times = {}
    h, w = OFFLINE[2:]
    for n in STEM_TIME_N:
        args = stem_inputs(n, h, w, torch.bfloat16, seed=99)
        reps = 20 if n < 1024 else 5
        ms, runs = in_turns({"new": lambda: stem_pool_cuda(*args),
                             "prev": lambda: stem_pool_prev_cuda(*args),
                             "plain": lambda: stem_pool_reference(*args)},
                            {"new": reps, "prev": reps, "plain": reps})
        dev = {name: device_ms(lambda: fn(*args), reps)
               for name, fn in (("new", stem_pool_cuda),
                                ("prev", stem_pool_prev_cuda))}
        work = k2_work(n, h, w)
        times[n] = ms | {f"{k}_device": v for k, v in dev.items()}
        flop = 2 * n * (h // 2) * (w // 2) * 64 * 147
        print(f"[kernels] K2 time bf16 N={n} {h}x{w} (plan "
              f"{stem_pool_plan(n, h, w, sms)}): new {ms['new']:.4f} ms "
              f"(device {dev['new']:.4f}: {flop / dev['new'] / 1e9:.1f} "
              f"TFLOP/s of conv, {work['bound_ms'] / dev['new']:.1%} of the "
              f"bound {work['bound_ms']:.4f} ms, {work['bound_by']}), "
              f"previous {ms['prev']:.4f} (device {dev['prev']:.4f}), plain "
              f"{ms['plain']:.4f}; runs {runs}; {card}")
        del args
    args = stem_inputs(STEM_TIME_N[-1], h, w, torch.float32, seed=99)
    f32, runs = in_turns({"new": lambda: stem_pool_cuda(*args),
                          "plain": lambda: stem_pool_reference(*args)},
                         {"new": 5, "plain": 5})
    print(f"[kernels] K2 time float32 N={STEM_TIME_N[-1]} {h}x{w} (the FMA "
          f"kernel, both designs): {f32['new']:.4f} ms, plain "
          f"{f32['plain']:.4f}; runs {runs}; {card}")
    del args
    n = STEM_TIME_N[-1]
    return {"max_abs_err": main_err, "ms": times[n]["new"],
            "plain_ms": times[n]["plain"], **k2_work(n, h, w),
            "library_ms": None, "prev_ms": times[n]["prev"],
            "device_ms": times[n]["new_device"],
            "prev_device_ms": times[n]["prev_device"],
            "by_frames": {str(k): v for k, v in times.items()},
            "float32_ms": f32["new"],
            "registers": {k: v for k, v in k12_registers().items()
                          if k.startswith("K2")}}


def resnet18_convs(h: int, w: int) -> list:
    """ResNet18's int8 convolutions in call order at an (h, w) frame:
    (what, Cin, Cout, k, stride, pad, H_in, W_in)."""
    h, w, cin, out = h // 4, w // 4, 64, []
    for si in range(4):
        cout = 64 * 2 ** si
        for bi in range(2):
            s = 2 if si > 0 and bi == 0 else 1
            name = f"layer{si + 1}_{bi}"
            ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
            out.append((f"{name}.conv1", cin, cout, 3, s, 1, h, w))
            out.append((f"{name}.conv2", cout, cout, 3, 1, 1, ho, wo))
            if s != 1 or cin != cout:
                out.append((f"{name}.downsample", cin, cout, 1, s, 0, h, w))
            h, w, cin = ho, wo, cout
    return out


def qconv_inputs(n, cin, cout, k, h, w, dtype, seed):
    """Activations (N, H, W, Cin), int8 weights (Cout, k, k, Cin) and a
    realistic per-channel ``mult`` (weight scale x BN) and bias."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g, device=DEVICE).to(dtype)
    w_q = torch.randint(-127, 128, (cout, k, k, cin), generator=g,
                        device=DEVICE, dtype=torch.int8)
    mult = 1e-4 + 1e-3 * torch.rand(cout, generator=g, device=DEVICE)
    bias = torch.randn(cout, generator=g, device=DEVICE)
    return x, w_q, mult, bias


def q1_path_wrappers() -> dict:
    """Q1's paths -> the wrapper whose ``launches`` counts that kernel:
    the quantize pass and the wgmma GEMM with each producer (the new path)
    and the loop."""
    from computervision_codes_tpu_torch.ops import quant

    return {"quantize": quant.quantize_codes_cuda,
            "gemm": quant.qconv_gemm_cuda, "conv": quant.qconv_conv_cuda,
            "loop": quant.qconv_loop_cuda}


def q1_launches() -> dict:
    return {name: fn.launches for name, fn in q1_path_wrappers().items()}


def q1_want(calls: int, path: str) -> dict:
    """Q1's path launches of ``calls`` calls that all take ``path``."""
    want = dict.fromkeys(q1_path_wrappers(), 0)
    want[path] += calls
    if path != "loop":
        want["quantize"] += calls
    return want


def check_q1_paths(before: dict, calls: int, path: str, what: str) -> None:
    now = q1_launches()
    count = {name: now[name] - before[name] for name in now}
    want = q1_want(calls, path)
    check(count == want, f"{what}: Q1 path launches {count}, want {want}")


def reset_launches() -> None:
    """Every kernel's count, Q1's per path, the Swin GEMM core's per path,
    the window-attention phase's and K7's and K8's per design (the
    wrappers' and the C libraries'), to 0."""
    from computervision_codes_tpu_torch.ops import attention, dilated_conv
    from computervision_codes_tpu_torch.ops import stem_pool, swin_gemm
    from computervision_codes_tpu_torch.ops import window_attention

    for fn in (*kernel_wrappers().values(), *q1_path_wrappers().values(),
               dilated_conv.dilated_residual_prev_cuda,
               stem_pool.stem_pool_prev_cuda):
        fn.launches = 0
    swin_gemm.reset_launches()
    window_attention.reset_phase_launches()
    attention.reset_design_launches()
    dilated_conv.reset_design_launches()
    stem_pool.reset_design_launches()


def q1_walk_frames(ho: int, wo: int, cout: int) -> int:
    """Frames at which each resident block of Q1's wgmma kernel walks at
    least ``Q1_WALK_TILES`` output tiles, whichever tile it picks: tiles are
    counted at its largest, 256 x 128, and blocks at its most, two an SM."""
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    n_tiles = -(-cout // 128)
    rows = -(-Q1_WALK_TILES * 2 * sms // n_tiles) * 256
    return -(-rows // (ho * wo))


def phase_q1(card: str) -> dict:
    """Q1 as ResNet18's convolutions: both paths (the wgmma path where
    ``qconv_path`` sends a shape, and the loop at every shape) bit for bit
    against the plain version, then their times in turns."""
    from computervision_codes_tpu_torch.ops.quant import (
        activation_scale, conv_i8, qconv_bn_cuda, qconv_bn_reference,
        qconv_loop_cuda, qconv_path, quantize_codes_cuda,
        quantize_with_scale)

    h, w = OFFLINE[2:]
    cases = resnet18_convs(h, w)
    check(len(cases) == INT8_CONVS, f"{len(cases)} ResNet18 int8 convs")
    cases = cases + Q1_EXTRA
    paths = {"new": qconv_bn_cuda, "loop": qconv_loop_cuda}
    for dtype in (torch.bfloat16, torch.float32):
        for seed, (what, cin, cout, k, s, p, hi, wi) in enumerate(cases):
            tag = f"Q1 {str(dtype)[6:]} {what} {cin}->{cout} {k}x{k}/{s}"
            x, w_q, mult, bias = qconv_inputs(Q1_CHECK_N, cin, cout, k, hi,
                                              wi, dtype, seed)
            s_act = activation_scale(x).reshape(1)
            pad = ((p, p), (p, p))
            path = qconv_path(cin, k, k, s, pad)
            check(path == ("loop" if cin % 16 else "conv"),
                  f"{tag}: takes the {path} path")
            want_codes = quantize_with_scale(x, s_act)
            check(torch.equal(quantize_codes_cuda(x, s_act), want_codes),
                  f"{tag}: the quantize pass's codes differ")
            ones = torch.ones(cin, device=DEVICE)
            # codes: a 1x1 identity convolution at unit mult gives
            # code * s_act, so equal outputs mean equal codes
            eye = torch.eye(cin, device=DEVICE).to(torch.int8)[:, None, None]
            # int32 sums: integer-valued input at unit scales gives the sum
            # itself in float32, exact below 2**24
            codes = torch.randint(-127, 128, x.shape, device=DEVICE).to(dtype)
            one = torch.ones(1, device=DEVICE)
            acc = conv_i8(codes.to(torch.int8), w_q, s, pad)
            check(acc.abs().max().item() < 2 ** 24, f"{tag}: sums too large")
            # outputs: bit for bit, the epilogue with and without ReLU
            relu = seed % 2 == 0
            want = qconv_bn_reference(x, s_act, w_q, mult, bias, s, pad,
                                      relu=relu, dtype=dtype)
            for name, fn in paths.items():
                got = fn(x, s_act, eye, ones, 0 * ones, 1, "VALID",
                         dtype=torch.float32)
                check(torch.equal(got, want_codes.float() * s_act),
                      f"{tag} {name}: int8 codes differ")
                got = fn(codes, one, w_q, torch.ones(cout, device=DEVICE),
                         torch.zeros(cout, device=DEVICE), s, pad,
                         dtype=torch.float32)
                check(torch.equal(got, acc.float()),
                      f"{tag} {name}: int32 sums differ")
                before = q1_launches()
                got = fn(x, s_act, w_q, mult, bias, s, pad, relu=relu,
                         dtype=dtype)
                check_q1_paths(before, 1, path if name == "new" else "loop",
                               f"{tag} {name}")
                check(got.shape == want.shape,
                      f"{tag} {name}: shape {tuple(got.shape)}")
                check(torch.equal(got, want),
                      f"{tag} {name}: output differs by "
                      f"{(got.float() - want.float()).abs().max().item()}")
        print(f"[kernels] Q1 {str(dtype)[6:]} in and out: {len(cases)} "
              f"shapes (ResNet18's {INT8_CONVS} at {h}x{w}, N={Q1_CHECK_N}, "
              f"and {len(Q1_EXTRA)} more), the new path (quantize pass + "
              f"wgmma, cp.async producer) where Cin % 16 == 0 and the loop "
              f"at every shape: the quantize pass's codes, codes, int32 sums "
              f"and outputs equal bit for bit")

    # the persistent walk: at N = 2 no block takes a second tile, so each
    # wgmma case again at frames where every block walks several tiles
    # (the ring's stage and phase, and each tile's rows and taps, carried
    # from one tile to the next), bit for bit against the plain version
    walked = []
    for seed, (what, cin, cout, k, s, p, hi, wi) in enumerate(cases):
        pad = ((p, p), (p, p))
        if qconv_path(cin, k, k, s, pad) == "loop":
            continue
        ho, wo = (hi + 2 * p - k) // s + 1, (wi + 2 * p - k) // s + 1
        n = q1_walk_frames(ho, wo, cout)
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"Q1 walk {str(dtype)[6:]} {what} {cin}->{cout} N={n}"
            x, w_q, mult, bias = qconv_inputs(n, cin, cout, k, hi, wi, dtype,
                                              seed)
            s_act = activation_scale(x).reshape(1)
            relu = seed % 2 == 0
            want = qconv_bn_reference(x, s_act, w_q, mult, bias, s, pad,
                                      relu=relu, dtype=dtype)
            before = q1_launches()
            got = qconv_bn_cuda(x, s_act, w_q, mult, bias, s, pad, relu=relu,
                                dtype=dtype)
            check_q1_paths(before, 1, "conv", tag)
            check(torch.equal(got, want),
                  f"{tag}: output differs by "
                  f"{(got.float() - want.float()).abs().max().item()} at "
                  f"{int((got != want).sum())} of {got.numel()}")
            del x, got, want
        walked.append(n)
    print(f"[kernels] Q1 the wgmma path's persistent walk: {len(walked)} "
          f"shapes at N={walked} frames (each resident block at least "
          f"{Q1_WALK_TILES} tiles), bf16 and float32: outputs equal bit for "
          f"bit")

    # times at N = 64 frames, bf16 in and out, static scale, each distinct
    # shape once, in turns: new, loop, plain and (a yardstick of another
    # function) the bf16 cuDNN convolution; the forward's total weights
    # each by its count. Device times (torch.profiler) of the new path's
    # two kernels and the loop's beside them
    shapes = {}
    for what, cin, cout, k, s, p, hi, wi in cases[:INT8_CONVS] + Q1_EXTRA[:1]:
        key = (cin, cout, k, s, p, hi, wi)
        shapes.setdefault(key, [what, 0])[1] += 1
    total = {"new": 0.0, "loop": 0.0, "plain": 0.0, "cudnn_bf16": 0.0,
             "new_device": 0.0, "loop_device": 0.0}
    work = {"ops": 0, "bytes": 0}  # of the 19 convs, for the bound
    for (cin, cout, k, s, p, hi, wi), (what, count) in shapes.items():
        x, w_q, mult, bias = qconv_inputs(Q1_TIME_N, cin, cout, k, hi, wi,
                                          torch.bfloat16, seed=99)
        s_act = activation_scale(x).reshape(1)
        pad = ((p, p), (p, p))
        xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        wc = w_q.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        fns = {"cudnn_bf16": lambda: F.conv2d(xc, wc, None, s, p),
               "plain": lambda: qconv_bn_reference(x, s_act, w_q, mult, bias,
                                                   s, pad, relu=True),
               "new": lambda: qconv_bn_cuda(x, s_act, w_q, mult, bias, s,
                                            pad, relu=True),
               "loop": lambda: qconv_loop_cuda(x, s_act, w_q, mult, bias, s,
                                               pad, relu=True)}
        if "stem" in what:  # Cin = 3: the loop's shape only
            del fns["new"]
        # the main path's size, bit for bit
        want = fns["plain"]()
        for name in ("new", "loop"):
            if name in fns:
                got = fns[name]()
                check(torch.equal(got, want),
                      f"Q1 N={Q1_TIME_N} {what} {name}: output differs by "
                      f"{(got.float() - want.float()).abs().max().item()}")
        del got, want
        ms, runs = in_turns(fns, {"cudnn_bf16": 20, "plain": 3, "new": 20,
                                  "loop": 20})
        dev = {name: device_ms(fns[name], 10)
               for name in ("new", "loop") if name in fns}
        ho, wo = (hi + 2 * p - k) // s + 1, (wi + 2 * p - k) // s + 1
        macs = Q1_TIME_N * ho * wo * cout * k * k * cin
        if "stem" not in what:
            for name in ("new", "loop", "plain", "cudnn_bf16"):
                total[name] += count * ms[name]
            for name in ("new", "loop"):
                total[f"{name}_device"] += count * dev[name]
            # bf16 in, int8 weights, bf16 out, float32 mult and bias
            work["ops"] += count * 2 * macs
            work["bytes"] += count * (2 * Q1_TIME_N * hi * wi * cin
                                      + cout * k * k * cin
                                      + 2 * Q1_TIME_N * ho * wo * cout
                                      + 8 * cout)
        shown = (f"new {ms['new']:.4f} ms ({2 * macs / ms['new'] / 1e9:.1f} "
                 f"TOP/s; device {dev['new']:.4f}), " if "new" in ms else "")
        print(f"[kernels] Q1 time N={Q1_TIME_N} {what} {cin}->{cout} "
              f"{k}x{k}/{s} at {hi}x{wi} (x{count} per forward; outputs "
              f"equal to plain bit for bit): {shown}"
              f"loop {ms['loop']:.4f} ms "
              f"({2 * macs / ms['loop'] / 1e9:.1f} TOP/s; device "
              f"{dev['loop']:.4f}), plain {ms['plain']:.4f} ms, bf16 cuDNN "
              f"convolution alone (labelled cudnn_bf16) "
              f"{ms['cudnn_bf16']:.4f} ms; runs {runs}; {card}")
        del x, xc, wc
    b = bound(work["ops"], work["bytes"], "int8")
    rate = {name: work["ops"] / total[name] / 1e9
            for name in ("new", "loop", "new_device")}
    print(f"[kernels] Q1 per ResNet18 forward of {Q1_TIME_N} frames "
          f"({INT8_CONVS} convs), in turns: new {total['new']:.4f} ms "
          f"({rate['new']:.1f} TOP/s, {b['bound_ms'] / total['new']:.1%} of "
          f"the {b['bound_ms']:.4f} ms bound, by {b['bound_by']}; device "
          f"{total['new_device']:.4f} ms, {rate['new_device']:.1f} TOP/s), "
          f"loop {total['loop']:.4f} ms ({rate['loop']:.1f} TOP/s, "
          f"{b['bound_ms'] / total['loop']:.1%}; device "
          f"{total['loop_device']:.4f}), plain {total['plain']:.4f} ms, bf16 "
          f"cuDNN {total['cudnn_bf16']:.4f} ms; {card}")
    return {"max_abs_err": 0.0, "ms": round(total["new"], 4),
            "plain_ms": round(total["plain"], 4), **b, "library_ms": None,
            "device_ms": round(total["new_device"], 4),
            "loop_ms": round(total["loop"], 4),
            "loop_device_ms": round(total["loop_device"], 4),
            "cudnn_bf16_ms": round(total["cudnn_bf16"], 4)}


def swin_inputs(lead, c, hidden, heads, w, dtype, seed):
    """Activations of shape ``lead + (C,)``, the attention half's operands
    (float32 LayerNorm parameters, the rest in ``dtype``, as the Swin
    modules pass them) and the MLP half's, made on the card from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def f(*shape, scale=1.0, keep=False):
        t = scale * torch.randn(*shape, generator=g, device=DEVICE)
        return t if keep else t.to(dtype)

    n = w * w
    x = f(*lead, c)
    attn = [1 + f(c, scale=0.1, keep=True), f(c, scale=0.1, keep=True),
            f(c, 3 * c, scale=c ** -0.5), f(3 * c, scale=0.1),
            f(c, c, scale=c ** -0.5), f(c, scale=0.1), f(heads, n, n)]
    mlp = [1 + f(c, scale=0.1, keep=True), f(c, scale=0.1, keep=True),
           f(c, hidden, scale=c ** -0.5), f(hidden, scale=0.1),
           f(hidden, c, scale=hidden ** -0.5), f(c, scale=0.1)]
    return x, attn, mlp


def compare(tag: str, got, want, dtype) -> tuple:
    """Checks ``got`` against the plain version's ``want``: same shape,
    finite, within REL_TOL of the largest magnitude. Returns (err, tol)."""
    check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    tol = REL_TOL[dtype] * max(1.0, want.float().abs().max().item())
    check(err <= tol, f"{tag}: max_abs_err {err} > tol {tol}")
    return err, tol


def new_vs_old(new, old) -> tuple:
    """(outputs in which a design's and its parent's results differ (the
    Swin GEMM core's and the loop's, K7's and K8's current and previous),
    the largest difference)."""
    d = (new.float() - old.float()).abs()
    return int((d > 0).sum()), d.max().item()


def gemm_tiles_per_block(m: int, n: int) -> float:
    """Output tiles each resident block of the wgmma GEMM walks at (M, N):
    128 x tile_n(N) tiles over the SMs, two blocks an SM at the 64-column
    tile (its ring fits twice), one otherwise."""
    from computervision_codes_tpu_torch.ops.swin_gemm import tile_n

    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    blocks = sms * (2 if tile_n(n) == 64 else 1)
    return -(-m // 128) * (n // tile_n(n)) / blocks


def attn_work(b, hp, wp, c, heads, w, shifted: bool, es: int) -> tuple:
    """(operations, bytes) of one attention half-block: QKV, scores, P V
    and proj products; x in, y out, weights, biases, rel-pos bias and the
    shift mask each once (``es`` bytes per element, LN vectors float32)."""
    m, n = b * hp * wp, w * w
    ops = 2 * m * c * 3 * c + 2 * m * c * c + 4 * m * n * c
    nbytes = es * (2 * m * c + 4 * c * c + 4 * c + heads * n * n
                   + shifted * (hp // w) * (wp // w) * n * n) + 8 * c
    return ops, nbytes


def mlp_work(m, c, hidden, es: int) -> tuple:
    return (4 * m * c * hidden,
            es * (2 * m * c + 2 * c * hidden + hidden + c) + 8 * c)


def swin_mask(hp, wp, w, shift):
    from computervision_codes_tpu_torch.models.swin import shift_mask

    return shift_mask(hp, wp, w, shift, DEVICE, torch.float32) if shift \
        else None


def geometry(hw) -> tuple:
    return hw if isinstance(hw, tuple) else (hw, hw)


def phase_k3(card: str) -> dict:
    """K3 (its products on the Swin GEMM core) against the plain version;
    in bf16 also against the loop (``window_mhsa_loop_cuda``: the outputs
    that differ counted), then kernel, loop and plain in turns."""
    from computervision_codes_tpu_torch.ops.window_mhsa import (
        window_mhsa_cuda, window_mhsa_loop_cuda, window_mhsa_reference)

    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst, differ = (-1.0, None), {}
        for seed, (what, b, hw, c, heads, w) in enumerate(K3_CASES):
            hp, wp = geometry(hw)
            x, attn, _ = swin_inputs((b, hp, wp), c, 4 * c, heads, w, dtype,
                                     seed)
            for shift in (0, w // 2):
                kw = dict(window=w, num_heads=heads)
                mask = swin_mask(hp, wp, w, shift)
                got = window_mhsa_cuda(x, *attn, mask, **kw)
                err, tol = compare(
                    f"K3 {str(dtype)[6:]} {what} shift={shift}", got,
                    window_mhsa_reference(x, *attn, mask, **kw), dtype)
                if err / tol >= worst[0]:
                    worst = (err / tol, (what, shift, err, tol))
                if dtype == torch.bfloat16:
                    differ[f"{what} shift={shift}"] = new_vs_old(
                        got, window_mhsa_loop_cuda(x, *attn, mask, **kw))
                    if seed == 0:
                        main_err = max(main_err, err)
            del x, attn
        print(f"[kernels] K3 {str(dtype)[6:]}: {2 * len(K3_CASES)} cases "
              f"within tolerance ({REL_TOL[dtype]:g} x max|ref|); worst "
              f"(case, shift, err, tol) = {worst[1]}"
              + (f"; against the loop (outputs that differ, largest "
                 f"difference) {differ}" if differ else ""))
    what, b, hw, c, heads, w = K3_CASES[0]
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, attn, _ = swin_inputs((b, hw, hw), c, 4 * c, heads, w, dtype, 99)
        for shift in (0, w // 2):
            mask, kw = swin_mask(hw, hw, w, shift), dict(window=w,
                                                         num_heads=heads)
            fns = {"plain": lambda: window_mhsa_reference(x, *attn, mask,
                                                          **kw),
                   "kernel": lambda: window_mhsa_cuda(x, *attn, mask, **kw),
                   "loop": lambda: window_mhsa_loop_cuda(x, *attn, mask,
                                                         **kw)}
            if dtype == torch.float32:  # both are the FMA loop
                del fns["loop"]
            ms, runs = in_turns(fns, {"plain": 10, "kernel": 20, "loop": 20})
            times[dtype, shift] = ms
            ops, _ = attn_work(b, hw, hw, c, heads, w, bool(shift), 2)
            shown = (f", loop {ms['loop']:.4f} ms" if "loop" in ms else "")
            print(f"[kernels] K3 time {str(dtype)[6:]} {what} B={b} {hw}x{hw}"
                  f" C={c} heads={heads} w={w} shift={shift}: kernel "
                  f"{ms['kernel']:.4f} ms ({ops / ms['kernel'] / 1e9:.1f} "
                  f"TFLOP/s){shown}, plain {ms['plain']:.4f} ms; runs "
                  f"{runs}; {card}")
        del x, attn
    ms = times[torch.bfloat16, w // 2]
    return {"max_abs_err": main_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"],
            **bound(*attn_work(b, hw, hw, c, heads, w, True, 2), "bf16"),
            "library_ms": None, "loop_ms": ms["loop"]}


def phase_swin_widths(card: str) -> dict:
    """K3, K4, K5 and K6's two branches at the widths off 64
    (``SWIN_WIDTH_CASES``: Swin-T-224's stages 0 and 1, the nano's stage
    0), each checked against its plain version by the K3-K6 phases; here
    each launch's products per path (wgmma in bf16, the FMA loop in float32,
    none on the loop; the C libraries' counts equal the wrappers'), then
    kernel and plain version in turns, shifted, beside the bound. Returns
    {kernel: {case dtype: {ms, plain_ms, bound_ms, bound_by}}}."""
    from computervision_codes_tpu_torch.ops import swin_gemm
    from computervision_codes_tpu_torch.ops.mlp_block import (
        mlp_block_cuda, mlp_block_reference)
    from computervision_codes_tpu_torch.ops.swin_block import (
        swin_block_cuda, swin_block_reference)
    from computervision_codes_tpu_torch.ops.swin_train import (
        mlp_block_branch_cuda, window_mhsa_branch_cuda)
    from computervision_codes_tpu_torch.ops.window_mhsa import (
        window_mhsa_cuda, window_mhsa_reference)

    rows = {k: {} for k in ("window_mhsa", "mlp_block", "swin_block",
                            "window_mhsa_branch", "mlp_block_branch")}
    for what, b, hw, c, heads, w in SWIN_WIDTH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name, es = str(dtype)[6:], dtype.itemsize
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            x, attn, mlp = swin_inputs((b, hw, hw), c, 4 * c, heads, w,
                                       dtype, 77)
            mask, kw = swin_mask(hw, hw, w, w // 2), dict(window=w,
                                                          num_heads=heads)
            xm = x.reshape(-1, c)
            a_work = attn_work(b, hw, hw, c, heads, w, True, es)
            m_work = mlp_work(b * hw * hw, c, 4 * c, es)
            cases = {
                "window_mhsa": (
                    lambda: window_mhsa_cuda(x, *attn, mask, **kw),
                    lambda: window_mhsa_reference(x, *attn, mask, **kw),
                    a_work),
                "mlp_block": (lambda: mlp_block_cuda(xm, *mlp),
                              lambda: mlp_block_reference(xm, *mlp), m_work),
                "swin_block": (
                    lambda: swin_block_cuda(x, *attn, mask, *mlp, **kw),
                    lambda: swin_block_reference(x, *attn, mask, *mlp, **kw),
                    (a_work[0] + m_work[0],
                     a_work[1] + m_work[1] - 2 * es * b * hw * hw * c)),
                "window_mhsa_branch": (
                    lambda: window_mhsa_branch_cuda(x, *attn, mask, **kw),
                    lambda: window_mhsa_reference(x, *attn, mask, **kw,
                                                  res_add=False), a_work),
                "mlp_block_branch": (
                    lambda: mlp_block_branch_cuda(xm, *mlp),
                    lambda: mlp_block_reference(xm, *mlp, res_add=False),
                    m_work)}
            path = "wgmma" if dtype == torch.bfloat16 else "fma"
            for kernel, (fn, ref, (ops, nbytes)) in cases.items():
                swin_gemm.reset_launches()
                fn()
                torch.cuda.synchronize()
                got = check_gemm_counts(f"{kernel} {name} {what}")
                want = dict.fromkeys(swin_gemm.PATHS, 0) | {
                    path: 4 if kernel == "swin_block" else 2}
                check(got == want, f"{kernel} {name} {what}: products per "
                                   f"path {got}, want {want}")
                ms, runs = in_turns({"plain": ref, "kernel": fn},
                                    {"plain": 5, "kernel": 10})
                rows[kernel][f"{what} {name}"] = {
                    "ms": ms["kernel"], "plain_ms": ms["plain"],
                    **bound(ops, nbytes, kind)}
                print(f"[kernels] {kernel} width time {name} {what} B={b} "
                      f"{hw}x{hw} C={c} heads={heads} w={w} shifted: kernel "
                      f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
                      f"bound {rows[kernel][f'{what} {name}']['bound_ms']:.4f}"
                      f" ms; products {got}; runs {runs}; {card}")
            del x, attn, mlp, xm, cases
    swin_gemm.reset_launches()
    return rows


def phase_teacher_swin_t(card: str) -> dict:
    """The user-visible form of the widths off 64: a bf16 TeacherSession
    on Swin-T-224 (stage 0 at C 96, window 7: plan "split", K3 + K4 at
    every block) predicts 16 frames; its products all take wgmma. Returns
    the launches of one predict."""
    from computervision_codes_tpu_torch.ops import swin_gemm
    from computervision_codes_tpu_torch.serving import TeacherSession

    sess = TeacherSession.create(batch=16, img_size=224,
                                 backbone="swin_T_224_1k", device=DEVICE)
    frames = np.random.default_rng(6).integers(0, 256, (16, 224, 224, 3),
                                               dtype=np.uint8)
    sess.predict(frames)  # warm-up
    reset_launches()
    out, ms = timed_call(lambda: sess.predict(frames))
    got = path_launches()
    check_gemm_counts("Swin-T teacher predict")
    check_attn_counts("Swin-T teacher predict")
    p = out["i"]
    check(p.shape == (16, TASK_SIZES["i"]) and bool(np.isfinite(p).all()),
          f"Swin-T teacher i: {p.shape} or non-finite")
    want = dict.fromkeys(got, 0) | SWIN_T_TEACHER_LAUNCHES
    check(got == want, f"Swin-T teacher predict launches {got}")
    print(f"[teacher] TeacherSession bf16 swin_T_224_1k Q2L 'i' 16 frames "
          f"224x224: {ms:.3f} ms per predict; launches "
          f"{ {k: v for k, v in got.items() if v} }; {card}")
    del sess
    torch.cuda.empty_cache()
    return got


def attn_inputs(b, hp, wp, heads, w, dtype, seed):
    """K3's packed qkv (B, Hp, Wp, 3C) and a unit-normal bias (heads, N,
    N), made on the card from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    c, n = heads * 32, w * w
    qkv = torch.randn(b, hp, wp, 3 * c, generator=g, device=DEVICE)
    bias = torch.randn(heads, n, n, generator=g, device=DEVICE)
    return qkv.to(dtype), bias.to(dtype)


def phase_attn(card: str) -> dict:
    """The window-attention phase alone on K3's packed qkv, the current
    design (``window_attn_phase_cuda``: the scores in registers) against
    the plain version in float32 rounded once (K10's bar) and in the
    working dtype (K3's REL_TOL), with each window's absmax (the int8
    branch's proj scales) equal to its outputs' largest magnitude; then its
    time at Swin-L-384's four stage shapes, shifted and not, beside the
    plain version, SDPA (the yardstick only) and the bound."""
    from computervision_codes_tpu_torch.ops.window_mhsa import (
        window_attn_phase_cuda, window_attn_phase_reference,
        window_partition)

    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst, cases = (-1.0, None), 0
        for seed, (what, b, hw, heads, w) in enumerate(ATTN_CASES):
            hp, wp = geometry(hw)
            c = heads * 32
            qkv, bias = attn_inputs(b, hp, wp, heads, w, dtype, seed)
            for shift in (0, w // 2) if min(hp, wp) > w else (0,):
                mask = swin_mask(hp, wp, w, shift)
                mask = None if mask is None else mask.to(dtype)
                kw = dict(window=w, num_heads=heads, absmax=True)
                tag = f"window_attn {str(dtype)[6:]} {what} shift={shift}"
                got, amax = window_attn_phase_cuda(qkv, bias, mask, **kw)
                want, _ = window_attn_phase_reference(
                    qkv.float(), bias.float(),
                    None if mask is None else mask.float(), **kw)
                want = want.to(dtype).float()
                check(got.shape == want.shape,
                      f"{tag}: shape {tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
                top = want.abs().max().item()
                err = (got.float() - want).abs().max().item()
                tol = float(K10_BF16_ULPS * bf16_ulp(top)
                            if dtype == torch.bfloat16 else K10_F32_REL * top)
                check(err <= tol, f"{tag}: max_abs_err {err} > tol {tol}")
                compare(f"{tag} vs the plain version in "
                        f"{str(dtype)[6:]}", got,
                        window_attn_phase_reference(qkv, bias, mask,
                                                    window=w,
                                                    num_heads=heads), dtype)
                # the absmax is the largest |output| of each window (an
                # odd window's padded query may raise it)
                per_window = window_partition(got.float(), w).abs().amax(
                    dim=(1, 2))
                check(torch.equal(amax, per_window) if w % 2 == 0 else
                      bool((amax >= per_window).all()),
                      f"{tag}: window absmax is not the outputs' largest "
                      f"magnitude")
                if err / tol >= worst[0]:
                    worst = (err / tol, (what, shift, err, tol))
                if dtype == torch.bfloat16 and what.startswith("SwinL-384"):
                    main_err = max(main_err, err)
                cases += 1
                del got, want
            del qkv, bias
        print(f"[kernels] window_attn {str(dtype)[6:]}: {cases} cases within "
              f"tolerance of the float32 plain version rounded once ("
              + (f"{K10_BF16_ULPS} bf16 ulps of" if dtype == torch.bfloat16
                 else f"{K10_F32_REL:g} x") + f" max|ref|) and of the "
              f"{str(dtype)[6:]} plain version ({REL_TOL[dtype]:g} x "
              f"max|ref|), window absmaxes equal to the outputs' largest "
              f"magnitude; worst (case, shift, err, tol) = {worst[1]}")

    # times, bf16, at the four stage shapes shifted and not (the mask in
    # bf16, as the model passes it), beside the plain version and SDPA over
    # q, k, v views of one (BW, N, 3, H, 32) tensor with bias + mask as one
    # (BW, H, N, N) mask (as phase_k10), and the bound
    def timed(what, b, side, heads, w, shift, dtype, reps):
        nw, n = (side // w) ** 2, w * w
        qkv, bias = attn_inputs(b, side, side, heads, w, dtype, 99)
        mask = swin_mask(side, side, w, shift)
        mask = None if mask is None else mask.to(dtype)
        q, k, v, _ = k10_inputs(b * nw, heads, n, dtype, 98)
        full = bias[None].expand(b * nw, -1, -1, -1).contiguous()
        if mask is not None:
            full += mask.repeat(b, 1, 1)[:, None]
        kw = dict(window=w, num_heads=heads)
        ms, runs = in_turns(
            {"new": lambda: window_attn_phase_cuda(qkv, bias, mask, **kw),
             "plain": lambda: window_attn_phase_reference(qkv, bias, mask,
                                                          **kw),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=full, scale=32 ** -0.5)},
            {"new": reps, "plain": 3, "sdpa": reps})
        bnd = k10_bound(b * nw, heads, n, nw, mask is not None, dtype)
        print(f"[kernels] window_attn time {str(dtype)[6:]} {what} (BW, H, "
              f"N) = ({b * nw}, {heads}, {n}) shift={shift}: "
              f"{ms['new']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms, SDPA {ms['sdpa']:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_detail']}); runs "
              f"{runs}; {card}")
        del qkv, bias, q, k, v, full
        return ms | bnd

    times = {}
    for what, b, side, heads, w in ATTN_CASES[:4]:
        for shift in (0, w // 2) if side > w else (0,):
            times[f"{what} shift={shift}"] = timed(
                what, b, side, heads, w, shift, torch.bfloat16, 20)
    what, b, side, heads, w = ATTN_CASES[0]
    f32 = timed(what, b, side, heads, w, w // 2, torch.float32, 10)
    t = times[f"{what} shift={w // 2}"]
    return {"max_abs_err": main_err, "ms": t["new"], "plain_ms": t["plain"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["sdpa"],
            "ms_by_shape": {k: {"ms": v["new"], "plain_ms": v["plain"],
                                "library_ms": v["sdpa"],
                                "bound_ms": v["bound_ms"]}
                            for k, v in times.items()},
            "float32": {"ms": f32["new"],
                        "plain_ms": f32["plain"], "library_ms": f32["sdpa"],
                        "bound_ms": f32["bound_ms"],
                        "bound_by": f32["bound_by"]},
            "registers": attn_registers()}


def phase_k4(card: str) -> dict:
    """K4 (its products on the Swin GEMM core) against the plain version;
    in bf16 also against the loop, then kernel, loop and plain in
    turns."""
    from computervision_codes_tpu_torch.ops.mlp_block import (
        mlp_block_cuda, mlp_block_loop_cuda, mlp_block_reference)

    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst, differ = (-1.0, None), {}
        for seed, (what, m, c, hidden) in enumerate(K4_CASES):
            x, _, mlp = swin_inputs((m,), c, hidden, 1, 1, dtype, seed)
            got = mlp_block_cuda(x, *mlp)
            err, tol = compare(f"K4 {str(dtype)[6:]} {what}", got,
                               mlp_block_reference(x, *mlp), dtype)
            if err / tol >= worst[0]:
                worst = (err / tol, (what, err, tol))
            if dtype == torch.bfloat16:
                differ[what] = new_vs_old(got, mlp_block_loop_cuda(x, *mlp))
                if seed == 0:
                    main_err = err
            del x, mlp
        print(f"[kernels] K4 {str(dtype)[6:]}: {len(K4_CASES)} cases within "
              f"tolerance ({REL_TOL[dtype]:g} x max|ref|); worst (case, err,"
              f" tol) = {worst[1]}"
              + (f"; against the loop (outputs that differ, largest "
                 f"difference) {differ}" if differ else ""))
    times = {}
    for what, m, c, hidden in K4_CASES[:2]:
        for dtype in (torch.bfloat16, torch.float32):
            x, _, mlp = swin_inputs((m,), c, hidden, 1, 1, dtype, 99)
            fns = {"plain": lambda: mlp_block_reference(x, *mlp),
                   "kernel": lambda: mlp_block_cuda(x, *mlp),
                   "loop": lambda: mlp_block_loop_cuda(x, *mlp)}
            if dtype == torch.float32:  # both are the FMA loop
                del fns["loop"]
            ms, runs = in_turns(fns, {"plain": 10, "kernel": 20, "loop": 20})
            times[what, dtype] = ms
            shown = (f", loop {ms['loop']:.4f} ms" if "loop" in ms else "")
            print(f"[kernels] K4 time {str(dtype)[6:]} {what} {m} x {c}, "
                  f"hidden {hidden}: kernel {ms['kernel']:.4f} ms "
                  f"({4 * m * c * hidden / ms['kernel'] / 1e9:.1f} TFLOP/s)"
                  f"{shown}, plain {ms['plain']:.4f} ms; runs {runs}; {card}")
            del x, mlp
    what, m, c, hidden = K4_CASES[0]
    ms = times[what, torch.bfloat16]
    return {"max_abs_err": main_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], **bound(*mlp_work(m, c, hidden, 2),
                                             "bf16"),
            "library_ms": None, "loop_ms": ms["loop"],
            "stage3_ms": times[K4_CASES[1][0], torch.bfloat16]}


def phase_k5(card: str) -> dict:
    from computervision_codes_tpu_torch.ops.mlp_block import mlp_block_cuda
    from computervision_codes_tpu_torch.ops.swin_block import (
        swin_block_cuda, swin_block_loop_cuda, swin_block_reference)
    from computervision_codes_tpu_torch.ops.window_mhsa import (
        window_mhsa_cuda)

    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst, differ = (-1.0, None), {}
        for seed, (what, b, hw, c, heads, w) in enumerate(K5_CASES):
            x, attn, mlp = swin_inputs((b, hw, hw), c, 4 * c, heads, w,
                                       dtype, seed)
            for shift in (0, w // 2):
                kw = dict(window=w, num_heads=heads)
                mask = swin_mask(hw, hw, w, shift)
                got = swin_block_cuda(x, *attn, mask, *mlp, **kw)
                err, tol = compare(
                    f"K5 {str(dtype)[6:]} {what} shift={shift}", got,
                    swin_block_reference(x, *attn, mask, *mlp, **kw), dtype)
                if err / tol >= worst[0]:
                    worst = (err / tol, (what, shift, err, tol))
                if dtype == torch.bfloat16:
                    differ[f"{what} shift={shift}"] = new_vs_old(
                        got, swin_block_loop_cuda(x, *attn, mask, *mlp,
                                                  **kw))
                    if seed == 0:
                        main_err = max(main_err, err)
                del got
            del x, attn, mlp
        print(f"[kernels] K5 {str(dtype)[6:]}: {2 * len(K5_CASES)} cases "
              f"within tolerance ({REL_TOL[dtype]:g} x max|ref|); worst "
              f"(case, shift, err, tol) = {worst[1]}"
              + (f"; against the loop (outputs that differ, largest "
                 f"difference) {differ}" if differ else ""))
    # K5 against its plain version and against K3 then K4 (what a merged
    # block has to beat), bf16, shifted
    times = {}
    for what, b, hw, c, heads, w in K5_CASES:
        x, attn, mlp = swin_inputs((b, hw, hw), c, 4 * c, heads, w,
                                   torch.bfloat16, 99)
        mask, kw = swin_mask(hw, hw, w, w // 2), dict(window=w,
                                                      num_heads=heads)
        ms, runs = in_turns(
            {"plain": lambda: swin_block_reference(x, *attn, mask, *mlp,
                                                   **kw),
             "kernel": lambda: swin_block_cuda(x, *attn, mask, *mlp, **kw),
             "loop": lambda: swin_block_loop_cuda(x, *attn, mask, *mlp,
                                                  **kw),
             "k3_then_k4": lambda: mlp_block_cuda(
                 window_mhsa_cuda(x, *attn, mask, **kw), *mlp)},
            {"plain": 5, "kernel": 20, "loop": 20, "k3_then_k4": 20})
        times[what] = ms
        ops = (attn_work(b, hw, hw, c, heads, w, True, 2)[0]
               + mlp_work(b * hw * hw, c, 4 * c, 2)[0])
        print(f"[kernels] K5 time bf16 {what} B={b} {hw}x{hw} C={c} "
              f"heads={heads} w={w} shifted: kernel {ms['kernel']:.4f} ms "
              f"({ops / ms['kernel'] / 1e9:.1f} TFLOP/s), loop "
              f"{ms['loop']:.4f} ms, K3 then K4 "
              f"{ms['k3_then_k4']:.4f} ms, plain {ms['plain']:.4f} ms; runs "
              f"{runs}; {card}")
        del x, attn, mlp
    what, b, hw, c, heads, w = K5_CASES[0]
    m, es = b * hw * hw, 2
    a_ops, a_bytes = attn_work(b, hw, hw, c, heads, w, True, es)
    m_ops, m_bytes = mlp_work(m, c, 4 * c, es)
    ms = times[what]
    # y stays inside the block: x in and the output out, once each
    return {"max_abs_err": main_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"],
            **bound(a_ops + m_ops, a_bytes + m_bytes - 2 * es * m * c,
                    "bf16"),
            "library_ms": None, "loop_ms": ms["loop"],
            "stage1_ms": times[K5_CASES[1][0]]}


def q8_compare(tag: str, got, want) -> dict:
    """Checks an int8 branch's output against its plain version's: same
    shape, finite, and within the Q8_* bounds. Returns the readings."""
    check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    g, w = got.double().flatten(), want.double().flatten()
    step = w.abs().max().item() / 127.0
    err = (g - w).abs()
    out = {"max_abs_err": err.max().item(), "step": step,
           "share": (err > step).double().mean().item(),
           "corr": torch.corrcoef(torch.stack([g, w]))[0, 1].item()}
    check(out["max_abs_err"] <= Q8_MAX_STEPS * step,
          f"{tag}: max_abs_err {out['max_abs_err']} > {Q8_MAX_STEPS} int8 "
          f"steps ({step})")
    check(out["share"] <= Q8_MAX_SHARE,
          f"{tag}: {out['share']} of outputs more than one int8 step off")
    check(out["corr"] >= Q8_MIN_CORR, f"{tag}: correlation {out['corr']}")
    return out


def q8_args(attn=None, mlp=None):
    """The operands with their weights as ``Q8Weight``s (made once, as the
    model makes them)."""
    from computervision_codes_tpu_torch.ops.mlp_block import q8_weight

    out = []
    for part in (attn, mlp):
        if part is not None:
            part = list(part)
            part[2], part[4] = q8_weight(part[2]), q8_weight(part[4])
            out.append(part)
    return out


def q8_summary(kernel: str, dtype, readings: list) -> None:
    worst = max(readings, key=lambda r: r[1]["max_abs_err"] / r[1]["step"])
    print(f"[kernels] {kernel} int8 {str(dtype)[6:]}: {len(readings)} cases "
          f"within bounds (share > 1 int8 step <= {Q8_MAX_SHARE:g}, max err "
          f"<= {Q8_MAX_STEPS:g} steps, corr >= {Q8_MIN_CORR}); per case "
          + "; ".join(f"{what}: err {r['max_abs_err']:.4g} (step "
                      f"{r['step']:.4g}), share {r['share']:.3g}, corr "
                      f"{r['corr']:.7f}" for what, r in readings)
          + f"; worst {worst[0]}")


def same_as_loop(tag: str, got, old) -> None:
    """The Swin GEMM core's int8 output equals the loop's bit for bit."""
    check(torch.equal(got, old),
          f"{tag}: {int((got != old).sum())} outputs differ from the loop's, "
          f"by up to {(got.float() - old.float()).abs().max().item()}")


def phase_q8(card: str) -> dict:
    """The int8 branches of K3, K4 and K5 against their plain versions and
    (bit for bit) against the loop they ran on before, then their times
    beside the loop's, the plain versions' and the float kernels'."""
    from computervision_codes_tpu_torch.ops import mlp_block as k4
    from computervision_codes_tpu_torch.ops import swin_block as k5
    from computervision_codes_tpu_torch.ops import window_mhsa as k3

    main, equal = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        readings = []
        for seed, (what, b, hw, c, heads, w) in enumerate(K3_Q8_CASES):
            x, attn, _ = swin_inputs((b, hw, hw), c, 4 * c, heads, w, dtype,
                                     seed)
            (qa,) = q8_args(attn)
            for shift in (0, w // 2):
                kw = dict(window=w, num_heads=heads)
                mask = swin_mask(hw, hw, w, shift)
                tag = f"{what} shift={shift}"
                got = k3.window_mhsa_q8_cuda(x, *qa, mask, **kw)
                readings.append((tag, q8_compare(
                    f"K3 int8 {str(dtype)[6:]} {tag}", got,
                    k3.window_mhsa_reference(x, *qa, mask, quant=True,
                                             **kw))))
                same_as_loop(f"K3 int8 {str(dtype)[6:]} {tag}", got,
                             k3.window_mhsa_q8_loop_cuda(x, *qa, mask, **kw))
                equal += 1
            del x, attn, qa
        q8_summary("K3", dtype, readings)
        if dtype == torch.bfloat16:
            main["window_mhsa_q8"] = max(r["max_abs_err"]
                                         for _, r in readings[:2])
        readings = []
        for seed, (what, m, c, hidden) in enumerate(K4_Q8_CASES):
            x, _, mlp = swin_inputs((m,), c, hidden, 1, 1, dtype, seed)
            (qm,) = q8_args(mlp=mlp)
            got = k4.mlp_block_q8_cuda(x, *qm)
            readings.append((what, q8_compare(
                f"K4 int8 {str(dtype)[6:]} {what}", got,
                k4.mlp_block_reference(x, *qm, quant=True))))
            same_as_loop(f"K4 int8 {str(dtype)[6:]} {what}", got,
                         k4.mlp_block_q8_loop_cuda(x, *qm))
            equal += 1
            del x, mlp, qm
        q8_summary("K4", dtype, readings)
        if dtype == torch.bfloat16:
            main["mlp_block_q8"] = readings[0][1]["max_abs_err"]
        readings = []
        for seed, (what, b, hw, c, heads, w) in enumerate(K5_Q8_CASES):
            x, attn, mlp = swin_inputs((b, hw, hw), c, 4 * c, heads, w,
                                       dtype, seed)
            qa, qm = q8_args(attn, mlp)
            for shift in (0, w // 2):
                kw = dict(window=w, num_heads=heads)
                mask = swin_mask(hw, hw, w, shift)
                tag = f"{what} shift={shift}"
                got = k5.swin_block_q8_cuda(x, *qa, mask, *qm, **kw)
                readings.append((tag, q8_compare(
                    f"K5 int8 {str(dtype)[6:]} {tag}", got,
                    k5.swin_block_reference(x, *qa, mask, *qm, quant=True,
                                            **kw))))
                same_as_loop(f"K5 int8 {str(dtype)[6:]} {tag}", got,
                             k5.swin_block_q8_loop_cuda(x, *qa, mask, *qm,
                                                        **kw))
                equal += 1
                del got
            del x, attn, mlp, qa, qm
        q8_summary("K5", dtype, readings)
        if dtype == torch.bfloat16:
            main["swin_block_q8"] = max(r["max_abs_err"]
                                        for _, r in readings[:2])
    print(f"[kernels] K3, K4 and K5 int8 on the Swin GEMM core (quantize "
          f"pass + s8 wgmma) against the mma.sync loop: all {equal} cases "
          f"above, x in bf16 and float32, equal bit for bit; {card}")

    # times, bf16, at the main shapes: K3 stage 2 shifted, K4 stage 2 (and
    # stage 3), K5 stage 0 shifted; int8 kernel, plain version and the
    # float kernel in turns
    out, es = {}, 2
    what, b, hw, c, heads, w = K3_Q8_CASES[0]
    x, attn, _ = swin_inputs((b, hw, hw), c, 4 * c, heads, w, torch.bfloat16,
                             99)
    (qa,) = q8_args(attn)
    mask, kw = swin_mask(hw, hw, w, w // 2), dict(window=w, num_heads=heads)
    ms, runs = in_turns(
        {"plain": lambda: k3.window_mhsa_reference(x, *qa, mask, quant=True,
                                                   **kw),
         "kernel": lambda: k3.window_mhsa_q8_cuda(x, *qa, mask, **kw),
         "loop": lambda: k3.window_mhsa_q8_loop_cuda(x, *qa, mask, **kw),
         "float_kernel": lambda: k3.window_mhsa_cuda(x, *attn, mask, **kw)},
        {"plain": 5, "kernel": 20, "loop": 20, "float_kernel": 20})
    m, n = b * hw * hw, w * w
    int8_ops, bf16_ops = 8 * m * c * c, 4 * m * n * c
    # x in, y out, int8 weights, float32 scales and LN vectors, biases,
    # the rel-pos bias and the shift mask, each once
    nbytes = (es * (2 * m * c + 4 * c + heads * n * n
                    + (hw // w) ** 2 * n * n) + 4 * c * c + 24 * c)
    out["window_mhsa_q8"] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                             "loop_ms": ms["loop"],
                             "float_kernel_ms": ms["float_kernel"],
                             **bound_mixed({"int8": int8_ops,
                                            "bf16": bf16_ops}, nbytes)}
    print(f"[kernels] K3 int8 time bf16 {what} B={b} {hw}x{hw} C={c} w={w} "
          f"shifted: kernel {ms['kernel']:.4f} ms "
          f"({(int8_ops + bf16_ops) / ms['kernel'] / 1e9:.1f} TOP/s), loop "
          f"{ms['loop']:.4f} ms, float "
          f"kernel {ms['float_kernel']:.4f} ms, plain {ms['plain']:.4f} ms; "
          f"runs {runs}; {card}")
    del x, attn, qa
    for i, (what, m, c, hidden) in enumerate(K4_Q8_CASES):
        x, _, mlp = swin_inputs((m,), c, hidden, 1, 1, torch.bfloat16, 99)
        (qm,) = q8_args(mlp=mlp)
        ms, runs = in_turns(
            {"plain": lambda: k4.mlp_block_reference(x, *qm, quant=True),
             "kernel": lambda: k4.mlp_block_q8_cuda(x, *qm),
             "loop": lambda: k4.mlp_block_q8_loop_cuda(x, *qm),
             "float_kernel": lambda: k4.mlp_block_cuda(x, *mlp)},
            {"plain": 5, "kernel": 20, "loop": 20, "float_kernel": 20})
        ops = 4 * m * c * hidden
        if i == 0:
            out["mlp_block_q8"] = {
                "ms": ms["kernel"], "plain_ms": ms["plain"],
                "loop_ms": ms["loop"],
                "float_kernel_ms": ms["float_kernel"],
                **bound(ops, es * 2 * m * c + 2 * c * hidden
                        + 4 * (hidden + c) + es * (hidden + c) + 8 * c,
                        "int8")}
        print(f"[kernels] K4 int8 time bf16 {what} {m} x {c}, hidden "
              f"{hidden}: kernel {ms['kernel']:.4f} ms "
              f"({ops / ms['kernel'] / 1e9:.1f} TOP/s), loop "
              f"{ms['loop']:.4f} ms, float kernel "
              f"{ms['float_kernel']:.4f} ms, plain {ms['plain']:.4f} ms; "
              f"runs {runs}; {card}")
        del x, mlp, qm
    what, b, hw, c, heads, w = K5_Q8_CASES[0]
    x, attn, mlp = swin_inputs((b, hw, hw), c, 4 * c, heads, w,
                               torch.bfloat16, 99)
    qa, qm = q8_args(attn, mlp)
    mask, kw = swin_mask(hw, hw, w, w // 2), dict(window=w, num_heads=heads)
    ms, runs = in_turns(
        {"plain": lambda: k5.swin_block_reference(x, *qa, mask, *qm,
                                                  quant=True, **kw),
         "kernel": lambda: k5.swin_block_q8_cuda(x, *qa, mask, *qm, **kw),
         "loop": lambda: k5.swin_block_q8_loop_cuda(x, *qa, mask, *qm,
                                                    **kw),
         "float_kernel": lambda: k5.swin_block_cuda(x, *attn, mask, *mlp,
                                                    **kw)},
        {"plain": 3, "kernel": 10, "loop": 10, "float_kernel": 10})
    m, n = b * hw * hw, w * w
    int8_ops, bf16_ops = 8 * m * c * c + 4 * m * c * 4 * c, 4 * m * n * c
    nbytes = (es * (2 * m * c + 9 * c + heads * n * n
                    + (hw // w) ** 2 * n * n) + 12 * c * c + 52 * c)
    out["swin_block_q8"] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                            "loop_ms": ms["loop"],
                            "float_kernel_ms": ms["float_kernel"],
                            **bound_mixed({"int8": int8_ops,
                                           "bf16": bf16_ops}, nbytes)}
    print(f"[kernels] K5 int8 time bf16 {what} B={b} {hw}x{hw} C={c} w={w} "
          f"shifted: kernel {ms['kernel']:.4f} ms "
          f"({(int8_ops + bf16_ops) / ms['kernel'] / 1e9:.1f} TOP/s), loop "
          f"{ms['loop']:.4f} ms, float "
          f"kernel {ms['float_kernel']:.4f} ms, plain {ms['plain']:.4f} ms; "
          f"runs {runs}; {card}")
    del x, attn, mlp, qa, qm
    return {name: {"max_abs_err": main[name], **out[name],
                   "library_ms": None} for name in out}


def phase_gemm_walk(card: str) -> None:
    """The Swin GEMM core's persistent walk: each epilogue (bf16 and int8)
    is held, by the phases above and phase_p1, at a product where every
    resident block walks at least GEMM_WALK_TILES output tiles (the ring's
    stage and phase carried across them)."""
    tiles = {what: gemm_tiles_per_block(m, n)
             for what, m, _, n, _ in GEMM_WALK}
    for what, t in tiles.items():
        check(t >= GEMM_WALK_TILES,
              f"swin_gemm walk {what}: {t:.2f} tiles per resident block")
    print(f"[kernels] swin_gemm persistent walk: tiles per resident block at "
          + ", ".join(f"{what} ({epi}) {tiles[what]:.2f}"
                      for what, _, _, _, epi in GEMM_WALK)
          + f" (>= {GEMM_WALK_TILES}); these products' outputs are held bf16 "
          f"within REL_TOL and int8 bit for bit above; {card}")


def phase_q1_dense(card: str) -> dict:
    """Q1 as the int8 teacher's Dense layers: both paths bit for bit against
    the plain version at their shapes, then at each shape the new path's,
    the loop's, the plain version's and torch._int_mm's (the int8 product
    alone, from codes already made) times in turns."""
    from computervision_codes_tpu_torch.ops.quant import (
        qconv_bn_cuda, qconv_bn_reference, qconv_loop_cuda,
        quantize_with_scale)

    paths = {"new": qconv_bn_cuda, "loop": qconv_loop_cuda}
    for seed, (what, m, k, n) in enumerate(Q1_DENSE):
        x, w_q, mult, bias = qconv_inputs(1, k, n, 1, m, 1, torch.bfloat16,
                                          seed)
        x = x.reshape(m, 1, 1, k)
        s_act = torch.tensor([0.03], device=DEVICE)
        for dtype in (torch.bfloat16, torch.float32):
            want = qconv_bn_reference(x, s_act, w_q, mult, bias, 1, "VALID",
                                      dtype=dtype)
            for name, fn in paths.items():
                before = q1_launches()
                got = fn(x, s_act, w_q, mult, bias, 1, "VALID", dtype=dtype)
                check_q1_paths(before, 1, "gemm" if name == "new" else "loop",
                               f"Q1 Dense {what} {name}")
                check(torch.equal(got, want),
                      f"Q1 Dense {what} {m}x{k}->{n} {name} out {dtype}: "
                      f"differs by "
                      f"{(got.float() - want.float()).abs().max().item()}")
        del x, w_q, got, want
    print(f"[kernels] Q1 as the int8 Dense, bf16 in, bf16 and float32 out, "
          f"{len(Q1_DENSE)} shapes (M, K, N) "
          f"{[(m, k, n) for _, m, k, n in Q1_DENSE]}, the new path (quantize "
          f"pass + wgmma, TMA producer) and the loop: equal to the plain "
          f"version bit for bit")
    out = {}
    for what, m, k, n in Q1_DENSE:
        x, w_q, mult, bias = qconv_inputs(1, k, n, 1, m, 1, torch.bfloat16,
                                          99)
        x = x.reshape(m, 1, 1, k)
        s_act = torch.tensor([0.03], device=DEVICE)
        a8 = quantize_with_scale(x, s_act).reshape(m, k)
        b8 = w_q.reshape(n, k).t()  # (K, N), column-major
        fns = {"plain": lambda: qconv_bn_reference(x, s_act, w_q, mult,
                                                   bias, 1, "VALID"),
               "new": lambda: qconv_bn_cuda(x, s_act, w_q, mult, bias, 1,
                                            "VALID"),
               "loop": lambda: qconv_loop_cuda(x, s_act, w_q, mult, bias, 1,
                                               "VALID")}
        try:
            torch._int_mm(a8, b8)
            fns["int_mm"] = lambda: torch._int_mm(a8, b8)
        except RuntimeError as err:
            print(f"[kernels] torch._int_mm at {m}x{k}->{n} unavailable: "
                  f"{err}")
        ms, runs = in_turns(fns, {"plain": 5, "new": 20, "loop": 20,
                                  "int_mm": 20})
        dev = {name: device_ms(fns[name], 10) for name in fns
               if name != "plain"}
        ops = 2 * m * k * n
        b = bound(ops, 2 * m * k + k * n + 2 * m * n + 8 * n, "int8")
        print(f"[kernels] Q1 Dense time {what} bf16 {m}x{k}->{n}: new "
              f"{ms['new']:.4f} ms ({ops / ms['new'] / 1e9:.1f} TOP/s; device "
              f"{dev['new']:.4f}), loop {ms['loop']:.4f} ms (device "
              f"{dev['loop']:.4f}), plain {ms['plain']:.4f} ms, torch._int_mm "
              f"(int8 product alone) {ms.get('int_mm', float('nan')):.4f} ms "
              f"(device {dev.get('int_mm', float('nan')):.4f}); bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']}; runs {runs}; "
              f"{card}")
        out[what] = {"shape": [m, k, n], "ms": ms["new"],
                     "device_ms": round(dev["new"], 4), "loop_ms": ms["loop"],
                     "plain_ms": ms["plain"], "int_mm_ms": ms.get("int_mm"),
                     **b}
        if m < 1024:  # host-bound: the host's cost of one call, each path
            host = {}
            for name in ("new", "loop"):
                fns[name]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(Q1_HOST_CALLS):
                    fns[name]()
                host[name] = (time.perf_counter() - t0) / Q1_HOST_CALLS * 1e6
                torch.cuda.synchronize()
            print(f"[kernels] Q1 Dense host cost of a call at {m}x{k}->{n}: "
                  f"new {host['new']:.1f} us (quantize pass + wgmma, two "
                  f"launches), loop {host['loop']:.1f} us (one launch); "
                  f"mean of {Q1_HOST_CALLS} calls, host clock; {card}")
            out[what]["host_us"] = {k_: round(v, 1) for k_, v in host.items()}
        del x, w_q, a8, b8
    timed = out[Q1_DENSE_TIMED]
    return {"dense_shape": timed["shape"], "dense_ms": timed["ms"],
            "dense_device_ms": timed["device_ms"],
            "dense_loop_ms": timed["loop_ms"],
            "dense_plain_ms": timed["plain_ms"],
            "dense_int_mm_ms": timed["int_mm_ms"],
            "dense_bound": {"bound_ms": timed["bound_ms"],
                            "bound_by": timed["bound_by"]},
            "dense_ms_by_shape": {what: [r["ms"], r["loop_ms"],
                                         r["int_mm_ms"]]
                                  for what, r in out.items()},
            "dense_host_us": {what: r["host_us"] for what, r in out.items()
                              if "host_us" in r}}


def phase_model() -> None:
    from computervision_codes_tpu_torch.models.pipeline import (
        EndToEndRecognizer)

    cpu_model = EndToEndRecognizer(
        dtype=torch.float32,
        generator=torch.Generator().manual_seed(0)).eval()
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(
        rng.standard_normal(MODEL_CLIP + (3,)).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(clip)
        t_cpu = time.perf_counter() - t0
        got = {k: v.cpu() for k, v in dev_model(clip.to(DEVICE)).items()}
    for k in ("ivt", "i", "v", "t", "features"):
        g, w = got[k], want[k]
        check(g.shape == w.shape, f"model {k}: shape {g.shape} != {w.shape}")
        check(bool(torch.isfinite(g).all()), f"model {k}: non-finite")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(err <= MODEL_REL_TOL * scale,
              f"model {k}: card vs CPU max_abs_err {err} > "
              f"{MODEL_REL_TOL} x {scale}")
        print(f"[model] float32 {k} {tuple(g.shape)}: card vs CPU max_abs_err "
              f"{err:.3e} (max|ref| {scale:.3f}, tol {MODEL_REL_TOL:g} x "
              f"max|ref|)")
    print(f"[model] CPU forward {t_cpu:.2f} s (host clock)")


def phase_model_int8() -> None:
    from computervision_codes_tpu_torch.models.pipeline import (
        EndToEndRecognizer)
    from computervision_codes_tpu_torch.models.quantized import make_int8_e2e
    from computervision_codes_tpu_torch.serving import _to_model_input

    float_model = EndToEndRecognizer(
        dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0)).eval()
    pixels = np.random.default_rng(3).integers(0, 256, MODEL_CLIP + (3,),
                                               dtype=np.uint8)
    clip = _to_model_input(pixels, torch.device("cpu"), torch.bfloat16)
    t0 = time.perf_counter()
    cpu_model = make_int8_e2e(float_model, calibrate_clips=clip[:, :4],
                              fused_stem=True)
    t_cal = time.perf_counter() - t0
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(clip)
        t_cpu = time.perf_counter() - t0
        before, q1_before = launches(), q1_launches()
        got = {k: v.cpu() for k, v in dev_model(clip.to(DEVICE)).items()}
        count = launched_since(before)
    want_count = dict.fromkeys(KERNELS, 0) | {
        "dilated_residual": LAYERS_PER_FORWARD, "stem_pool": 1,
        "qconv_bn": INT8_CONVS}
    check(count == want_count, f"int8 model launches {count}, want "
                               f"{want_count}")
    check_q1_paths(q1_before, INT8_CONVS, "conv", "int8 model")
    for k in ("ivt", "i", "v", "t", "features"):
        g, w = got[k].float(), want[k].float()
        check(g.shape == w.shape, f"int8 model {k}: shape {g.shape}")
        check(bool(torch.isfinite(g).all()), f"int8 model {k}: non-finite")
        corr = float(np.corrcoef(g.numpy().ravel(), w.numpy().ravel())[0, 1])
        err = (g - w).abs().max().item()
        check(corr > INT8_MODEL_MIN_CORR,
              f"int8 model {k}: card vs CPU correlation {corr} <= "
              f"{INT8_MODEL_MIN_CORR}")
        print(f"[model] int8 bf16 fused stem {k} {tuple(g.shape)}: card vs "
              f"CPU correlation {corr:.6f} (bound > {INT8_MODEL_MIN_CORR}), "
              f"max_abs_err {err:.3e} (max|ref| {w.abs().max().item():.3f})")
    print(f"[model] int8 launches on the card per forward {count}; CPU "
          f"calibration (4 frames) {t_cal:.2f} s and forward {t_cpu:.2f} s "
          f"(host clock)")


def phase_model_teacher() -> dict:
    from computervision_codes_tpu_torch.models.q2l import Q2L

    cpu_model = Q2L(backbone=TEACHER_BACKBONE, loss_type="i",
                    dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0)).eval()
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (TEACHER_MODEL_FRAMES, TEACHER_IMG, TEACHER_IMG, 3)).astype(
            np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(frames)
        t_cpu = time.perf_counter() - t0
        before, gemms = launches(), gemm_counts()
        got = dev_model(frames.to(DEVICE))
        count = launched_since(before)
        gemms = {k: n - gemms[k] for k, n in gemm_counts().items()}
    want_count = dict.fromkeys(KERNELS, 0) | TEACHER_LAUNCHES
    check(count == want_count, f"teacher model launches {count}, want "
                               f"{want_count}")
    # float32 stays on the FMA loop: the 92 products of a predict
    check(gemms == {"wgmma": 0, "loop": 0, "fma": TEACHER_GEMMS["swin_gemm"]},
          f"float32 teacher model: Swin GEMM products per path {gemms}")
    for k, g, w in (("logits i", got["logits"]["i"], want["logits"]["i"]),
                    ("feature", got["feature"], want["feature"])):
        g = g.cpu()
        check(g.shape == w.shape, f"teacher model {k}: shape {g.shape}")
        check(bool(torch.isfinite(g).all()), f"teacher model {k}: non-finite")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(err <= TEACHER_MODEL_REL_TOL * scale,
              f"teacher model {k}: card vs CPU max_abs_err {err} > "
              f"{TEACHER_MODEL_REL_TOL} x {scale}")
        print(f"[model] teacher float32 Q2L({TEACHER_BACKBONE}, 'i') {k} "
              f"{tuple(g.shape)}: card vs CPU max_abs_err {err:.3e} (max|ref|"
              f" {scale:.3f}, tol {TEACHER_MODEL_REL_TOL:g} x max|ref|)")
    print(f"[model] teacher launches on the card per forward {count}, "
          f"Swin GEMM products per path {gemms}; CPU forward of "
          f"{TEACHER_MODEL_FRAMES} frame(s) {t_cpu:.2f} s (host clock)")
    return want


def phase_model_teacher_int8(float_want: dict) -> None:
    """The full-width int8 teacher in float32: Q2L(quant_eval, s2d_embed)
    with its Dense layers of >= 512 inputs swapped for Int8Dense, calibrated
    on the CPU, then on the card against the CPU on one frame. Beside each
    reading: the int8 model's own distance from the float32 model on the
    CPU (``float_want``, the same weights and frame), the PTQ noise."""
    from computervision_codes_tpu_torch.models.q2l import Q2L
    from computervision_codes_tpu_torch.models.quant_dense import (
        apply_int8_dense, collect_dense_scales, quantize_dense_params)
    from computervision_codes_tpu_torch.serving import (
        INT8_DENSE_MIN_FEATURES, _default_calibration)

    cpu_model = Q2L(backbone=TEACHER_BACKBONE, loss_type="i",
                    dtype=torch.float32, quant_eval=True, s2d_embed=True,
                    generator=torch.Generator().manual_seed(0)).eval()
    frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (TEACHER_MODEL_FRAMES, TEACHER_IMG, TEACHER_IMG, 3)).astype(
            np.float32))
    t0 = time.perf_counter()
    scales = collect_dense_scales(cpu_model, _default_calibration(
        (1, TEACHER_IMG, TEACHER_IMG, 3), torch.float32, "cpu"))
    apply_int8_dense(cpu_model, quantize_dense_params(cpu_model), scales,
                     min_features=INT8_DENSE_MIN_FEATURES)
    t_cal = time.perf_counter() - t0
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(frames)
        t_cpu = time.perf_counter() - t0
        before, q1_before = launches(), q1_launches()
        got = dev_model(frames.to(DEVICE))
        count = launched_since(before)
    want_count = (dict.fromkeys(KERNELS, 0) | TEACHER_Q8_LAUNCHES
                  | TEACHER_Q8_F32_GEMMS)
    check(count == want_count, f"int8 teacher model launches {count}, want "
                               f"{want_count}")
    check_q1_paths(q1_before, TEACHER_Q8_LAUNCHES["qconv_bn"], "gemm",
                   "int8 teacher model")
    pairs = [("logits i", got["logits"]["i"], want["logits"]["i"],
              float_want["logits"]["i"]),
             ("feature", got["feature"], want["feature"],
              float_want["feature"])]
    pairs.append(("logits and feature",
                  *(torch.cat([p[i].flatten() for p in pairs])
                    for i in (1, 2, 3))))
    for k, g, w, f in pairs:
        g = g.cpu()
        ptq = float(np.corrcoef(w.numpy().ravel(), f.numpy().ravel())[0, 1])
        check(g.shape == w.shape, f"int8 teacher model {k}: shape {g.shape}")
        check(bool(torch.isfinite(g).all()),
              f"int8 teacher model {k}: non-finite")
        corr = float(np.corrcoef(g.numpy().ravel(), w.numpy().ravel())[0, 1])
        err = (g - w).abs().max().item()
        if k != "logits i":  # 6 values: printed, not bounded alone
            check(corr >= TEACHER_Q8_MIN_CORR,
                  f"int8 teacher model {k}: card vs CPU correlation {corr} "
                  f"< {TEACHER_Q8_MIN_CORR}")
        print(f"[model] int8 teacher float32 Q2L({TEACHER_BACKBONE}, 'i') "
              f"{k} {tuple(g.shape)}: card vs CPU correlation {corr:.6f} "
              f"(bound >= {TEACHER_Q8_MIN_CORR}), max_abs_err {err:.3e} "
              f"(max|ref| {w.abs().max().item():.3f}); the int8 model vs "
              f"the float32 model on the CPU: correlation {ptq:.6f}")
    print(f"[model] int8 teacher launches on the card per forward {count}; "
          f"CPU calibration (1 frame) and swap {t_cal:.2f} s, CPU forward "
          f"of {TEACHER_MODEL_FRAMES} frame(s) {t_cpu:.2f} s (host clock)")


def phase_teacher(card: str, configs: dict, backbone: str = TEACHER_BACKBONE,
                  img: int = TEACHER_IMG, b: int = TEACHER_BATCH) -> tuple:
    """``configs``: label -> (launches per predict, ``create`` kwargs).
    Creates each TeacherSession of ``backbone`` at ``img`` and batch ``b``,
    at its defaults otherwise (Q2L "i"), and predicts with them in turns
    (the order reversed every other round) on uint8 frames: launches of
    each kernel per predict, ms, frames/s, the device memory a predict adds
    and its peak."""
    from computervision_codes_tpu_torch.serving import TeacherSession

    sessions = {}
    for label, (_, kw) in configs.items():
        t0 = time.perf_counter()
        sessions[label] = TeacherSession.create(
            batch=b, img_size=img, backbone=backbone, device=DEVICE, **kw)
        torch.cuda.synchronize()
        print(f"[teacher] {label} TeacherSession created in "
              f"{time.perf_counter() - t0:.2f} s (host clock)")
    base = np.random.default_rng(5).integers(0, 256, (b, img, img, 3),
                                             dtype=np.uint8)
    labels = list(configs)
    ms = {label: [] for label in labels}
    peak, added = dict.fromkeys(labels, 0), dict.fromkeys(labels, 0)
    for call in range(TEACHER_CALLS):
        frames = base + np.uint8(call)
        for label in labels if call % 2 == 0 else labels[::-1]:
            sess = sessions[label]
            want = dict.fromkeys(KERNELS, 0) | configs[label][0]
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before, q1_before = launches(), q1_launches()
            out, call_ms = timed_call(lambda: sess.predict(frames))
            top = torch.cuda.max_memory_allocated()
            peak[label] = max(peak[label], top)
            added[label] = max(added[label], top - resident)
            ms[label].append(call_ms)
            count = launched_since(before)
            check(count == want, f"{label} teacher predict {call}: launches "
                                 f"{count}, want {want}")
            check_q1_paths(q1_before, want["qconv_bn"], "gemm",
                           f"{label} teacher predict {call}")
            check(set(out) == {"i", "feature"},
                  f"{label} teacher outputs {set(out)}")
            p, feat = out["i"], out["feature"]
            check(p.shape == (b, TASK_SIZES["i"]),
                  f"{label} teacher i: {p.shape}")
            check(bool(np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()),
                  f"{label} teacher i: non-finite or outside [0, 1]")
            check(feat.shape[0] == b and bool(np.isfinite(feat).all()),
                  f"{label} teacher feature: shape {feat.shape} or "
                  f"non-finite")
    steady = {label: float(np.median(ms[label][1:])) for label in labels}
    for label in labels:
        weights = sum(t.numel() * t.element_size() for t in
                      list(sessions[label].model.parameters())
                      + list(sessions[label].model.buffers()))
        print(f"[teacher] TeacherSession {label} {backbone} Q2L 'i' "
              f"{b} frames {img}x{img} uint8: launches per predict "
              f"{configs[label][0]}; ms per predict "
              f"{[round(m, 3) for m in ms[label]]} (first warms up); median "
              f"{steady[label]:.3f} ms = {b / steady[label] * 1e3:.1f} "
              f"frames/s; device memory: the session's weights "
              f"{weights / 2**30:.2f} GiB, a predict adds up to "
              f"{added[label] / 2**30:.2f} GiB, peak in predict "
              f"{peak[label] / 2**30:.2f} GiB (the sessions still held "
              f"resident); "
              f"{card}")
    print(f"[teacher] frames/s on one line, sessions in turns: " + ", ".join(
        f"{label} {b / ms_ * 1e3:.1f} ({ms_:.3f} ms)"
        for label, ms_ in steady.items()) + f"; {card}")
    return sessions, base


def teacher_breakdown(card: str, label: str, sess,
                      frames: np.ndarray) -> None:
    """ms of the input, the patch embed, each Swin stage (its blocks and
    the patch merge after it), the final norm and the Q2L transformer and
    heads of one predict (CUDA events, mean of 3 after a warm-up), then
    the device time by kernel of one predict from torch.profiler."""
    from computervision_codes_tpu_torch.serving import _to_model_input

    model, bb = sess.model, sess.model.backbone
    with torch.inference_mode():
        x = _to_model_input(frames, sess.device, torch.bfloat16)
        maps = [bb.embed(x)]
        for si in range(len(bb.depths)):
            maps.append(bb.stage(si, maps[-1]))
        fmap = bb.norm(maps[-1])
        parts = {}
        for name, fn in (
                [("input", lambda: _to_model_input(frames, sess.device,
                                                   torch.bfloat16)),
                 ("patch_embed", lambda: bb.embed(x))]
                + [(f"stage{si}", functools.partial(bb.stage, si, maps[si]))
                   for si in range(len(bb.depths))]
                + [("norm", lambda: bb.norm(maps[-1])),
                   ("q2l_head", lambda: model.head(fmap))]):
            fn()
            parts[name] = round(cuda_ms(fn, 3), 3)
    print(f"[breakdown] {label} teacher: ms per predict of "
          f"{frames.shape[0]} frames {parts}; {card}")
    device_profile(card, f"{label} teacher predict",
                   lambda: sess.predict(frames), 16)
    with torch.inference_mode():
        device_profile(card, f"{label} teacher Q2L transformer and heads",
                       lambda: model.head(fmap), 8)


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn``: the sum of its CUDA kernels'
    times under torch.profiler over ``reps`` calls after a warm-up, over
    ``reps``. The tracer can drop records (often one a trace, at times
    most), so the time is the mean record's times the records of one call
    (``records / reps`` rounded); a trace that kept fewer than half a
    call's records per call is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in rows)
        records = sum(e.count for e in rows)
        per_call = round(records / reps)
        if per_call:
            return us / records * per_call / 1e3
    print(f"[profiler] {records} device records over {reps} calls in each "
          f"of three traces: no device time")
    return 0.0


def device_profile(card: str, label: str, fn, top: int) -> tuple:
    """One call of ``fn`` under torch.profiler after a warm-up: host wall
    time to a synchronise, device busy time (the sum of the kernel and copy
    rows) and the ``top`` rows by device time. Returns (busy ms, every row
    as (device ms, count, name))."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, launched = [], 0
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel"):
            launched += evt.count
        if not str(evt.device_type).endswith("CUDA"):
            continue  # CPU rows nest over their kernels' time
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        rows.append((dev_us / 1e3, evt.count, evt.key[:70]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[breakdown] {label} under torch.profiler: {wall_ms:.3f} ms wall, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{launched} kernel launches from the host; {card}")
    for dev_ms, count, name in rows[:top]:
        print(f"[breakdown]   {dev_ms:9.3f} ms  x{count:<5d} {name}")
    return busy, rows


def tresnet_breakdown(card: str, label: str, sess,
                      frames: np.ndarray) -> None:
    """ms of the input, the stem, each TResNet stage and the Q2L transformer
    and heads of one predict (CUDA events, mean of 3 after a warm-up),
    then the device time by kernel of one predict from torch.profiler and
    K9's share of it."""
    from computervision_codes_tpu_torch.serving import _to_model_input

    model, bb = sess.model, sess.model.backbone
    with torch.inference_mode():
        x = _to_model_input(frames, sess.device, torch.bfloat16)
        maps = [bb.stem(x)]
        for si in range(len(bb.stage_names)):
            maps.append(bb.stage(si, maps[-1]))
        fmap = maps[-1].permute(0, 2, 3, 1)
        parts = {}
        for name, fn in (
                [("input", lambda: _to_model_input(frames, sess.device,
                                                   torch.bfloat16)),
                 ("stem", lambda: bb.stem(x))]
                + [(f"layer{si + 1}", functools.partial(bb.stage, si,
                                                        maps[si]))
                   for si in range(len(bb.stage_names))]
                + [("q2l_head", lambda: model.head(fmap))]):
            fn()
            parts[name] = round(cuda_ms(fn, 3), 3)
    print(f"[breakdown] {label} teacher: ms per predict of "
          f"{frames.shape[0]} frames {parts}; {card}")
    busy, rows = device_profile(card, f"{label} teacher predict",
                                lambda: sess.predict(frames), 16)
    k9 = [r for r in rows if "fsba_kernel" in r[2]]
    k9_ms = sum(r[0] for r in k9)
    print(f"[breakdown] {label} teacher predict: K9 {k9_ms:.3f} ms of "
          f"{busy:.3f} ms device busy ({100 * k9_ms / max(busy, 1e-9):.1f}%)"
          f" in "
          f"{sum(r[1] for r in k9)} launches; {card}")
    with torch.inference_mode():
        device_profile(card, f"{label} teacher Q2L transformer and heads",
                       lambda: model.head(fmap), 8)


def phase_swin_fused(card: str) -> dict:
    """Path B: ``build_swin(swin_L_384_22k, use_fused_attn=True)``, one bf16
    eval forward of 16 frames with its kernel launches counted (K10 24, the
    rest 0), then ms per forward beside the default plan's (K5, K3 + K4) at
    the same weights and input, in turns, and how far the two plans'
    feature maps are apart. Returns the counted forward's launches."""
    from computervision_codes_tpu_torch.models.swin import build_swin

    def model(**kw):
        return build_swin(TEACHER_BACKBONE, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0),
                          **kw).to(DEVICE).eval()

    fused = model(use_fused_attn=True)
    g = torch.Generator(device=DEVICE).manual_seed(10)
    frames = torch.randn(TEACHER_BATCH, TEACHER_IMG, TEACHER_IMG, 3,
                         generator=g, device=DEVICE).bfloat16()
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = launches()
        out, first_ms = timed_call(lambda: fused(frames)["feature_map"])
        count = launched_since(before)
    want = dict.fromkeys(KERNELS, 0) | SWIN_FUSED_LAUNCHES
    check(count == want, f"use_fused_attn forward launches {count}, want "
                         f"{want}")
    side = TEACHER_IMG // 32
    check(tuple(out.shape) == (TEACHER_BATCH, side, side,
                               fused.num_features)
          and bool(torch.isfinite(out).all()),
          f"use_fused_attn forward: shape {tuple(out.shape)} or non-finite")
    default = model()
    with torch.inference_mode():
        ms, runs = in_turns({"use_fused_attn": lambda: fused(frames),
                             "default plan": lambda: default(frames)},
                            dict.fromkeys(("use_fused_attn", "default plan"),
                                          SWIN_FUSED_CALLS))
        ref = default(frames)["feature_map"].float()
    got = out.float()
    corr = float(torch.corrcoef(torch.stack([got.flatten(),
                                             ref.flatten()]))[0, 1])
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    print(f"[path B] {TEACHER_BACKBONE} use_fused_attn, bf16 forward of "
          f"{TEACHER_BATCH} frames {TEACHER_IMG}x{TEACHER_IMG}: launches "
          f"{ {k: v for k, v in count.items() if v} } (first forward "
          f"{first_ms:.3f} ms); ms per forward {ms['use_fused_attn']:.3f} "
          f"against the default plan's {ms['default plan']:.3f} (K5 at "
          f"stages 0-1, K3 + K4 at stage 2, K4 at stage 3), in turns, runs "
          f"{runs}; the two plans' feature maps: max difference "
          f"{err:.2e} of max|default|, correlation {corr:.6f}; {card}")
    del fused, default
    return count


def phase_offline(card: str, configs: dict) -> tuple:
    """``configs``: label -> (launches per predict, ``create`` kwargs).
    Creates every session, then predicts with them in turns (the order
    reversed every other round), so their times share one window."""
    from computervision_codes_tpu_torch.serving import InferenceSession

    b, t, h, w = OFFLINE
    sessions = {label: InferenceSession.create(
        batch=b, clip_len=t, height=h, width=w, device=DEVICE, **kw)
        for label, (_, kw) in configs.items()}
    base = np.random.default_rng(1).integers(0, 256, (b, t, h, w, 3),
                                             dtype=np.uint8)
    labels = list(configs)
    ms = {label: [] for label in labels}
    peak = dict.fromkeys(labels, 0)
    for call in range(OFFLINE_CALLS):  # call 0 warms up (cuDNN, allocator)
        clips = base + np.uint8(call)  # a different clip per call
        for label in labels if call % 2 == 0 else labels[::-1]:
            want, sess = configs[label][0], sessions[label]
            torch.cuda.reset_peak_memory_stats()
            before, q1_before = launches(), q1_launches()
            probs, call_ms = timed_call(lambda: sess.predict(clips))
            peak[label] = max(peak[label], torch.cuda.max_memory_allocated())
            ms[label].append(call_ms)
            count = launched_since(before)
            check(count == want, f"{label} predict {call}: launches {count},"
                                 f" want {want}")
            check_q1_paths(q1_before, want["qconv_bn"], "conv",
                           f"{label} predict {call}")
            check_probs(probs, (b, t), f"{label} predict {call}")
    steady = {label: float(np.median(ms[label][1:])) for label in labels}
    for label in labels:
        print(f"[offline] InferenceSession {label} {b}x{t} frames {h}x{w} "
              f"uint8: launches per predict {configs[label][0]}; ms per "
              f"predict {[round(m, 3) for m in ms[label]]} (first warms up); "
              f"median {steady[label]:.3f} ms = "
              f"{b * t / steady[label] * 1e3:.1f} frames/s; peak device "
              f"memory in predict {peak[label] / 2**30:.2f} GiB (every "
              f"session's weights resident); {card}")
    print(f"[offline] frames/s on one line, sessions in turns: " + ", ".join(
        f"{label} {b * t / ms_ * 1e3:.1f} ({ms_:.3f} ms)"
        for label, ms_ in steady.items()) + f"; {card}")
    return sessions, base


def phase_streaming(card: str, label: str, want: dict, **session_kw) -> list:
    from computervision_codes_tpu_torch.serving import StreamingSession

    _, _, h, w = OFFLINE
    rng = np.random.default_rng(2)
    sessions = []
    for streams in STREAM_COUNTS:
        sess = StreamingSession.create(context=STREAM_CONTEXT, height=h,
                                       width=w, streams=streams,
                                       device=DEVICE, **session_kw)
        frames = rng.integers(0, 256, (PUSHES, streams, h, w, 3),
                              dtype=np.uint8)
        ms = []
        for i in range(PUSHES):
            before, q1_before = launches(), q1_launches()
            probs, push_ms = timed_call(lambda: sess.push(frames[i]))
            ms.append(push_ms)
            count = launched_since(before)
            check(count == want, f"{label} push {i}: launches {count}, want "
                                 f"{want}")
            check_q1_paths(q1_before, want["qconv_bn"], "conv",
                           f"{label} push {i}")
            check_probs(probs, (streams,) if streams > 1 else (),
                        f"{label} push {i} streams={streams}")
        check(sess.frames_seen == PUSHES, f"frames_seen {sess.frames_seen}")
        print(f"[streaming] StreamingSession {label} causal "
              f"context={STREAM_CONTEXT} streams={streams}: launches per "
              f"push {want}; ms per push {[round(m, 3) for m in ms]} (first "
              f"warms up); median {float(np.median(ms[1:])):.3f} ms; {card}")
        sessions.append((sess, frames[-1]))
    return sessions


def breakdown(model, x_host: torch.Tensor, buffer=None) -> dict:
    """ms of the input transfer and normalisation, the backbone and the TCN
    of one forward (CUDA events, mean of 3 after a warm-up). The TCN runs
    over ``buffer`` when given (streaming), else over the backbone's
    features of ``x_host`` (offline, (B, T, H, W, 3))."""
    from computervision_codes_tpu_torch.serving import _to_model_input

    dev, dtype = next(model.parameters()).device, model.backbone.dtype
    with torch.inference_mode():
        x = _to_model_input(x_host, dev, dtype)
        frames = x.reshape(-1, *x.shape[-3:])
        seq = buffer if buffer is not None else model.backbone(frames)[
            "pooled"].reshape(*x.shape[:2], -1)
        parts = {}
        for name, fn in (
                ("input", lambda: _to_model_input(x_host, dev, dtype)),
                ("backbone", lambda: model.backbone(frames)),
                ("tcn", lambda: model.tcn(seq))):
            fn()
            parts[name] = round(cuda_ms(fn, 3), 3)
    return parts


def phase_breakdown(card: str, offline: dict, clips: np.ndarray,
                    streaming: dict) -> None:
    for label, sess in offline.items():
        print(f"[breakdown] {label}: ms per offline forward "
              f"{breakdown(sess.model, torch.from_numpy(clips))}; {card}")
    for label, sessions in streaming.items():
        for sess, frame in sessions:
            parts = breakdown(sess.model, torch.from_numpy(frame),
                              sess.buffer)
            print(f"[breakdown] {label}: ms per push, streams="
                  f"{sess.streams}: {parts}; {card}")


def attention_inputs(b, h, tq, tk, d, dtype, seed):
    """q (B, H, Tq, D), k and v (B, H, Tk, D), unit normal, made on the
    card from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(b, h, t, d, generator=g, device=DEVICE).to(dtype)
            for t in (tq, tk, tk)]


def attention_bound(b, h, tq, tk, d, dtype) -> dict:
    """K7's bound: the largest of its products at the tensor-core (bf16) or
    FMA (float32) peak, its exponentials at the SFU rate, and its bytes (q,
    k, v read once, the output written once)."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    es = 2 if kind == "bf16" else 4
    times = {"products": 4 * b * h * tq * tk * d / PEAK_OPS_S[kind],
             "exp": b * h * tq * tk / PEAK_EXP_S,
             "bytes": es * b * h * d * 2 * (tq + tk) / PEAK_BYTES_S}
    worst = max(times, key=times.get)
    return {"bound_ms": round(1e3 * times[worst], 6),
            "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_detail": f"{worst}: " + ", ".join(
                f"{k} {1e3 * v:.4f} ms" for k, v in times.items())}


def mstct_qkv(b, h, tq, tk, d, dtype, seed):
    """q, k, v as MS-TCT hands them to K7 (``models/mstct.py``
    GlobalRelationalBlock): (B, H, T, D) views of a (B, Tq, H D) query
    projection and of the two halves of one (B, Tk, 2 H D) key-value
    projection, unit normal, made on the card from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    c = h * d
    q = torch.randn(b, tq, c, generator=g, device=DEVICE).to(dtype)
    kv = torch.randn(b, tk, 2 * c, generator=g, device=DEVICE).to(dtype)
    k, v = kv.split(c, dim=-1)
    return [a.reshape(b, t, h, d).transpose(1, 2)
            for a, t in ((q, tq), (k, tk), (v, tk))]


class forced_plan:
    """Within the block, every forward of the current design takes `rows`
    query rows a block and, with `chunk`, splits the keys into runs of
    `chunk` (the checks and times that compare plans; no path runs it)."""

    def __init__(self, rows=None, chunk=None):
        self.rows, self.chunk = rows, chunk

    def __enter__(self):
        from computervision_codes_tpu_torch.ops import attention

        self.plan = plan = attention.attention_plan

        def forced(b, h, tq, tk, d, dtype, sms=attention.SMS):
            out = dict(plan(b, h, tq, tk, d, dtype, sms))
            if self.rows is not None:
                out["rows"] = self.rows
            if self.chunk is not None:
                out["chunk"] = self.chunk
                out["splits"] = -(-tk // self.chunk)
            return out
        attention.attention_plan = forced

    def __exit__(self, *exc):
        from computervision_codes_tpu_torch.ops import attention

        attention.attention_plan = self.plan


def attention_registers(library: str) -> dict:
    """ptxas' registers and spills of each kernel of an attention library,
    the current design's and the previous one's ("prev ..."), as
    "name<template arguments>"."""
    from computervision_codes_tpu_torch.ops import _build

    rows, current = {}, None
    for line in _build.build_logs.get(library, "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current, spill = m.group(1), ""
            continue
        if current is None:
            continue
        if "spill" in line:
            spill = re.sub(r"\s+", " ", line.strip())
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            parts, i = [], current.find("_ZN") + 3  # <len><name> pairs
            while 2 < i < len(current) and current[i].isdigit():
                n = int(re.match(r"\d+", current[i:]).group())
                i += len(str(n))
                parts.append(current[i:i + n])
                i += n
            name = parts[-1] if parts else current
            args = ", ".join(re.findall(r"Li(\d+)E", current))
            args += "bf16" if "bfloat16" in current else (
                "float" if "IfE" in current else "")
            args += ", fix" if "Lb1E" in current else ""
            prev = "prev " if parts and parts[0].endswith("_prev") else ""
            rows[f"{prev}{name}<{args}>"] = f"{regs} registers; {spill}"
            current = None
    return rows


def k7_tflops(b, h, tq, tk, d, ms) -> float:
    return 4 * b * h * tq * tk * d / ms / 1e9


def phase_k7(card: str) -> dict:
    """K7 in the current design against the plain version evaluated in
    float32 and rounded once, and against the plain version in the working
    dtype, at MS-TCT's shapes, on q, k and v laid out as MS-TCT passes them
    (views of its projections: TMA feeds the bf16 kernel) and contiguous
    (cp.async feeds it where TMA cannot: rows of 216 bytes); the split
    merge at T = 1000 (the plan splits) and forced at the ragged shapes;
    each head's output unchanged by non-finite neighbouring heads and
    videos; the outputs that differ from the previous design's counted;
    then, in
    turns, the current design, the previous one, the plain version and SDPA
    (the yardstick) at (1, 8, 8192, D) for each head dim, at D = 108 over
    the eval lengths and the training window, beside the bound; one
    consumer warpgroup (64 rows) against two (128) at (1, 8, 8192, D)."""
    from computervision_codes_tpu_torch.ops.attention import (
        attention_cuda, attention_plan, attention_prev_cuda,
        attention_reference)

    shapes = [(1, 8, t, t, d) for t in K7_LENGTHS for d in K7_DIMS]
    shapes += [K7_WINDOW[:2] + (K7_WINDOW[2],) * 2 + (d,) for d in K7_DIMS]
    shapes += [K7_RAGGED + (d,) for d in (27, 108)]
    cases = [(shape, "mstct", None) for shape in shapes]
    cases += [(shape, "contiguous", None) for shape in shapes
              if shape[2] == K7_LENGTHS[0] or shape[2] == K7_WINDOW[2]]
    cases += [(K7_RAGGED + (d,), layout, 256) for d in (27, 108)
              for layout in ("mstct", "contiguous")]
    main_err, differs, splits = 0.0, {}, set()
    for dtype in (torch.bfloat16, torch.float32):
        worst, worst_plain = (-1.0, None), (-1.0, None)
        for seed, (shape, layout, chunk) in enumerate(cases):
            b, h, tq, tk, d = shape
            make = mstct_qkv if layout == "mstct" else attention_inputs
            q, k, v = make(b, h, tq, tk, d, dtype, seed)
            with forced_plan(chunk=chunk):
                got = attention_cuda(q, k, v)
                plan = attention_plan(b, h, tq, tk, d, dtype)
            if plan["splits"] > 1 or chunk:
                splits.add((str(dtype)[6:], shape, layout,
                            chunk or plan["chunk"]))
            want = attention_reference(q.float(), k.float(), v.float()).to(
                dtype).float()
            tag = (f"K7 {str(dtype)[6:]} {layout} (B, H, Tq, Tk, D) = "
                   f"{shape}" + (f" split every {chunk} keys" if chunk
                                 else ""))
            check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
            top = want.abs().max().item()
            err = (got.float() - want).abs().max().item()
            tol = float(K7_BF16_ULPS * bf16_ulp(top)
                        if dtype == torch.bfloat16 else K7_F32_REL * top)
            check(err <= tol, f"{tag}: max_abs_err {err} > tol {tol} "
                              f"(max|ref| {top})")
            if err / tol >= worst[0]:
                worst = (err / tol, (layout, shape, err, tol))
            if dtype == torch.bfloat16:
                plain = attention_reference(q, k, v).float()
                perr = (got.float() - plain).abs().max().item()
                ptol = float(K7_PLAIN_BF16_ULPS * bf16_ulp(top))
                check(perr <= ptol, f"{tag} vs the bf16 plain version: "
                                    f"max_abs_err {perr} > tol {ptol}")
                if perr / ptol >= worst_plain[0]:
                    worst_plain = (perr / ptol, (layout, shape, perr, ptol))
                if (b, h) == (1, 8) and tq == tk:
                    main_err = max(main_err, err)
            if chunk is None:
                differs[f"{str(dtype)[6:]} {layout} {shape}"] = new_vs_old(
                    got, attention_prev_cuda(q, k, v))
            del q, k, v, got, want
        print(f"[kernels] K7 {str(dtype)[6:]}: {len(cases)} cases within "
              f"tolerance of the float32 plain version rounded once ("
              + (f"{K7_BF16_ULPS} bf16 ulps of" if dtype == torch.bfloat16
                 else f"{K7_F32_REL:g} x") + f" max|ref|); worst "
              f"(layout, (B, H, Tq, Tk, D), err, tol) = {worst[1]}")
        if dtype == torch.bfloat16:
            print(f"[kernels] K7 bf16 against the bf16 plain version: "
                  f"within {K7_PLAIN_BF16_ULPS} ulps of max|ref|; worst "
                  f"{worst_plain[1]}")
    print(f"[kernels] K7 split over keys and merged through the lse "
          f"(dtype, shape, layout, keys a split): {sorted(splits)}")
    # each (b, h) reads its own columns and rows only: non-finite heads 1
    # and 2 of video 0 and a non-finite video 1 leave video 0's other heads
    # bit for bit as they were (a box of a TMA view reaching into
    # a neighbouring head's columns or the next video's rows would turn
    # them NaN: 0 x inf)
    b, h, tq, tk = K7_RAGGED
    isolated = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in K7_DIMS:
            for layout in ("mstct", "contiguous"):
                make = mstct_qkv if layout == "mstct" else attention_inputs
                q, k, v = make(b, h, tq, tk, d, dtype, 7)
                base = attention_cuda(q, k, v)
                for a, x in ((q, float("nan")), (k, float("inf")),
                             (v, float("nan"))):
                    a[0, 1:3] = x
                    a[1] = x
                got = attention_cuda(q, k, v)
                keep = [0] + list(range(3, h))
                check(torch.equal(got[0, keep], base[0, keep]),
                      f"K7 {str(dtype)[6:]} {layout} D = {d}: a non-finite "
                      f"head or video changed another head's output")
                isolated += 1
                del q, k, v, base, got
    print(f"[kernels] K7 heads and videos independent: {isolated} cases "
          f"(bf16 and float32, D in {K7_DIMS}, MS-TCT's views and "
          f"contiguous, (B, H, Tq, Tk) = {K7_RAGGED}) bit for bit with "
          f"non-finite neighbours")
    print(f"[kernels] K7 against the previous design (outputs that differ, "
          f"the largest difference): {differs}")

    times = {}
    timed = ([(1, 8, K7_TIME_T, K7_TIME_T, d) for d in K7_DIMS]
             + [(1, 8, t, t, K7_DIMS[-1]) for t in K7_LENGTHS]
             + [K7_WINDOW[:2] + (K7_WINDOW[2],) * 2 + (K7_DIMS[-1],)])
    for dtype in (torch.bfloat16, torch.float32):
        for shape in timed:
            q, k, v = mstct_qkv(*shape, dtype, 99)
            fns = {"kernel": lambda: attention_cuda(q, k, v),
                   "prev": lambda: attention_prev_cuda(q, k, v),
                   "plain": lambda: attention_reference(q, k, v),
                   "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)}
            reps = {"kernel": 10, "prev": 10, "plain": 3, "sdpa": 10}
            if dtype == torch.bfloat16 and shape[2] == K7_TIME_T:
                for rows in (64, 128):
                    def forced(rows=rows):
                        with forced_plan(rows=rows):
                            return attention_cuda(q, k, v)
                    fns[f"rows{rows}"], reps[f"rows{rows}"] = forced, 10
            ms, runs = in_turns(fns, reps)
            bnd = attention_bound(*shape, dtype)
            times[dtype, shape] = ms | bnd
            tf = {key: k7_tflops(*shape, ms[key]) for key in ms}
            print(f"[kernels] K7 time {str(dtype)[6:]} {shape}: kernel "
                  f"{ms['kernel']:.4f} ms ({tf['kernel']:.1f} TFLOP/s), "
                  f"previous design {ms['prev']:.4f} ms "
                  f"({tf['prev']:.1f}), plain {ms['plain']:.4f} ms, SDPA "
                  f"{ms['sdpa']:.4f} ms ({tf['sdpa']:.1f}), bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_detail']})"
                  + (f"; 64 rows a block {ms['rows64']:.4f} ms, 128 "
                     f"{ms['rows128']:.4f} ms" if "rows64" in ms else "")
                  + f"; runs {runs}; {card}")
            del q, k, v
    long_ = [(1, 8, K7_TIME_T, K7_TIME_T, d) for d in K7_DIMS]
    forward = {dt: {key: sum(2 * times[dt, sh][key] for sh in long_)
                    for key in ("kernel", "prev", "plain", "sdpa",
                                "bound_ms")}
               for dt in (torch.bfloat16, torch.float32)}
    for dt, sums in forward.items():
        print(f"[kernels] K7 {str(dt)[6:]}, the 8 launches of one MS-TCT "
              f"forward at T = {K7_TIME_T} (2 per head dim): kernel "
              f"{sums['kernel']:.4f} ms, previous design "
              f"{sums['prev']:.4f} ms, plain {sums['plain']:.4f} ms, SDPA "
              f"{sums['sdpa']:.4f} ms, bound {sums['bound_ms']:.4f} ms; "
              f"{card}")

    def reading(dt, shape):
        r = times[dt, shape]
        return {"ms": r["kernel"], "prev_ms": r["prev"],
                "plain_ms": r["plain"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["sdpa"],
                "tflops": round(k7_tflops(*shape, r["kernel"]), 1)}
    # the entry's numbers are bf16 at (1, 8, 8192, 108); "float32" holds
    # the float32 ones at the same shape (the driver's default dtype)
    main = long_[-1]
    return {"max_abs_err": main_err, **reading(torch.bfloat16, main),
            "shape": list(main),
            "float32": reading(torch.float32, main),
            "by_shape": {f"{str(dt)[6:]} {sh}": reading(dt, sh)
                         for dt, sh in times},
            "rows_64_vs_128_ms": {
                f"D={sh[-1]}": [times[torch.bfloat16, sh]["rows64"],
                                times[torch.bfloat16, sh]["rows128"]]
                for sh in long_},
            "differ_from_prev": {k: dict(zip(("outputs", "largest"), v))
                                 for k, v in differs.items()},
            "registers": attention_registers("attention")}


# per K8 kernel: (products x B H Tq Tk D operations, exponentials per
# score, (Tq rows, Tk rows) of D elements moved, float32 values per query
# row moved). The forward reads q, k, v and writes out and lse; dQ reads q,
# dO, k, v, lse and dvec and writes dq; dK/dV reads k, v, q, dO, lse and
# dvec and writes dk and dv.
FLASH_WORK = {"fwd": (4, 1, (2, 2), 1), "dq": (6, 1, (3, 2), 2),
              "dkv": (8, 1, (2, 4), 2)}


def flash_bound(b, h, tq, tk, d, dtype, kernels) -> dict:
    """The bound of the K8 ``kernels`` run one after another: their
    operations at the tensor-core (bf16) or FMA (float32) peak, their
    exponentials at the SFU rate, or the bytes each reads once and writes
    once, whichever total is longest."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    es = 2 if kind == "bf16" else 4
    products = exps = nbytes = 0
    for kern in kernels:
        n_prod, n_exp, (q_rows, k_rows), lse_vals = FLASH_WORK[kern]
        products += n_prod
        exps += n_exp
        nbytes += b * h * ((q_rows * tq + k_rows * tk) * d * es
                           + lse_vals * tq * 4)
    times = {"products": products * b * h * tq * tk * d / PEAK_OPS_S[kind],
             "exp": exps * b * h * tq * tk / PEAK_EXP_S,
             "bytes": nbytes / PEAK_BYTES_S}
    worst = max(times, key=times.get)
    return {"bound_ms": round(1e3 * times[worst], 6),
            "bound_by": "bytes" if worst == "bytes" else "operations"}


def flash_case(b, h, tq, tk, d, dtype, seed):
    """q, k, v and a cotangent g on the card; the kernels' forward (out,
    lse) and backward (dq, dk, dv) with dvec = rowsum(g * out) as the
    entry point computes it."""
    from computervision_codes_tpu_torch.ops import attention as A

    q, k, v = attention_inputs(b, h, tq, tk, d, dtype, seed)
    g = attention_inputs(b, h, tq, 1, d, dtype, seed + 1000)[0]
    out, lse = A.flash_attention_fwd_cuda(q, k, v)
    dvec = (g.float() * out.float()).sum(-1)
    dq = A.flash_attention_dq_cuda(q, k, v, g, lse, dvec)
    dk, dv = A.flash_attention_dkv_cuda(q, k, v, g, lse, dvec)
    return (q, k, v, g), (out, lse, dvec), (dq, dk, dv)


def phase_k8(card: str) -> dict:
    """K8: the forward (out and lse, and without lse) and the dQ and dK/dV
    kernels against the plain versions in float32 (the kernels' outputs
    rounded once), bf16 and float32, at K8_CHECK; the autograd Function
    against autograd of attention_reference in float32; then, in turns,
    the forward's and the backward kernels' times beside the plain
    versions', SDPA's forward and forward + backward (the yardstick) and
    the bounds. Returns the three kernels' entries."""
    from computervision_codes_tpu_torch.ops import attention as A

    worst = {}  # (dtype, what) -> (err / tol, case, err, tol)
    err_max = {}  # (dtype, kernel) -> the largest absolute error
    differs = {}  # "dtype case" -> output -> (differ, largest)
    for dtype in (torch.bfloat16, torch.float32):
        for seed, (b, h, tq, tk, d) in enumerate(K8_CHECK):
            (q, k, v, g), (out, lse, dvec), grads = flash_case(
                b, h, tq, tk, d, dtype, seed)
            bare, none = A.flash_attention_fwd_cuda(q, k, v, with_lse=False)
            # the previous design on the same inputs (its dQ and dK/dV on
            # the current forward's lse and dvec)
            old = (*A.flash_attention_fwd_prev_cuda(q, k, v),
                   A.flash_attention_dq_prev_cuda(q, k, v, g, lse, dvec),
                   *A.flash_attention_dkv_prev_cuda(q, k, v, g, lse, dvec))
            torch.cuda.synchronize()
            case = (b, h, tq, tk, d)
            differs[f"{str(dtype)[6:]} {case}"] = {
                name: new_vs_old(new, o) for name, new, o in zip(
                    ("out", "lse", "dq", "dk", "dv"), (out, lse, *grads),
                    old)}
            tag = f"K8 {str(dtype)[6:]} (B, H, Tq, Tk, D) = {case}"
            check(none is None and torch.equal(bare, out),
                  f"{tag}: the forward without lse differs")
            qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
            ref_out, ref_lse = A.flash_attention_reference_fwd(qf, kf, vf)
            ref_grads = A.flash_attention_reference_bwd(
                qf, kf, vf, out.float(), ref_lse, gf)
            pairs = [("fwd", "out", out, ref_out.to(dtype).float(),
                      K8_BF16_ULPS)]
            pairs += [(kernel, name, got, ref.to(dtype).float(),
                       K8_BF16_GRAD_ULPS)
                      for kernel, name, got, ref in zip(
                          ("dq", "dkv", "dkv"), ("dq", "dk", "dv"), grads,
                          ref_grads)]
            for kernel, name, got, ref, ulps in pairs:
                check(got.shape == ref.shape and bool(
                    torch.isfinite(got).all()), f"{tag} {name}: shape "
                                                f"{tuple(got.shape)} or "
                                                f"non-finite")
                top = ref.abs().max().item()
                err = (got.float() - ref).abs().max().item()
                tol = float(ulps * bf16_ulp(top) if dtype == torch.bfloat16
                            else K8_F32_REL * top)
                check(err <= tol, f"{tag} {name}: max_abs_err {err} > tol "
                                  f"{tol} (max|ref| {top})")
                key = (dtype, name)
                if err / tol >= worst.get(key, (-1.0,))[0]:
                    worst[key] = (err / tol, case, err, tol)
                err_max[dtype, kernel] = max(err_max.get((dtype, kernel),
                                                         0.0), err)
            lerr, ltol = (lse - ref_lse).abs().max().item(), K8_LSE_ATOL[dtype]
            check(lerr <= ltol, f"{tag} lse: max_abs_err {lerr} > {ltol}")
            if lerr / ltol >= worst.get((dtype, "lse"), (-1.0,))[0]:
                worst[dtype, "lse"] = (lerr / ltol, case, lerr, ltol)
            del q, k, v, g, out, lse, grads, ref_out, ref_grads, bare, old
        print(f"[kernels] K8 {str(dtype)[6:]}: {len(K8_CHECK)} cases within "
              f"tolerance of the float32 plain versions rounded once; worst "
              f"(err / tol, (B, H, Tq, Tk, D), err, tol) by output: "
              + "; ".join(f"{name} {worst[dtype, name]}"
                          for name in ("out", "lse", "dq", "dk", "dv")))
    print(f"[kernels] K8 against the previous design (outputs that differ, "
          f"the largest difference): {differs}")
    for seed, (b, h, tq, tk, d) in enumerate(
            [(1, 8, 1000, 1000, 108), K8_RAGGED]):
        leaves = [t.requires_grad_() for t in attention_inputs(
            b, h, tq, tk, d, torch.float32, 50 + seed)]
        torch.sin(A.flash_attention(*leaves)).sum().backward()
        got = [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        torch.sin(A.attention_reference(*leaves)).sum().backward()
        for name, a, t in zip(("dq", "dk", "dv"), got, leaves):
            err = (a - t.grad).abs().max().item()
            tol = K8_AUTOGRAD_REL * t.grad.abs().max().item()
            check(err <= tol, f"K8 autograd {(b, h, tq, tk, d)} {name} vs "
                              f"autograd of attention_reference: {err} > "
                              f"{tol}")
        print(f"[kernels] K8 float32 flash_attention (the autograd Function "
              f"on the kernels) at {(b, h, tq, tk, d)}: gradients within "
              f"{K8_AUTOGRAD_REL:g} x max|ref| of autograd of "
              f"attention_reference on the card")
        del leaves, got

    times = {}
    shapes = ([(1, 8, K8_VIDEO_T, K8_VIDEO_T, d) for d in K7_DIMS]
              + [K7_WINDOW[:2] + (K7_WINDOW[2],) * 2 + (d,) for d in K7_DIMS]
              + [(1, 8, K7_TIME_T, K7_TIME_T, d) for d in K7_DIMS]
              + [K8_RAGGED])
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            b, h, tq, tk, d = shape
            (q, k, v, g), (out, lse, dvec), _ = flash_case(
                b, h, tq, tk, d, dtype, 77)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(*leaves)
                o.backward(g)

            ms, runs = in_turns(
                {"fwd": lambda: A.flash_attention_fwd_cuda(q, k, v),
                 "dq": lambda: A.flash_attention_dq_cuda(q, k, v, g, lse,
                                                         dvec),
                 "dkv": lambda: A.flash_attention_dkv_cuda(q, k, v, g, lse,
                                                           dvec),
                 "fwd_prev": lambda: A.flash_attention_fwd_prev_cuda(
                     q, k, v),
                 "dq_prev": lambda: A.flash_attention_dq_prev_cuda(
                     q, k, v, g, lse, dvec),
                 "dkv_prev": lambda: A.flash_attention_dkv_prev_cuda(
                     q, k, v, g, lse, dvec),
                 "plain_fwd": lambda: A.flash_attention_reference_fwd(
                     q, k, v),
                 "plain_bwd": lambda: A.flash_attention_reference_bwd(
                     q, k, v, out, lse, g),
                 "sdpa_fwd": lambda: F.scaled_dot_product_attention(q, k, v),
                 "sdpa_fwd_bwd": sdpa_fwd_bwd},
                {"fwd": 5, "dq": 5, "dkv": 5, "fwd_prev": 5, "dq_prev": 5,
                 "dkv_prev": 5, "plain_fwd": 2, "plain_bwd": 2,
                 "sdpa_fwd": 5, "sdpa_fwd_bwd": 5})
            bounds = {kern: flash_bound(*shape, dtype, [kern])
                      for kern in FLASH_WORK}
            bounds["bwd"] = flash_bound(*shape, dtype, ["dq", "dkv"])
            times[dtype, shape] = (ms, bounds)
            print(f"[kernels] K8 time {str(dtype)[6:]} (B, H, Tq, Tk, D) = "
                  f"{shape}: forward {ms['fwd']:.4f} ms (bound "
                  f"{bounds['fwd']['bound_ms']:.4f}), backward dQ + dK/dV "
                  f"{ms['dq']:.4f} + {ms['dkv']:.4f} = "
                  f"{ms['dq'] + ms['dkv']:.4f} ms (bound "
                  f"{bounds['bwd']['bound_ms']:.4f}); previous design "
                  f"{ms['fwd_prev']:.4f}, {ms['dq_prev']:.4f} + "
                  f"{ms['dkv_prev']:.4f} ms; plain forward "
                  f"{ms['plain_fwd']:.4f}, backward {ms['plain_bwd']:.4f} "
                  f"ms; SDPA forward {ms['sdpa_fwd']:.4f}, forward + "
                  f"backward {ms['sdpa_fwd_bwd']:.4f} ms; runs {runs}; "
                  f"{card}")
            del q, k, v, g, out, lse, dvec, leaves

    def entry(dtype, shape):
        ms, bounds = times[dtype, shape]
        plain = {"fwd": ms["plain_fwd"], "dq": ms["plain_bwd"],
                 "dkv": ms["plain_bwd"]}
        library = {"fwd": ms["sdpa_fwd"], "dq": None, "dkv": None}
        return {kern: {"ms": ms[kern], "prev_ms": ms[f"{kern}_prev"],
                       "plain_ms": plain[kern], **bounds[kern],
                       "library_ms": library[kern]}
                for kern in ("fwd", "dq", "dkv")} | {
            "sdpa_fwd_bwd_ms": ms["sdpa_fwd_bwd"]}

    # the entries: bf16 at (1, 8, 8192, 108), as K7's; float32 and the
    # training window beside them
    main = (1, 8, K7_TIME_T, K7_TIME_T, K7_DIMS[-1])
    window = K7_WINDOW[:2] + (K7_WINDOW[2],) * 2 + (K7_DIMS[-1],)
    readings = {"bf16": entry(torch.bfloat16, main),
                "float32": entry(torch.float32, main),
                "window": entry(torch.bfloat16, window)}
    out = {}
    for kern in ("fwd", "dq", "dkv"):
        out[f"flash_attention_{kern}"] = {
            "max_abs_err": err_max[torch.bfloat16, kern],
            **readings["bf16"][kern], "shape": list(main),
            "float32": readings["float32"][kern],
            "float32_max_abs_err": err_max[torch.float32, kern],
            "training_window": {"shape": list(window),
                                **readings["window"][kern]}}
        if kern != "fwd":
            out[f"flash_attention_{kern}"]["plain_covers"] = (
                "dq, dk and dv (flash_attention_reference_bwd)")
            out[f"flash_attention_{kern}"]["sdpa_fwd_bwd_ms"] = (
                readings["bf16"]["sdpa_fwd_bwd_ms"])
    out["flash_attention_fwd"]["differ_from_prev"] = {
        case: {name: dict(zip(("outputs", "largest"), v))
               for name, v in d.items()} for case, d in differs.items()}
    out["flash_attention_dq"]["registers"] = attention_registers(
        "flash_attention")
    return out


def phase_k8_path(card: str) -> None:
    """The K8 op path, as a user calls it: ``flash_attention`` forward and
    backward (a loss of sin of the output) at the training window for each
    of MS-TCT's head dims, and ``flash_attention_pallas`` over a whole
    video, bf16; the launches, finite gradients and outputs, ms of each."""
    from computervision_codes_tpu_torch.ops import (flash_attention,
                                                    flash_attention_pallas)

    before = launches()
    ms = {}
    for seed, d in enumerate(K7_DIMS):
        b, h, t = K7_WINDOW
        leaves = [x.requires_grad_() for x in attention_inputs(
            b, h, t, t, d, torch.bfloat16, 60 + seed)]

        def train():
            torch.sin(flash_attention(*leaves).float()).sum().backward()

        _, ms[f"flash_attention fwd+bwd {(b, h, t, d)}"] = timed_call(train)
        for x in leaves:
            check(x.grad is not None and bool(torch.isfinite(x.grad).all()),
                  f"K8 path D={d}: gradient missing or non-finite")
        q, k, v = attention_inputs(1, 8, K8_PATH_T, K8_PATH_T, d,
                                   torch.bfloat16, 70 + seed)
        out, ms[f"flash_attention_pallas {(1, 8, K8_PATH_T, d)}"] = (
            timed_call(lambda: flash_attention_pallas(q, k, v)))
        check(bool(torch.isfinite(out).all()), f"K8 path D={d}: "
                                               f"non-finite output")
        del leaves, q, k, v, out
    count = launched_since(before)
    want = dict.fromkeys(KERNELS, 0) | K8_PATH_LAUNCHES
    check(count == want, f"K8 path launches {count}, want {want}")
    print(f"[k8 path] launches {K8_PATH_LAUNCHES}; ms (CUDA events, the "
          f"first call of each shape): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"; {card}")


def tresnet_k9_launches(width: int, layers, img: int) -> list:
    """(map side, C, slope) of each K9 launch of one TResNet forward at
    img x img, in order: the stem's ABN, then each activated ABN, at the
    side its block's input has (a stride-2 block blurs after them)."""
    side = img // 4
    out = [(side, width, 1e-2)]
    for si, depth in enumerate(layers):
        filters = width * 2 ** si
        for bi in range(depth):
            out += [(side, filters, 1e-3)] * (1 if si < 2 else 2)
            if si > 0 and bi == 0:
                side = (side + 1) // 2
    return out


def k9_inputs(shape, dtype, seed):
    """x of ``shape`` in ``dtype`` and float32 scale and bias like folded
    BatchNorm constants, made on the card from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, generator=g, device=DEVICE).to(dtype)
    scale = 0.5 + torch.rand(c, generator=g, device=DEVICE)
    bias = 0.5 * torch.randn(c, generator=g, device=DEVICE)
    return x, scale, bias


def k9_compare(tag: str, got, x, scale, bias, slope, dtype) -> tuple:
    """K9's output against the plain version evaluated in float32 from the
    constants rounded to x's dtype (as the wrapper rounds them), rounded
    once; returns (err, tol, elements that differ, err against the plain
    version op for op in x's dtype)."""
    from computervision_codes_tpu_torch.ops.fused_norm import (
        fused_scale_bias_act_reference)

    s, b = scale.to(dtype), bias.to(dtype)
    want = fused_scale_bias_act_reference(x.float(), s.float(), b.float(),
                                          slope).to(dtype)
    check(got.shape == want.shape and got.stride() == x.stride(),
          f"{tag}: shape {tuple(got.shape)} strides {got.stride()}")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    top = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    tol = (K9_F32_REL * top if dtype == torch.float32
           else K9_BF16_ULPS * bf16_ulp(top))
    check(err <= tol, f"{tag}: max_abs_err {err} > tol {tol}")
    plain = fused_scale_bias_act_reference(x, s, b, slope)
    perr = (got.float() - plain.float()).abs().max().item()
    return err, tol, int((got != want).sum().item()), perr


def phase_k9(card: str) -> dict:
    """K9 at each distinct TResNet-L-448 shape of path A (B = 16) at both
    slopes, at ragged shapes, on a misaligned view and on a channels_last
    map viewed as NHWC (what the ABN passes), in bf16 and float32; then its
    time at each shape beside the plain version and the bound, and their
    sums over the 52 launches of one predict."""
    from computervision_codes_tpu_torch.models.tresnet import VARIANTS
    from computervision_codes_tpu_torch.ops.fused_norm import (
        fused_scale_bias_act_cuda, fused_scale_bias_act_reference)

    cfg = VARIANTS[TRESNET]
    per_forward = tresnet_k9_launches(cfg["width"], cfg["layers"],
                                      TRESNET_IMG)
    check(len(per_forward) == TRESNET_LAUNCHES["fused_scale_bias_act"],
          f"K9 launches per TResNet forward {len(per_forward)}")
    shapes = sorted({(side, c) for side, c, _ in per_forward},
                    key=lambda sc: (-sc[0], sc[1]))
    b = TRESNET_BATCH
    cases = ([((b, side, side, c), slope) for side, c in shapes
              for slope in (1e-2, 1e-3)]
             + [(shape, 1e-3) for shape in K9_RAGGED])
    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst, exact, worst_plain = (-1.0, None), 0, 0.0
        for seed, (shape, slope) in enumerate(cases):
            x, scale, bias = k9_inputs(shape, dtype, seed)
            tag = f"K9 {str(dtype)[6:]} {shape} slope {slope:g}"
            err, tol, diff, perr = k9_compare(
                tag, fused_scale_bias_act_cuda(x, scale, bias, slope), x,
                scale, bias, slope, dtype)
            exact += diff == 0
            worst_plain = max(worst_plain, perr)
            if err / max(tol, 1e-30) >= worst[0]:
                worst = (err / max(tol, 1e-30), (shape, slope, err, tol))
            if dtype == torch.bfloat16 and shape[0] == b:
                main_err = max(main_err, err)
            del x
        # a view at an odd offset (one-element loads) and a channels_last
        # NCHW map viewed as NHWC, as TResNet's ABN passes it
        odd = k9_inputs((1 + 2 * 9 * 7 * 76,), dtype, 90)[0][1:].view(
            2, 9, 7, 76)
        cl = k9_inputs((b, 152, 28, 28), dtype, 91)[0].contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for what, x in (("odd offset", odd), ("channels_last", cl)):
            sc, bi = k9_inputs((x.shape[-1],), torch.float32, 92)[1:]
            err, tol, diff, _ = k9_compare(
                f"K9 {str(dtype)[6:]} {what}",
                fused_scale_bias_act_cuda(x, sc, bi, 1e-3), x, sc, bi, 1e-3,
                dtype)
            exact += diff == 0
        try:
            fused_scale_bias_act_cuda(cl[..., ::2], sc[:76], bi[:76])
        except ValueError:
            pass
        else:
            fail("K9 took a strided view it cannot read without a copy")
        print(f"[kernels] K9 {str(dtype)[6:]}: {len(cases) + 2} cases within "
              f"tolerance of the float32 plain version rounded once ("
              + (f"{K9_BF16_ULPS} bf16 ulp of" if dtype == torch.bfloat16
                 else f"{K9_F32_REL:g} x") + f" max|ref|), {exact} of them "
              f"bit for bit; worst ((shape, slope, err, tol)) = {worst[1]}; "
              f"against the plain version op for op in "
              f"{str(dtype)[6:]}: max_abs_err {worst_plain:.3e}; a strided "
              f"view raises ValueError")

    # device time per call from torch.profiler (below ~40 us a call is
    # bound by the wrappers' host work, which CUDA events around the calls
    # measure), and the time per call from CUDA events, in turns
    es = 2
    times = {}
    for side, c in shapes:
        x, scale, bias = k9_inputs((b, side, side, c), torch.bfloat16, 99)
        s, bb = scale.bfloat16(), bias.bfloat16()
        fns = {"kernel": lambda: fused_scale_bias_act_cuda(x, s, bb, 1e-3),
               "plain": lambda: fused_scale_bias_act_reference(x, s, bb,
                                                               1e-3)}
        call, runs = in_turns(fns, {"kernel": 50, "plain": 20})
        dev = {k: device_ms(fn, 20) for k, fn in fns.items()}
        n = x.numel()
        bnd = bound(3 * n, es * (2 * n + 2 * c), "f32")
        times[side, c] = dev | bnd
        print(f"[kernels] K9 time bf16 ({b}, {side}, {side}, {c}): device "
              f"time kernel {dev['kernel']:.4f} ms "
              f"({2 * es * n / max(dev['kernel'], 1e-9) / 1e6:.1f} GB/s), "
              f"plain "
              f"{dev['plain']:.4f} ms (profiler); per call kernel "
              f"{call['kernel']:.4f} ms, plain {call['plain']:.4f} ms (CUDA "
              f"events, in turns, runs {runs}); bound {bnd['bound_ms']:.4f} "
              f"ms ({bnd['bound_by']}); {card}")
        del x
    predict = {key: sum(times[side, c][key] for side, c, _ in per_forward)
               for key in ("kernel", "plain", "bound_ms")}
    print(f"[kernels] K9 bf16, the {len(per_forward)} launches of one "
          f"{TRESNET}-{TRESNET_IMG} forward at B = {b}, device time: kernel "
          f"{predict['kernel']:.4f} ms, plain {predict['plain']:.4f} ms, "
          f"bound {predict['bound_ms']:.4f} ms (each shape timed alone, warm "
          f"L2 below 50 MB); {card}")
    largest = max(shapes, key=lambda sc: sc[0] ** 2 * sc[1])
    t = times[largest]
    return {"max_abs_err": main_err, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": [b, largest[0], largest[0], largest[1]],
            "predict_ms": round(predict["kernel"], 4),
            "predict_plain_ms": round(predict["plain"], 4),
            "predict_bound_ms": round(predict["bound_ms"], 6)}


def k10_inputs(bw, heads, n, dtype, seed):
    """q, k, v (BW, heads, N, 32) as Swin's WindowAttention cuts them from
    one qkv tensor (BW, N, 3, heads, 32), and a unit-normal bias (heads, N,
    N), made on the card from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    qkv = torch.randn(bw, n, 3, heads, 32, generator=g, device=DEVICE).to(
        dtype).permute(2, 0, 3, 1, 4)
    bias = torch.randn(heads, n, n, generator=g, device=DEVICE).to(dtype)
    return qkv[0], qkv[1], qkv[2], bias


def k10_bound(bw, heads, n, nw, masked: bool, dtype) -> dict:
    """K10's bound: the largest of its products at the tensor-core (bf16) or
    FMA (float32) peak, its exponentials at the SFU rate, and its bytes (q,
    k, v, bias and mask read once, the output written once)."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    es = 2 if kind == "bf16" else 4
    times = {"products": 4 * bw * heads * n * n * 32 / PEAK_OPS_S[kind],
             "exp": bw * heads * n * n / PEAK_EXP_S,
             "bytes": es * (4 * bw * heads * n * 32 + heads * n * n
                            + masked * nw * n * n) / PEAK_BYTES_S}
    worst = max(times, key=times.get)
    return {"bound_ms": round(1e3 * times[worst], 6),
            "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_detail": f"{worst}: " + ", ".join(
                f"{k} {1e3 * v:.4f} ms" for k, v in times.items())}


def phase_k10(card: str) -> dict:
    """K10 against the plain version in float32 rounded once and the plain
    version in the working dtype, through both TPU entry points, at
    Swin-L-384's four stage shapes (shifted and not), Swin-L-224's window-7
    stage 0 and ragged masks; then its time at the stage shapes beside the
    plain version, SDPA (the yardstick only) and the bound, and their sums
    over the 24 launches of one Swin-L-384 forward."""
    from computervision_codes_tpu_torch.models.swin import shift_mask
    from computervision_codes_tpu_torch.ops.window_attention import (
        window_attention_pallas, window_attention_pallas_multi,
        window_attention_reference)

    cases = []
    for what, b, side, heads, w, _ in K10_CASES:
        nw = (side // w) ** 2
        for shift in (0, w // 2):
            mask = (shift_mask(side, side, w, shift, DEVICE, torch.float32)
                    if shift else None)
            cases.append((f"{what} shift={shift}", b * nw, heads, w * w,
                          nw, mask))
    for what, bw, heads, n, nw in K10_RAGGED:
        g = torch.Generator(device=DEVICE).manual_seed(bw)
        mask = None if nw == 1 else -100.0 * (torch.rand(
            nw, n, n, generator=g, device=DEVICE) < 0.3).float()
        cases.append((what, bw, heads, n, nw, mask))
    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst, worst_plain = (-1.0, None), (-1.0, None)
        for seed, (what, bw, heads, n, nw, mask) in enumerate(cases):
            q, k, v, bias = k10_inputs(bw, heads, n, dtype, seed)
            entry = (window_attention_pallas_multi if seed % 2 == 0
                     else window_attention_pallas)
            got = entry(q, k, v, bias, mask, nw)
            m32 = None if mask is None else mask.to(dtype).float()
            want = window_attention_reference(
                q.float(), k.float(), v.float(), bias.float(), m32, nw).to(
                    dtype).float()
            tag = f"K10 {str(dtype)[6:]} {what}"
            check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)}")
            check(got.transpose(1, 2).is_contiguous(),
                  f"{tag}: output memory is not (BW, N, H, D)")
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
            top = want.abs().max().item()
            err = (got.float() - want).abs().max().item()
            tol = float(K10_BF16_ULPS * bf16_ulp(top)
                        if dtype == torch.bfloat16 else K10_F32_REL * top)
            check(err <= tol, f"{tag}: max_abs_err {err} > tol {tol}")
            if err / tol >= worst[0]:
                worst = (err / tol, (what, err, tol))
            if dtype == torch.bfloat16:
                plain = window_attention_reference(q, k, v, bias, mask,
                                                   nw).float()
                perr = (got.float() - plain).abs().max().item()
                ptol = float(K10_PLAIN_BF16_ULPS * bf16_ulp(top))
                check(perr <= ptol, f"{tag} vs the bf16 plain version: "
                                    f"max_abs_err {perr} > tol {ptol}")
                if perr / ptol >= worst_plain[0]:
                    worst_plain = (perr / ptol, (what, perr, ptol))
                if what.startswith("SwinL-384"):
                    main_err = max(main_err, err)
            del q, k, v, got, want
        print(f"[kernels] K10 {str(dtype)[6:]}: {len(cases)} cases within "
              f"tolerance of the float32 plain version rounded once ("
              + (f"{K10_BF16_ULPS} bf16 ulps of" if dtype == torch.bfloat16
                 else f"{K10_F32_REL:g} x") + f" max|ref|), half through "
              f"each TPU entry point; worst (case, err, tol) = {worst[1]}")
        if dtype == torch.bfloat16:
            print(f"[kernels] K10 bf16 against the bf16 plain version: "
                  f"within {K10_PLAIN_BF16_ULPS} ulps of max|ref|; worst "
                  f"{worst_plain[1]}")

    # times at the four stage shapes in bf16, shifted at stages 0-2 (the
    # mask in bf16, as the model passes it), beside the plain version and
    # SDPA over the same inputs with bias + mask as one (BW, H, N, N) mask
    times = {}
    for what, b, side, heads, w, blocks in K10_CASES[:4]:
        nw, n = (side // w) ** 2, w * w
        bw = b * nw
        mask = (shift_mask(side, side, w, w // 2, DEVICE, torch.bfloat16)
                if side > w else None)
        q, k, v, bias = k10_inputs(bw, heads, n, torch.bfloat16, 99)
        full = bias[None].expand(bw, -1, -1, -1).contiguous()
        if mask is not None:
            full += mask.repeat(b, 1, 1)[:, None]
        ms, runs = in_turns(
            {"kernel": lambda: window_attention_pallas_multi(
                q, k, v, bias, mask, nw),
             "plain": lambda: window_attention_reference(q, k, v, bias,
                                                         mask, nw),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=full, scale=32 ** -0.5)},
            {"kernel": 20, "plain": 5, "sdpa": 20})
        bnd = k10_bound(bw, heads, n, nw, mask is not None, torch.bfloat16)
        times[what] = ms | bnd | {"blocks": blocks}
        flops = 4 * bw * heads * n * n * 32
        print(f"[kernels] K10 time bf16 {what} (BW, H, N, D) = ({bw}, "
              f"{heads}, {n}, 32){' shifted' if mask is not None else ''}: "
              f"kernel {ms['kernel']:.4f} ms ({flops / ms['kernel'] / 1e9:.1f}"
              f" TFLOP/s), plain {ms['plain']:.4f} ms, SDPA "
              f"{ms['sdpa']:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_detail']}); runs {runs}; {card}")
        del q, k, v, full
    forward = {key: sum(t["blocks"] * t[key] for t in times.values())
               for key in ("kernel", "plain", "sdpa", "bound_ms")}
    print(f"[kernels] K10 bf16, the "
          f"{sum(t['blocks'] for t in times.values())} launches of one "
          f"{TEACHER_BACKBONE} forward at B = {K10_CASES[0][1]} (every block "
          f"timed as its stage's shifted one): kernel "
          f"{forward['kernel']:.4f} ms, plain {forward['plain']:.4f} ms, SDPA "
          f"{forward['sdpa']:.4f} ms, bound {forward['bound_ms']:.4f} ms; "
          f"{card}")
    # float32 at stage 0: the FMA products
    what, b, side, heads, w, _ = K10_CASES[0]
    nw, n = (side // w) ** 2, w * w
    mask = shift_mask(side, side, w, w // 2, DEVICE, torch.float32)
    q, k, v, bias = k10_inputs(b * nw, heads, n, torch.float32, 98)
    full = bias[None] + mask.repeat(b, 1, 1)[:, None]
    f32, runs = in_turns(
        {"kernel": lambda: window_attention_pallas_multi(q, k, v, bias, mask,
                                                         nw),
         "plain": lambda: window_attention_reference(q, k, v, bias, mask,
                                                     nw),
         "sdpa": lambda: F.scaled_dot_product_attention(
             q, k, v, attn_mask=full, scale=32 ** -0.5)},
        {"kernel": 10, "plain": 5, "sdpa": 10})
    f32 |= k10_bound(b * nw, heads, n, nw, True, torch.float32)
    print(f"[kernels] K10 time float32 {what} (BW, H, N, D) = ({b * nw}, "
          f"{heads}, {n}, 32) shifted: kernel {f32['kernel']:.4f} ms, plain "
          f"{f32['plain']:.4f} ms, SDPA {f32['sdpa']:.4f} ms, bound "
          f"{f32['bound_ms']:.4f} ms ({f32['bound_detail']}); runs {runs}; "
          f"{card}")
    del q, k, v, full
    t = times[K10_CASES[0][0]]
    return {"max_abs_err": main_err, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["sdpa"],
            "ms_by_stage": {k: {"ms": v["kernel"], "plain_ms": v["plain"],
                                "library_ms": v["sdpa"],
                                "bound_ms": v["bound_ms"]}
                            for k, v in times.items()},
            "float32": {"ms": f32["kernel"], "plain_ms": f32["plain"],
                        "bound_ms": f32["bound_ms"],
                        "bound_by": f32["bound_by"],
                        "library_ms": f32["sdpa"]},
            "forward_ms": round(forward["kernel"], 4),
            "forward_plain_ms": round(forward["plain"], 4),
            "forward_library_ms": round(forward["sdpa"], 4),
            "forward_bound_ms": round(forward["bound_ms"], 6)}


def phase_model_mstct() -> None:
    """The full-width float32 MSTCT on 1536-d features, on the card against
    the CPU on one video: K7 launches per forward, and the correlation and
    max error of the logits and the feature."""
    from computervision_codes_tpu_torch.models.mstct import MSTCT

    cpu_model = MSTCT(MSTCT_IN, dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0),
                      **MSTCT_KW).eval()
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, MSTCT_MODEL_T, MSTCT_IN)).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(x)
        t_cpu = time.perf_counter() - t0
        before = launches()
        got = dev_model(x.to(DEVICE))
        count = launched_since(before)
    want_count = dict.fromkeys(KERNELS, 0) | {"attention": MSTCT_LAUNCHES}
    check(count == want_count, f"MSTCT model launches {count}, want "
                               f"{want_count}")
    for k in ("logits", "feature"):
        g, w = got[k].cpu(), want[k]
        check(g.shape == w.shape, f"MSTCT model {k}: shape {g.shape}")
        check(bool(torch.isfinite(g).all()), f"MSTCT model {k}: non-finite")
        corr = float(np.corrcoef(g.numpy().ravel(), w.numpy().ravel())[0, 1])
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(err <= MODEL_REL_TOL * scale,
              f"MSTCT model {k}: card vs CPU max_abs_err {err} > "
              f"{MODEL_REL_TOL} x {scale}")
        print(f"[model] MSTCT float32 {k} {tuple(g.shape)}: card vs CPU "
              f"correlation {corr:.8f}, max_abs_err {err:.3e} (max|ref| "
              f"{scale:.3f}, tol {MODEL_REL_TOL:g} x max|ref|)")
    print(f"[model] MSTCT launches on the card per forward {count}; CPU "
          f"forward of {MSTCT_MODEL_T} frames {t_cpu:.2f} s (host clock)")


def randomize_bn(model, seed: int) -> None:
    """Draw every BatchNorm's affine and statistics from a seed: the
    TResNet init's zero gamma on each block's last ABN would leave the
    residual branches out of a card-vs-CPU check."""
    from computervision_codes_tpu_torch.models.resnet import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))


def card_vs_cpu(what: str, pairs, rel_tol: float) -> None:
    """Each (name, card tensor, CPU tensor): same shape, finite, max error
    within ``rel_tol`` of max(1, max|CPU|); prints it with the
    correlation."""
    for name, got, want in pairs:
        g, w = got.float().cpu(), want.float()
        check(g.shape == w.shape, f"{what} {name}: shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{what} {name}: non-finite")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        corr = float(np.corrcoef(g.numpy().ravel(), w.numpy().ravel())[0, 1])
        check(err <= rel_tol * scale, f"{what} {name}: card vs CPU "
                                      f"max_abs_err {err} > {rel_tol} x "
                                      f"{scale}")
        print(f"[model] {what} {name} {tuple(g.shape)}: card vs CPU "
              f"max_abs_err {err:.3e} = {err / scale:.2e} of max(1, max|ref|)"
              f" {scale:.3f} (tol {rel_tol:g}), correlation {corr:.8f}")


def phase_model_tresnet() -> None:
    """The full-width float32 Q2L(tresnet_l, "i"), BatchNorm drawn from a
    seed, on the card against the CPU on one 448x448 frame: 52 K9 launches
    per forward and no other kernel."""
    from computervision_codes_tpu_torch.models.q2l import Q2L

    cpu_model = Q2L(backbone=TRESNET, loss_type="i", dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0)).eval()
    randomize_bn(cpu_model, 7)
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    frames = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, TRESNET_IMG, TRESNET_IMG, 3)).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(frames)
        t_cpu = time.perf_counter() - t0
        before = launches()
        got = dev_model(frames.to(DEVICE))
        count = launched_since(before)
    want_count = dict.fromkeys(KERNELS, 0) | TRESNET_LAUNCHES
    check(count == want_count, f"TResNet model launches {count}, want "
                               f"{want_count}")
    card_vs_cpu(f"TResNet float32 Q2L({TRESNET}, 'i')",
                [("logits i", got["logits"]["i"], want["logits"]["i"]),
                 ("feature", got["feature"], want["feature"])],
                TEACHER_MODEL_REL_TOL)
    print(f"[model] TResNet launches on the card per forward {count}; CPU "
          f"forward of one frame {t_cpu:.2f} s (host clock)")
    del cpu_model, dev_model


def phase_model_swin_fused() -> None:
    """The full-width float32 Swin-L-384 with ``use_fused_attn`` on the card
    against the CPU on one 384x384 frame: 24 K10 launches per forward and
    no other kernel."""
    from computervision_codes_tpu_torch.models.swin import build_swin

    cpu_model = build_swin(TEACHER_BACKBONE, dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0),
                           use_fused_attn=True).eval()
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    frames = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, TEACHER_IMG, TEACHER_IMG, 3)).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(frames)
        t_cpu = time.perf_counter() - t0
        before = launches()
        got = dev_model(frames.to(DEVICE))
        count = launched_since(before)
    want_count = dict.fromkeys(KERNELS, 0) | SWIN_FUSED_LAUNCHES
    check(count == want_count, f"use_fused_attn Swin launches {count}, want "
                               f"{want_count}")
    card_vs_cpu(f"float32 {TEACHER_BACKBONE} use_fused_attn",
                [(k, got[k], want[k]) for k in ("feature_map", "pooled")],
                TEACHER_MODEL_REL_TOL)
    print(f"[model] use_fused_attn Swin launches on the card per forward "
          f"{count}; CPU forward of one frame {t_cpu:.2f} s (host clock)")
    del cpu_model, dev_model


def mstct_tree(root: str) -> tuple:
    """A CholecT45 tree for the MS-TCT driver, written by the port's
    ``data.synthetic``: label CSVs of every fold-1 video and random 1536-d
    features in ``data_feats/run_Q2L/k1_feats.pkl``."""
    from computervision_codes_tpu_torch.data.feature_store import (
        FeatureStore)
    from computervision_codes_tpu_torch.data.splits import resolve_split
    from computervision_codes_tpu_torch.data.synthetic import (
        synthetic_feature_dict, write_synthetic_dataset)

    split = resolve_split("cholect45-crossval", 1)
    lengths = dict.fromkeys(split.all_videos, MSTCT_OTHER_LENGTH)
    lengths |= dict(zip(split.test, MSTCT_TEST_LENGTHS))
    counts = [lengths[v] for v in split.all_videos]
    write_synthetic_dataset(root, split.all_videos, counts)
    FeatureStore(root + "/data_feats", "Q2L").save(
        1, "feats", synthetic_feature_dict(split.all_videos, counts,
                                           MSTCT_IN, seed=6))
    return split, lengths


def phase_mstct(card: str, root: str, split, lengths: dict,
                dtype: str) -> None:
    """The port's MS-TCT driver in process, ``-e -d`` at ``dtype`` on the
    card, from weights made from its seed: ms per video, frames/s over the
    test videos, K7 launches (8 per video evaluated), peak device memory,
    the test mAP (random weights: a number, not a bound) and both dumps."""
    from computervision_codes_tpu_torch.cli import temporal_mstct
    from computervision_codes_tpu_torch.data.feature_store import (
        FeatureStore)

    version = f"mstct_{dtype}"
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launches()
    t0 = time.perf_counter()
    result = temporal_mstct.main(
        ["--data_dir", root, "--ckpt_root", root + "/ckpt", "--version",
         version, "--dtype", dtype, "--device", DEVICE, "-e", "-d"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    count = launched_since(before)
    evaluated = len(split.test) + len(split.all_videos)
    want = dict.fromkeys(KERNELS, 0) | {
        "attention": MSTCT_LAUNCHES * evaluated}
    check(count == want, f"MS-TCT driver {dtype}: launches {count}, want "
                         f"{want}")
    test_ms = result["eval_ms"]["test"]
    frames = sum(lengths[v] for v in split.test)
    fps = frames / (sum(test_ms.values()) / 1e3)
    check(np.isfinite(result["test_mAP"]), f"MS-TCT {dtype}: test mAP "
                                           f"{result['test_mAP']}")
    store = FeatureStore(root + "/data_feats", version)
    for kind, width in (("feats", MSTCT_EMBED), ("pred", MSTCT_CLASSES)):
        dump = store.load(1, kind, task="ivt")
        check(set(dump) == {v[3:] for v in split.all_videos},
              f"MS-TCT {dtype} {kind} dump: videos {sorted(dump)}")
        for v in split.all_videos:
            a = dump[v[3:]]
            check(a.shape == (lengths[v], width) and bool(
                np.isfinite(a).all()), f"MS-TCT {dtype} {kind} {v}: shape "
                                       f"{a.shape} or non-finite")
            if kind == "pred":
                check(bool(((a >= 0) & (a <= 1)).all()),
                      f"MS-TCT {dtype} pred {v}: outside [0, 1]")
    print(f"[mstct] driver -e -d --dtype {dtype} on the card: test videos "
          f"(frames: ms) " + ", ".join(
              f"{lengths[v]}: {test_ms[v]:.2f}" for v in split.test)
          + f"; {frames} test frames in {sum(test_ms.values()):.2f} ms = "
          f"{fps:.1f} frames/s; dump of {len(split.all_videos)} videos in "
          f"{sum(result['eval_ms']['dump'].values()):.2f} ms; K7 launches "
          f"{count['attention']} ({MSTCT_LAUNCHES} x {evaluated} videos); "
          f"device memory: the run adds up to {(peak - resident) / 2**30:.2f}"
          f" GiB, peak {peak / 2**30:.2f} GiB (the serving sessions of "
          f"phases 5-7 resident); test mAP[ivt] "
          f"{result['test_mAP']:.4f} (random weights); dumps k1_ivt_feats "
          f"(T, {MSTCT_EMBED}) and k1_ivt_pred (T, {MSTCT_CLASSES}) finite "
          f"for all {len(split.all_videos)} videos; {wall:.2f} s wall with "
          f"the tree's loading and the pickles; {card}")


def kernel_category(name: str) -> str:
    low = name.lower()
    if name.split("(")[0].split("<")[0].split()[-1].startswith("attn::"):
        return "K7 attention"  # attn::attn_wgmma_kernel, _f32_, merge_
    if "conv" in low:
        return "depthwise convolutions"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
        return "GEMMs (cuBLAS)"
    return "elementwise and reductions (LayerNorm, GELU, adds, casts)"


def host_ms(fn) -> float:
    """Host-clock ms of one call of ``fn`` up to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_mstct_breakdown(card: str) -> None:
    """One forward of the full-width MSTCT on the longest test video in
    each dtype: device ms by kernel category and the device busy share
    from torch.profiler, then ms by module type from CUDA events around
    each Dense, conv and LayerNorm (with the gaps between their kernels);
    and the fixed cost of a length not run before, which the driver pays
    once per video: a forward at such a length, then at it again."""
    from torch.profiler import ProfilerActivity, profile

    from computervision_codes_tpu_torch.models.common import (
        Dense, LayerNorm, TemporalConv)
    from computervision_codes_tpu_torch.models.mstct import MSTCT

    t = max(MSTCT_TEST_LENGTHS)
    x = torch.randn(1, t, MSTCT_IN,
                    generator=torch.Generator(device=DEVICE).manual_seed(7),
                    device=DEVICE)
    kinds = {Dense: "Dense", TemporalConv: "TemporalConv (merge GEMM form, "
             "depthwise)", LayerNorm: "LayerNorm"}
    for dtype in (torch.float32, torch.bfloat16):
        label = f"MSTCT {str(dtype)[6:]} forward of {t} frames"
        model = MSTCT(MSTCT_IN, dtype=dtype,
                      generator=torch.Generator().manual_seed(0),
                      **MSTCT_KW).to(DEVICE).eval()
        with torch.inference_mode():
            before = design_counts()
            model(x)  # warm-up; K7 in the current design only
            torch.cuda.synchronize()
            now = design_counts()
            got = {k: now[k] - before[k] for k in now if now[k] > before[k]}
            check(got == {"fwd new": MSTCT_LAUNCHES},
                  f"{label}: K7 launches per design {got}, want "
                  f"{{'fwd new': {MSTCT_LAUNCHES}}}")
            x_new = x[:, :t - 1]  # a length no earlier phase ran
            new_ms = [host_ms(lambda: model(x_new)) for _ in range(2)]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        cats, rows = {}, []
        for evt in prof.key_averages():
            if not str(evt.device_type).endswith("CUDA"):
                continue
            dev_ms = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0)) / 1e3
            cat = kernel_category(evt.key)
            cats[cat] = cats.get(cat, 0.0) + dev_ms
            rows.append((dev_ms, evt.count, evt.key[:70]))
        busy = sum(cats.values())
        print(f"[breakdown] {label} under torch.profiler: {wall_ms:.3f} ms "
              f"wall, device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%"
              f"); device ms by kind: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(
                      cats.items(), key=lambda kv: -kv[1])) + f"; {card}")
        for dev_ms, count, name in sorted(rows, reverse=True)[:10]:
            print(f"[breakdown]   {dev_ms:9.3f} ms  x{count:<5d} {name}")
        print(f"[breakdown] MSTCT {str(dtype)[6:]} forward at {t - 1} "
              f"frames, a length not run before: {new_ms[0]:.3f} ms, then "
              f"{new_ms[1]:.3f} ms at it again (host clock to a "
              f"synchronise); {card}")

        spans = []  # [kind, start event, end event], in call order

        def pre(mod, args, kind):
            spans.append([kind, torch.cuda.Event(enable_timing=True), None])
            spans[-1][1].record()

        def post(mod, args, out):
            span = next(s for s in reversed(spans) if s[2] is None)
            span[2] = torch.cuda.Event(enable_timing=True)
            span[2].record()

        hooks = [h for mod in model.modules() if type(mod) in kinds
                 for h in (mod.register_forward_pre_hook(functools.partial(
                     pre, kind=kinds[type(mod)])),
                           mod.register_forward_hook(post))]
        with torch.inference_mode():
            _, fwd_ms = timed_call(lambda: model(x))
        for h in hooks:
            h.remove()
        parts = {}
        for kind, a, b in spans:
            parts[kind] = parts.get(kind, 0.0) + a.elapsed_time(b)
        print(f"[breakdown] {label}: {fwd_ms:.3f} ms (CUDA events, module "
              f"hooks on); by module type " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in parts.items())
              + f", everything else (K7 and the GELU and adds between) "
              f"{fwd_ms - sum(parts.values()):.3f} ms; {card}")
        del model


def mstct_step_setup(dtype, device: str, drop: bool = True):
    """(state, step) of the MS-TCT driver's training path at full width:
    MSTCT on 1536-d features, weights from seed 0, the driver's SGD (its
    schedule at one step per epoch, weight decay 1e-5), loss "ivt";
    ``drop=False`` sets both dropout rates to 0."""
    from computervision_codes_tpu_torch.cli.temporal_mstct import (
        TASK_INFO, make_mstct_train_step)
    from computervision_codes_tpu_torch.models.common import Dropout
    from computervision_codes_tpu_torch.models.mstct import MSTCT
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, reference_warmup_exp_schedule)

    model = MSTCT(MSTCT_IN, dtype=dtype,
                  generator=torch.Generator().manual_seed(0), **MSTCT_KW)
    if not drop:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99,
                                          steps_per_epoch=1)
    state = create_train_state(model, build_sgd(sched, 1e-5), seed=1,
                               device=device)
    return state, make_mstct_train_step(model, "ivt", TASK_INFO["ivt"][1],
                                        device)


def mstct_batch(b: int, seed: int) -> dict:
    """b windows of MSTCT_WINDOW frames of seeded 1536-d features and
    multi-hot labels of the 100 triplets, as the driver passes them to its
    step: lists of per-window float32 arrays on the host."""
    rng = np.random.default_rng(seed)
    return {"features": [rng.standard_normal(
                (MSTCT_WINDOW, MSTCT_IN)).astype(np.float32)
                for _ in range(b)],
            "labels": [(rng.random((MSTCT_WINDOW, MSTCT_CLASSES))
                        < TRAIN_POSITIVE).astype(np.float32)
                       for _ in range(b)]}


def phase_model_mstct_train() -> None:
    """One float32 training step of the full-width MSTCT at batch
    MSTCT_CPU_B of 256-frame windows, dropout off, on the card (K7 forward,
    plain attention backward) against the same step on the CPU: the loss,
    the gradient norm of one parameter per stage and of the mixer and the
    head, and the global gradient norm."""
    batch = mstct_batch(MSTCT_CPU_B, 13)
    readings = {}
    for device in ("cpu", DEVICE):
        state, step = mstct_step_setup(torch.float32, device, drop=False)
        before = launches()
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        loss = metrics["loss"].item()
        seconds = time.perf_counter() - t0
        count = launched_since(before)
        params = dict(state.model.named_parameters())
        norms = {n: params[n].grad.norm().item() for n in MSTCT_GRAD_PARAMS}
        norms["global"] = float(torch.stack([
            p.grad.norm() for p in state.model.parameters()
            if p.grad is not None]).norm())
        readings[device] = (loss, norms, count, seconds)
        del state, step
    (l_cpu, n_cpu, _, t_cpu), (l_dev, n_dev, count, t_dev) = (
        readings["cpu"], readings[DEVICE])
    want = dict.fromkeys(KERNELS, 0) | {"attention": MSTCT_LAUNCHES}
    check(count == want, f"float32 MS-TCT training step launches {count}, "
                         f"want {want}")
    rel = {n: abs(n_dev[n] - n_cpu[n]) / max(n_cpu[n], 1e-12) for n in n_cpu}
    loss_rel = abs(l_dev - l_cpu) / max(1.0, abs(l_cpu))
    print(f"[model] float32 MS-TCT training step, full width, batch "
          f"{MSTCT_CPU_B} x {MSTCT_WINDOW} frames, dropout off, card (K7) vs "
          f"CPU (plain): loss {l_dev:.6f} vs {l_cpu:.6f}; gradient norms "
          f"card / CPU " + ", ".join(f"{n} {n_dev[n]:.6e} / {n_cpu[n]:.6e}"
                                     for n in n_cpu)
          + f"; relative differences: loss {loss_rel:.2e} (tol "
          f"{MSTCT_TRAIN_LOSS_REL:g}), gradient norms "
          f"{ {n: float(f'{r:.2e}') for n, r in rel.items()} } (tol "
          f"{MSTCT_TRAIN_GRAD_REL:g}); CPU step {t_cpu:.2f} s, card step "
          f"{t_dev:.2f} s (host clock, the first)")
    check(loss_rel <= MSTCT_TRAIN_LOSS_REL,
          f"MS-TCT float32 step, card vs CPU: loss differs by {loss_rel}")
    for name, r in rel.items():
        check(np.isfinite(r) and r <= MSTCT_TRAIN_GRAD_REL,
              f"MS-TCT float32 step, card vs CPU: the gradient norm of "
              f"{name} differs by {r} (relative) > {MSTCT_TRAIN_GRAD_REL}")


def mstct_train_tree(root: str) -> tuple:
    """A CholecT45 tree for the MS-TCT driver's training: the fold's 31
    training videos at 300-2,000 frames (one at MSTCT_SHORT_LENGTH, shorter
    than the window), every other video at MSTCT_OTHER_LENGTH, random
    1536-d features."""
    from computervision_codes_tpu_torch.data.feature_store import (
        FeatureStore)
    from computervision_codes_tpu_torch.data.splits import resolve_split
    from computervision_codes_tpu_torch.data.synthetic import (
        synthetic_feature_dict, write_synthetic_dataset)

    split = resolve_split("cholect45-crossval", 1)
    rng = np.random.default_rng(15)
    lengths = dict.fromkeys(split.all_videos, MSTCT_OTHER_LENGTH)
    lengths |= {v: int(rng.integers(*MSTCT_TRAIN_LENGTHS))
                for v in split.train}
    lengths[split.train[0]] = MSTCT_SHORT_LENGTH
    counts = [lengths[v] for v in split.all_videos]
    write_synthetic_dataset(root, split.all_videos, counts)
    FeatureStore(root + "/data_feats", "Q2L").save(
        1, "feats", synthetic_feature_dict(split.all_videos, counts,
                                           MSTCT_IN, seed=16))
    return split, lengths


def phase_mstct_train(card: str, root: str, split, dtype: str) -> None:
    """The port's MS-TCT driver in process, ``-t`` on the card at full
    width (``--window 256 -b 32``) for 2 epochs, then ``--resume`` for one
    more: launches of K7 (8 per forward of each window length of a step,
    8 per validation video), the logged losses, the steps, the wall time
    of each run and its peak device memory."""
    from computervision_codes_tpu_torch.cli import temporal_mstct
    from computervision_codes_tpu_torch.utils.logging import (
        summarize_events)

    version = f"mstct_train_{dtype}"
    argv = ["--data_dir", root, "--ckpt_root", root + "/ckpt", "--version",
            version, "--dtype", dtype, "--device", DEVICE, "-t", "--window",
            str(MSTCT_WINDOW), "-b", str(MSTCT_STEP_B)]
    # a step forwards its full windows together and the short one alone
    per_epoch = MSTCT_LAUNCHES * (2 + len(split.val))
    for epochs, extra, step in ((2, [], 2), (1, ["--resume"], 3)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        t0 = time.perf_counter()
        result = temporal_mstct.main(argv + ["--epochs", str(epochs)]
                                     + extra)
        wall = time.perf_counter() - t0
        count = launched_since(before)
        want = dict.fromkeys(KERNELS, 0) | {"attention": per_epoch * epochs}
        check(count == want, f"MS-TCT driver -t {dtype} {extra}: launches "
                             f"{count}, want {want}")
        check(result["step"] == step, f"MS-TCT driver -t {dtype} {extra}: "
                                      f"step {result['step']}, want {step}")
        check(all(np.isfinite(result["train_loss"])),
              f"MS-TCT driver -t {dtype}: losses {result['train_loss']}")
        print(f"[mstct train] driver -t --dtype {dtype} --epochs {epochs} "
              f"{' '.join(extra)} on the card, full width, --window "
              f"{MSTCT_WINDOW} -b {MSTCT_STEP_B} ({len(split.train)} training "
              f"videos: one step per epoch; {len(split.val)} validation "
              f"videos): {wall:.2f} s wall with validation and checkpoints; "
              f"step {result['step']}; losses {result['train_loss']}; K7 "
              f"launches {count['attention']}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    events = summarize_events(
        f"{root}/ckpt/run_{version}/rendezvous_lcholect45-crossval_cholect1"
        f"_mstct_ivt.events.jsonl", "train/loss")
    check(len(events) == 3, f"MS-TCT driver {dtype}: {len(events)} loss "
                            f"records, want 3")


def phase_mstct_step(card: str) -> dict:
    """The MS-TCT training step (``make_mstct_train_step``, as the driver
    runs it) at full width on one fixed batch of MSTCT_STEP_B windows of
    256 frames, float32 then bf16: the batch is the driver's lists of
    per-window host arrays, so each step stacks them on the host and copies
    them to the card as the driver's do. MSTCT_STEPS steps each, ms per
    step host to host, frames/s, peak device memory, the loss falling;
    one step under torch.profiler by kind with the busy share; the
    checkpoint of the trained state written, restored into a fresh state
    and equal."""
    from computervision_codes_tpu_torch.train.checkpoint import (
        CheckpointManager)

    batch = mstct_batch(MSTCT_STEP_B, 14)
    frames = MSTCT_STEP_B * MSTCT_WINDOW
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        state, step = mstct_step_setup(dtype, DEVICE)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        ms, losses = [], []
        for _ in range(MSTCT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step(state, batch)
            losses.append(metrics["loss"].item())  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        count = launched_since(before)
        want = dict.fromkeys(KERNELS, 0) | {
            "attention": MSTCT_LAUNCHES * MSTCT_STEPS}
        check(count == want, f"MS-TCT {name} step launches {count}, want "
                             f"{want}")
        check(all(np.isfinite(losses)), f"MS-TCT {name} step: losses "
                                        f"{losses}")
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"MS-TCT {name} training loss does not fall: {losses}")
        steady = float(np.median(ms[2:]))
        out[name] = {"ms": steady, "frames_s": frames / steady * 1e3,
                     "peak_gib": peak / 2 ** 30}
        print(f"[mstct step] {name}: make_mstct_train_step at full width, "
              f"batch {MSTCT_STEP_B} x {MSTCT_WINDOW} frames of {MSTCT_IN}-d "
              f"features from per-window host arrays, SGD (the driver's schedule, wd 1e-5), dropout "
              f"0.5: ms per step (host to host) {[round(m, 3) for m in ms]}"
              f"; median after 2 warm-up {steady:.3f} ms = "
              f"{frames / steady * 1e3:.1f} frames/s; K7 launches per step "
              f"{MSTCT_LAUNCHES}; device memory: model and SGD state "
              f"{resident / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; "
              f"losses {[round(v, 5) for v in losses]}; {card}")
        busy, rows = device_profile(card, f"MS-TCT {name} training step",
                                    lambda: step(state, batch), 10)
        kinds = {}
        for dev_ms, n, kname in rows:
            kind = kernel_category(kname)
            t, c = kinds.get(kind, (0.0, 0))
            kinds[kind] = (t + dev_ms, c + n)
        for kind, (t, c) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
            print(f"[breakdown] MS-TCT {name} training step: {t:9.3f} ms "
                  f"({100 * t / busy:.1f}% of device busy) in {c} launches: "
                  f"{kind}; {card}")
        with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as d:
            manager = CheckpointManager(d, f"mstct_{name}")
            t0 = time.perf_counter()
            path = manager.save(state, tag="latest")
            save_s = time.perf_counter() - t0
            fresh, _ = mstct_step_setup(dtype, DEVICE)
            with torch.no_grad():
                for p in fresh.model.parameters():
                    p.zero_()
            manager.restore(fresh, tag="latest")
            same = all(torch.equal(a, b) for a, b in zip(
                fresh.model.parameters(), state.model.parameters()))
            check(same and fresh.step == state.step
                  and fresh.optimizer.count == state.optimizer.count,
                  f"MS-TCT {name} checkpoint round trip: weights equal "
                  f"{same}, step {fresh.step} / {state.step}, count "
                  f"{fresh.optimizer.count} / {state.optimizer.count}")
            print(f"[mstct step] {name} checkpoint round trip: "
                  f"{Path(path).stat().st_size / 2**20:.1f} MiB written in "
                  f"{save_s:.2f} s, restored into a fresh state: weights, "
                  f"step {fresh.step} and the schedule's count equal")
        del state, step, fresh
    return out


def branch_grads(fn, args, n_grad: int, upstream):
    """Gradients of sum(fn(*args) * upstream) over the first ``n_grad``
    arguments, taken at detached copies of them."""
    leaves = [a.detach().requires_grad_() for a in args[:n_grad]]
    out = fn(*leaves, *args[n_grad:])
    return out, torch.autograd.grad(out, leaves, upstream)


def phase_k6(card: str) -> tuple:
    """K6: each training branch (K3 and K4 without the residual) against
    its plain version at the batch-8 stage shapes of the Swin-L-384
    training step (the attention branch shifted and not) and a ragged
    shape, bf16 and float32; each branch Function's gradients on the card
    against autograd of the plain version at the same inputs; then the
    kernel's and the plain version's times at each stage, in turns, beside
    the bound, and their sums over the 44 launches of a training step
    (22 blocks, forward and remat replay). Returns the kernels' entries."""
    from computervision_codes_tpu_torch.ops.mlp_block import (
        mlp_block_loop_cuda, mlp_block_reference)
    from computervision_codes_tpu_torch.ops.swin_train import (
        make_attn_branch, make_mlp_branch, mlp_block_branch_cuda,
        window_mhsa_branch_cuda)
    from computervision_codes_tpu_torch.ops.window_mhsa import (
        window_mhsa_loop_cuda, window_mhsa_reference)

    def attn_loop(x, *args, **kw):
        return window_mhsa_loop_cuda(x, *args, **kw, res_add=False)

    def mlp_loop(x, *args):
        return mlp_block_loop_cuda(x, *args, res_add=False)

    def attn_ref(x, *args, **kw):
        return window_mhsa_reference(x, *args, **kw, res_add=False)

    def mlp_ref(x, *args):
        return mlp_block_reference(x, *args, res_add=False)

    main_err = {"attn": 0.0, "mlp": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        worst, differ = (-1.0, None), {}
        for seed, (what, b, hw, c, heads, w, _) in enumerate(K6_ATTN_CASES):
            hp, wp = geometry(hw)
            x, attn, _ = swin_inputs((b, hp, wp), c, 4 * c, heads, w, dtype,
                                     seed)
            for shift in (0, w // 2):
                kw = dict(window=w, num_heads=heads)
                mask = swin_mask(hp, wp, w, shift)
                got = window_mhsa_branch_cuda(x, *attn, mask, **kw)
                err, tol = compare(
                    f"K6 attention {str(dtype)[6:]} {what} shift={shift}",
                    got, attn_ref(x, *attn, mask, **kw), dtype)
                if dtype == torch.bfloat16:
                    differ[f"attention {what} shift={shift}"] = new_vs_old(
                        got, attn_loop(x, *attn, mask, **kw))
                if err / tol >= worst[0]:
                    worst = (err / tol, ("attention", what, shift, err, tol))
                if dtype == torch.bfloat16 and isinstance(hw, int):
                    main_err["attn"] = max(main_err["attn"], err)
            del x, attn
        for seed, (what, m, c, hidden, _) in enumerate(K6_MLP_CASES):
            x, _, mlp = swin_inputs((m,), c, hidden, 1, 1, dtype, 10 + seed)
            got = mlp_block_branch_cuda(x, *mlp)
            err, tol = compare(f"K6 MLP {str(dtype)[6:]} {what}", got,
                               mlp_ref(x, *mlp), dtype)
            if dtype == torch.bfloat16:
                differ[f"MLP {what}"] = new_vs_old(got, mlp_loop(x, *mlp))
            if err / tol >= worst[0]:
                worst = (err / tol, ("MLP", what, err, tol))
            if dtype == torch.bfloat16 and "stage" in what:
                main_err["mlp"] = max(main_err["mlp"], err)
            del x, mlp
        cases = 2 * len(K6_ATTN_CASES) + len(K6_MLP_CASES)
        print(f"[kernels] K6 {str(dtype)[6:]}: {cases} cases of the two "
              f"branches within tolerance ({REL_TOL[dtype]:g} x max(1, "
              f"max|ref|)) of the plain versions at res_add=False; worst "
              f"(branch, case, [shift,] err, tol) = {worst[1]}"
              + (f"; against the loop (outputs that differ, largest "
                 f"difference) {differ}" if differ else ""))

        # the Functions' backward against autograd of the plain versions
        what, b, hw, c, heads, w = K6_GRAD_ATTN
        x, attn, _ = swin_inputs((b, hw, hw), c, 4 * c, heads, w, dtype, 20)
        mask = swin_mask(hw, hw, w, w // 2).to(dtype)
        up = torch.randn(x.shape, device=DEVICE).to(dtype)
        kw = dict(window=w, num_heads=heads)
        fn = make_attn_branch(w, heads, True).apply
        _, got = branch_grads(fn, [x, *attn, mask], 8, up)
        _, want = branch_grads(lambda *a: attn_ref(*a, **kw),
                               [x, *attn, mask], 8, up)
        names = ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj",
                 "bias")
        errs = [compare(f"K6 attention gradient {str(dtype)[6:]} {n}", g_,
                        w_, dtype)[0] for n, g_, w_ in zip(names, got, want)]
        x, _, mlp = swin_inputs((K6_GRAD_MLP[1],), K6_GRAD_MLP[2],
                                K6_GRAD_MLP[3], 1, 1, dtype, 21)
        up = torch.randn(x.shape, device=DEVICE).to(dtype)
        _, got = branch_grads(make_mlp_branch().apply, [x, *mlp], 7, up)
        _, want = branch_grads(mlp_ref, [x, *mlp], 7, up)
        names = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
        errs += [compare(f"K6 MLP gradient {str(dtype)[6:]} {n}", g_, w_,
                         dtype)[0] for n, g_, w_ in zip(names, got, want)]
        print(f"[kernels] K6 {str(dtype)[6:]} gradients of both branch "
              f"Functions at {what} (attention shifted; every argument but "
              f"the mask) against autograd of the plain versions: within "
              f"{REL_TOL[dtype]:g} x max(1, max|ref|), worst max_abs_err "
              f"{max(errs):.3e}")
        del x, attn, mlp, up

    # times in bf16 at the stage shapes (shifted at stages 0-2, as every
    # other block is), in turns with the plain version, beside the bound
    times = {"attn": {}, "mlp": {}}
    for what, b, hw, c, heads, w, blocks in K6_ATTN_CASES[:3]:
        x, attn, _ = swin_inputs((b, hw, hw), c, 4 * c, heads, w,
                                 torch.bfloat16, 99)
        mask, kw = swin_mask(hw, hw, w, w // 2), dict(window=w,
                                                      num_heads=heads)
        ms, runs = in_turns(
            {"plain": lambda: attn_ref(x, *attn, mask, **kw),
             "kernel": lambda: window_mhsa_branch_cuda(x, *attn, mask,
                                                       **kw),
             "loop": lambda: attn_loop(x, *attn, mask, **kw)},
            {"plain": 5, "kernel": 10, "loop": 10})
        ops, nbytes = attn_work(b, hw, hw, c, heads, w, True, 2)
        times["attn"][what] = ms | bound(ops, nbytes, "bf16") | {
            "blocks": blocks, "ops": ops, "bytes": nbytes}
        print(f"[kernels] K6 attention time bf16 {what} {hw}x{hw} C={c} "
              f"heads={heads} shifted: kernel {ms['kernel']:.4f} ms "
              f"({ops / ms['kernel'] / 1e9:.1f} TFLOP/s), loop "
              f"{ms['loop']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms, bound "
              f"{times['attn'][what]['bound_ms']:.4f} ms; runs {runs}; "
              f"{card}")
        del x, attn
    for what, m, c, hidden, blocks in K6_MLP_CASES[:3]:
        x, _, mlp = swin_inputs((m,), c, hidden, 1, 1, torch.bfloat16, 98)
        ms, runs = in_turns(
            {"plain": lambda: mlp_ref(x, *mlp),
             "kernel": lambda: mlp_block_branch_cuda(x, *mlp),
             "loop": lambda: mlp_loop(x, *mlp)},
            {"plain": 5, "kernel": 10, "loop": 10})
        ops, nbytes = mlp_work(m, c, hidden, 2)
        times["mlp"][what] = ms | bound(ops, nbytes, "bf16") | {
            "blocks": blocks, "ops": ops, "bytes": nbytes}
        print(f"[kernels] K6 MLP time bf16 {what} {m} x {c}, hidden "
              f"{hidden}: kernel {ms['kernel']:.4f} ms "
              f"({ops / ms['kernel'] / 1e9:.1f} TFLOP/s), loop "
              f"{ms['loop']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms, bound "
              f"{times['mlp'][what]['bound_ms']:.4f} ms; runs {runs}; {card}")
        del x, mlp
    out = []
    for key, label in (("attn", "attention"), ("mlp", "MLP")):
        stages = times[key]
        # per step: each block's branch in the forward and the replay
        step = {k: 2 * sum(t["blocks"] * t[k] for t in stages.values())
                for k in ("kernel", "loop", "plain", "ops", "bytes")}
        step_bound = bound(step["ops"], step["bytes"], "bf16")
        print(f"[kernels] K6 {label} branch, bf16, the "
              f"{2 * sum(t['blocks'] for t in stages.values())} launches of "
              f"one training step at batch {TRAIN_BATCH} (every block timed "
              f"as its stage's shifted one): kernel {step['kernel']:.4f} ms, "
              f"loop {step['loop']:.4f} ms, plain {step['plain']:.4f} ms, "
              f"bound "
              f"{step_bound['bound_ms']:.4f} ms; {card}")
        shape, top = list(stages.items())[2]  # 18 of the 22 blocks
        out.append({"max_abs_err": main_err[key], "ms": top["kernel"],
                    "plain_ms": top["plain"], "bound_ms": top["bound_ms"],
                    "bound_by": top["bound_by"], "library_ms": None,
                    "shape": shape,
                    "loop_ms": top["loop"],
                    "per_stage_ms": {w_: round(t["kernel"], 4)
                                     for w_, t in stages.items()},
                    "per_stage_loop_ms": {w_: round(t["loop"], 4)
                                          for w_, t in stages.items()},
                    "step_ms": round(step["kernel"], 4),
                    "step_loop_ms": round(step["loop"], 4),
                    "step_plain_ms": round(step["plain"], 4),
                    "step_bound_ms": step_bound["bound_ms"]})
    return tuple(out)


def train_inputs(b: int, img: int, seed: int, teacher: bool = False
                 ) -> dict:
    """One batch of seeded frames and multi-hot labels, on the card; with
    ``teacher`` also seeded teacher predictions (logits) and
    TRAIN_TEACHER_DIM-wide teacher features for ``loss_type="all"``."""
    rng = np.random.default_rng(seed)
    batch = {"image": rng.standard_normal((b, img, img, 3)).astype(
        np.float32)}
    for k, n in TASK_SIZES.items():
        batch[f"label_{k}"] = (rng.random((b, n)) < TRAIN_POSITIVE).astype(
            np.float32)
        if teacher and k != "ivt":
            batch[f"teacher_pred_{k}"] = (2 * rng.standard_normal(
                (b, n))).astype(np.float32)
            batch[f"teacher_feat_{k}"] = rng.standard_normal(
                (b, TRAIN_TEACHER_DIM)).astype(np.float32)
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def train_setup(fused: bool, dtype, device: str, drop: bool = True,
                loss_type: str = "i"):
    """(state, step) of the teacher's training path: Q2L(swin_L_384,
    ``loss_type``, remat "dots"; for "all" with the KD block over
    TRAIN_TEACHER_DIM-wide teacher features and the rates TRAIN_RATES),
    weights from seed 0, SGD 1e-2 with weight decay 1e-5, the reference's
    pos-weights; ``drop=False`` sets every drop rate to 0."""
    from computervision_codes_tpu_torch.losses import (
        TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT)
    from computervision_codes_tpu_torch.models.common import Dropout
    from computervision_codes_tpu_torch.models.q2l import Q2L
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, make_spatial_train_step)

    model = Q2L(backbone=TEACHER_BACKBONE, loss_type=loss_type, dtype=dtype,
                remat=True, remat_policy="dots", fused_train=fused,
                drop_path_rate=0.1 if drop else 0.0,
                teacher_dim=TRAIN_TEACHER_DIM,
                generator=torch.Generator().manual_seed(0))
    if not drop:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    state = create_train_state(model, build_sgd(1e-2, weight_decay=1e-5),
                               seed=1, device=device)
    pw = {"i": TOOL_POS_WEIGHT, "v": VERB_POS_WEIGHT, "t": TARGET_POS_WEIGHT}
    return state, make_spatial_train_step(model, loss_type, TRAIN_RATES,
                                          pos_weights=pw, device=device)


def phase_model_train() -> None:
    """One float32 training step of the full-width Q2L(swin_L_384,
    fused_train, remat "dots") at batch 1, drop rates 0, on the card (K6
    float32 at stages 0-2) against the same step on the CPU (the plain
    versions), for loss "i" and for "all" at TRAIN_RATES with seeded
    teacher arrays: the loss (and for "all" each loss term), the gradient
    norm of one parameter per stage and of the head, and the global
    gradient norm; for "all" also the KD block's outputs of the eval
    forward with the teacher features, before the step."""
    for loss_type in ("i", "all"):
        model_train_step(loss_type)


def model_train_step(loss_type: str) -> None:
    teacher = loss_type == "all"
    batch = {k: v.cpu() for k, v in
             train_inputs(1, TRAIN_IMG, 11, teacher).items()}
    named = TRAIN_GRAD_PARAMS + (("kd_attention.mi.kernel",) if teacher
                                 else ())
    readings = {}
    for device in ("cpu", DEVICE):
        state, step = train_setup(True, torch.float32, device, drop=False,
                                  loss_type=loss_type)
        kd = None
        if teacher:
            feats = [batch[f"teacher_feat_{k}"].to(device) for k in "ivt"]
            with torch.inference_mode():
                kd = state.model.eval()(batch["image"].to(device),
                                        *feats)["kd"]
            kd = {k: v.float().cpu() for k, v in kd.items()}
        before = launches()
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        terms = {k: v.item() for k, v in metrics.items()
                 if not k.startswith("hard_loss_")}
        seconds = time.perf_counter() - t0
        count = launched_since(before)
        grads = dict(state.model.named_parameters())
        norms = {n: grads[n].grad.float().norm().item() for n in named}
        norms["global"] = float(torch.stack([
            p.grad.float().norm() for p in state.model.parameters()
            if p.grad is not None]).norm())
        readings[device] = (terms, norms, count, seconds, kd)
        del state, step
    (t_cpu_terms, n_cpu, _, t_cpu, kd_cpu), (
        t_dev_terms, n_dev, count, t_dev, kd_dev) = (
        readings["cpu"], readings[DEVICE])
    want = dict.fromkeys(KERNELS, 0) | TRAIN_LAUNCHES
    check(count == want, f"float32 training step ({loss_type}) launches "
                         f"{count}, want {want}")
    rel = {n: abs(n_dev[n] - n_cpu[n]) / max(n_cpu[n], 1e-12) for n in n_cpu}
    terms_rel = {k: abs(t_dev_terms[k] - v) / max(1.0, abs(v))
                 for k, v in t_cpu_terms.items()}
    l_dev, l_cpu = t_dev_terms["loss"], t_cpu_terms["loss"]
    print(f"[model] float32 training step of Q2L({TEACHER_BACKBONE}, "
          f"'{loss_type}', fused_train, remat 'dots'"
          + (f", teacher_dim {TRAIN_TEACHER_DIM}, rates {TRAIN_RATES}"
             if teacher else "")
          + f"), full depth and width, batch 1, "
          f"drop rates 0, card (K6) vs CPU (plain versions): loss "
          f"{l_dev:.6f} vs {l_cpu:.6f}; gradient norms card / CPU "
          + ", ".join(f"{n} {n_dev[n]:.6e} / {n_cpu[n]:.6e}" for n in n_cpu)
          + f"; relative differences: loss terms "
          f"{ {k: float(f'{r:.2e}') for k, r in terms_rel.items()} } (tol "
          f"{TRAIN_F32_LOSS_REL:g}), gradient norms "
          f"{ {n: float(f'{r:.2e}') for n, r in rel.items()} } (tol "
          f"{TRAIN_F32_GRAD_REL:g}); launches "
          f"{ {k: v for k, v in count.items() if v} }; CPU step "
          f"{t_cpu:.2f} s, card step {t_dev:.2f} s (host clock)")
    for k, r in terms_rel.items():
        check(r <= TRAIN_F32_LOSS_REL,
              f"float32 training step ({loss_type}), card vs CPU: {k} "
              f"differs by {r} > {TRAIN_F32_LOSS_REL}")
    if teacher:
        check({"soft_loss", "kd_loss"} <= set(t_dev_terms),
              f"training step (all): metrics {sorted(t_dev_terms)}")
        card_vs_cpu(f"float32 Q2L({TEACHER_BACKBONE}, 'all') eval forward "
                    f"with teacher features,",
                    [(f"kd {k}", kd_dev[k], kd_cpu[k]) for k in "ivt"],
                    TEACHER_MODEL_REL_TOL)
    for name, r in rel.items():
        check(np.isfinite(r) and r <= TRAIN_F32_GRAD_REL,
              f"float32 training step ({loss_type}), card vs CPU: the "
              f"gradient norm of {name} differs by {r} (relative) > "
              f"{TRAIN_F32_GRAD_REL}")


def phase_train(card: str) -> tuple:
    """The main path of training: ``make_spatial_train_step`` on the bf16
    Swin-L-384 Q2L teacher (remat "dots") with ``fused_train`` (K6) and
    without it (the plain plan), at batch 8 on one fixed batch of seeded
    frames and multi-hot labels, the same weights and generator seed,
    TRAIN_STEPS steps each in turns: launches of each kernel per step, ms
    per step, frames/s, peak device memory, the losses (finite, falling,
    the two plans' within TRAIN_LOSS_REL of each other); then the trained
    module's eval forward through ``make_spatial_eval_step`` (K5, K3 + K4,
    no K6) against the plain eval plan at the same parameters. Returns the
    launches of the run, the fused state and the batch."""
    from computervision_codes_tpu_torch.models.q2l import Q2L
    from computervision_codes_tpu_torch.train import make_spatial_eval_step

    batch = train_inputs(TRAIN_BATCH, TRAIN_IMG, 12)
    setups = {"fused_train": train_setup(True, torch.bfloat16, DEVICE),
              "plain": train_setup(False, torch.bfloat16, DEVICE)}
    want = {"fused_train": dict.fromkeys(KERNELS, 0) | TRAIN_LAUNCHES
            | TRAIN_GEMMS,
            "plain": dict.fromkeys(KERNELS, 0)}
    labels = list(setups)
    losses = {label: [] for label in labels}
    ms = {label: [] for label in labels}
    peak = dict.fromkeys(labels, 0)
    for i in range(TRAIN_STEPS):
        for label in labels if i % 2 == 0 else labels[::-1]:
            state, step = setups[label]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = launches()
            (_, metrics), step_ms = timed_call(lambda: step(state, batch))
            count = launched_since(before)
            check(count == want[label], f"{label} training step {i}: "
                                        f"launches {count}, want "
                                        f"{want[label]}")
            peak[label] = max(peak[label], torch.cuda.max_memory_allocated())
            losses[label].append(metrics["loss"].item())
            check(all(bool(torch.isfinite(v)) for v in metrics.values()),
                  f"{label} training step {i}: non-finite metrics")
            ms[label].append(step_ms)
    timed = slice(TRAIN_WARM, TRAIN_WARM + TRAIN_TIMED)
    steady = {label: float(np.median(ms[label][timed])) for label in labels}
    for label in labels:
        curve = losses[label]
        check(np.mean(curve[-5:]) < np.mean(curve[:5]),
              f"{label} training loss does not fall: {curve}")
        print(f"[train] {label}: Q2L({TEACHER_BACKBONE}, 'i') bf16, remat "
              f"'dots', batch {TRAIN_BATCH} of {TRAIN_IMG}x{TRAIN_IMG}, SGD "
              f"1e-2 wd 1e-5: launches per step "
              f"{ {k: v for k, v in want[label].items() if v} }; ms per step "
              f"{[round(m, 3) for m in ms[label]]} (the first "
              f"{TRAIN_WARM} warm up); median of the next {TRAIN_TIMED} "
              f"{steady[label]:.3f} ms = "
              f"{TRAIN_BATCH / steady[label] * 1e3:.1f} frames/s; peak "
              f"device memory {peak[label] / 2**30:.2f} GiB (both plans' "
              f"states resident); losses {[round(v, 5) for v in curve]}; "
              f"{card}")
    diff = [abs(a - b) / max(1.0, abs(b)) for a, b in
            zip(losses["fused_train"], losses["plain"])]
    check(max(diff) <= TRAIN_LOSS_REL,
          f"fused_train and plain losses differ by {max(diff)} of max(1, "
          f"loss) > {TRAIN_LOSS_REL}")
    print(f"[train] fused_train against plain, in turns: "
          f"{steady['fused_train']:.3f} against {steady['plain']:.3f} ms per "
          f"step; losses within {max(diff):.2e} of max(1, loss) at every "
          f"step (tol {TRAIN_LOSS_REL:g}); {card}")

    # the trained module in eval: K5, K3 + K4, no K6; against the plain
    # eval plan (fused_eval=False) holding the same parameters
    state = setups["fused_train"][0]
    twin = Q2L(backbone=TEACHER_BACKBONE, loss_type="i",
               dtype=torch.bfloat16, fused_eval=False).to(DEVICE)
    before = launches()
    probs, feat = make_spatial_eval_step(state.model, device=DEVICE)(
        state, batch["image"])
    eval_count = launched_since(before)
    check(eval_count == dict.fromkeys(KERNELS, 0) | TEACHER_LAUNCHES
          | TEACHER_GEMMS,
          f"trained module's eval launches {eval_count}, want "
          f"{TEACHER_LAUNCHES | TEACHER_GEMMS}")
    ref_probs, ref_feat = make_spatial_eval_step(twin, device=DEVICE)(
        state, batch["image"])
    for name, got, ref in (("probabilities i", probs["i"], ref_probs["i"]),
                           ("feature", feat, ref_feat)):
        got, ref = got.float(), ref.float()
        check(bool(torch.isfinite(got).all()), f"eval {name}: non-finite")
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        corr = float(torch.corrcoef(torch.stack([got.flatten(),
                                                 ref.flatten()]))[0, 1])
        check(err <= TRAIN_EVAL_REL and corr >= TRAIN_EVAL_CORR,
              f"trained module eval {name} vs the plain eval plan: "
              f"{err:.3e} of max|ref|, correlation {corr:.6f}")
        print(f"[train] the trained module's eval forward (launches "
              f"{ {k: v for k, v in eval_count.items() if v} }) against the "
              f"plain eval plan, {name}: max difference {err:.2e} of "
              f"max|ref|, correlation {corr:.6f}")
    del twin, setups["plain"]
    return launches(), state, batch


def train_category(name: str) -> str:
    if "swin::" in name:
        return "K6 (the swin:: kernels of both branches)"
    if any(k in name.lower() for k in ("gemm", "cutlass", "xmma", "nvjet")):
        return ("GEMMs (cuBLAS: the plain backward, stage 3, the merges "
                "and the Q2L head)")
    return "elementwise, reductions and copies"


def train_breakdown(card: str, state, batch) -> None:
    """One fused training step under torch.profiler: device time by kind
    (K6, cuBLAS GEMMs, the rest) and the busy share."""
    from computervision_codes_tpu_torch.losses import TOOL_POS_WEIGHT
    from computervision_codes_tpu_torch.train import make_spatial_train_step

    step = make_spatial_train_step(state.model, "i",
                                   pos_weights={"i": TOOL_POS_WEIGHT},
                                   device=DEVICE)
    busy, rows = device_profile(card, "fused_train training step",
                                lambda: step(state, batch), 12)
    kinds = {}
    for dev_ms, count, name in rows:
        kind = train_category(name)
        t, c = kinds.get(kind, (0.0, 0))
        kinds[kind] = (t + dev_ms, c + count)
    for kind, (t, c) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"[breakdown] training step: {t:9.3f} ms ({100 * t / busy:.1f}"
              f"% of device busy) in {c} launches: {kind}; {card}")


def refused(fn, error, msg: str) -> None:
    """Checks that ``fn()`` raises ``error`` (a refused input)."""
    try:
        fn()
    except error:
        return
    fail(msg)


def check_int8w_paths(x, wq, s) -> None:
    """One call of P1's int8w and of its loop twin each add one product to
    their own path, in the wrappers' counts and in the C library's."""
    from computervision_codes_tpu_torch.ops import swin_gemm
    from computervision_codes_tpu_torch.scripts import int8_kernel_probe as p1

    lib = "int8_kernel_probe"
    for fn, path in ((p1.gemm_int8w_cuda, "wgmma"),
                     (p1.gemm_int8w_loop_cuda, "loop")):
        c0, w0 = swin_gemm.library_launches(lib), dict(swin_gemm.launches[lib])
        fn(x, wq, s)
        c1, w1 = swin_gemm.library_launches(lib), swin_gemm.launches[lib]
        got_c = {k: c1[k] - c0[k] for k in c1}
        got_w = {k: w1[k] - w0[k] for k in w1}
        want = dict.fromkeys(swin_gemm.PATHS, 0) | {path: 1}
        check(got_c == got_w == want,
              f"P1 int8w {fn.__name__}: C library counts {got_c}, wrappers "
              f"{got_w}, want {want}")


def phase_p1(card: str) -> dict:
    """P1: the int8 kernel probe's three kernels against their plain
    versions on the card at the probe's twelve shapes and ragged ones, int8
    bit for bit, bf16 and int8w within REL_TOL (int8w also with a scale per
    channel drawn from a seed); int8w (s = 1/16) times 16 equal to bf16 on
    the codes widened to bf16 bit for bit (the same wgmma sums, scaled by a
    power of two); all three (the Swin GEMM core) against the loops they ran
    on before, int8 bit for bit and bf16 and int8w with the outputs that
    differ counted; an M that ``blk`` does not divide and an N % 64 != 0 are
    refused. Then at each of the twelve shapes each variant on the core and
    on the loop, ``torch.matmul`` (bf16, and on the widened codes) and
    ``torch._int_mm`` (the int8 product alone, from codes) in turns, with
    the plain versions at P1_TIMED. Returns the kernels line's swin_gemm
    readings."""
    from computervision_codes_tpu_torch.ops.mlp_block import Q8Weight
    from computervision_codes_tpu_torch.scripts import int8_kernel_probe as p1

    cases = list(p1.SHAPES) + [(f"ragged {m}x{k}x{n} blk {blk}", m, k, n, blk)
                               for m, k, n, blk in P1_RAGGED]
    worst = {"bf16": (-1.0, None), "int8w": (-1.0, None),
             "int8w per channel": (-1.0, None)}
    differ, differ_w, timed_err = {}, {}, {}
    for seed, (what, m, k, n, blk) in enumerate(cases):
        x, w, wq, s = p1.probe_inputs(m, k, n, DEVICE, seed)
        w8 = Q8Weight(wq.t().contiguous(), s)
        if seed == 0:
            check_int8w_paths(x, wq, s)
        g = torch.Generator(device=DEVICE).manual_seed(1000 + seed)
        s_ch = 0.01 + torch.rand(1, n, generator=g, device=DEVICE)
        int8w = p1.gemm_int8w_cuda(x, wq, s)
        for tag, got, want in (
                ("bf16", p1.gemm_bf16_cuda(x, w),
                 p1.gemm_bf16_reference(x, w)),
                ("int8w", int8w, p1.gemm_int8w_reference(x, wq, s)),
                ("int8w per channel", p1.gemm_int8w_cuda(x, wq, s_ch),
                 p1.gemm_int8w_reference(x, wq, s_ch))):
            err, tol = compare(f"P1 {tag} {what}", got, want, torch.bfloat16)
            if err / tol >= worst[tag][0]:
                worst[tag] = (err / tol, (what, err, tol))
            if what == P1_TIMED:
                timed_err[tag] = err
            if tag == "bf16":
                differ[what] = new_vs_old(got, p1.gemm_bf16_loop_cuda(x, w))
        widened = p1.gemm_bf16_cuda(x, wq.to(torch.bfloat16))
        scaled = 16 * int8w.float()
        check(torch.equal(scaled, widened.float()),
              f"P1 int8w {what}: 16 x int8w (s = 1/16) differs from bf16 on "
              f"the widened codes in {int((scaled != widened.float()).sum())}"
              f" outputs, by up to "
              f"{(scaled - widened.float()).abs().max().item()}")
        differ_w[what] = new_vs_old(int8w, p1.gemm_int8w_loop_cuda(x, wq, s))
        got = p1.gemm_int8_cuda(x, w8, blk)
        want = p1.gemm_int8_reference(x, w8, blk)
        check(torch.equal(got, want),
              f"P1 int8 {what}: {int((got != want).sum())} outputs differ "
              f"from the plain version, by up to "
              f"{(got.float() - want.float()).abs().max().item()}")
        same_as_loop(f"P1 int8 {what}", got,
                     p1.gemm_int8_loop_cuda(x, w8, blk))
    x, w, wq, s = p1.probe_inputs(64, 64, 64, DEVICE)
    w8 = Q8Weight(wq.t().contiguous(), s)
    refused(lambda: p1.gemm_int8_cuda(x, w8, 24), ValueError,
            "P1 int8 took M = 64 with blk = 24")
    refused(lambda: p1.gemm_int8(x, w8, 24), ValueError,
            "P1's gemm_int8 took M = 64 with blk = 24")
    x, w, wq, s = p1.probe_inputs(64, 64, P1_REFUSED_N, DEVICE)
    w8 = Q8Weight(wq.t().contiguous(), s)
    for fn in (lambda: p1.gemm_bf16_cuda(x, w),
               lambda: p1.gemm_int8w_cuda(x, wq, s),
               lambda: p1.gemm_int8_cuda(x, w8, 32)):
        refused(fn, ValueError, f"P1 took N = {P1_REFUSED_N}")
    print(f"[kernels] P1 (int8 kernel probe) at the probe's "
          f"{len(p1.SHAPES)} shapes and {len(P1_RAGGED)} ragged ones "
          f"{P1_RAGGED}: int8 equal to the plain version bit for bit; bf16 "
          f"and int8w within {REL_TOL[torch.bfloat16]:g} x max|ref|, worst "
          f"(case, err, tol) bf16 {worst['bf16'][1]}, int8w "
          f"{worst['int8w'][1]}, int8w with a scale per channel "
          f"{worst['int8w per channel'][1]}; 16 x int8w (s = 1/16) equal to "
          f"bf16 on the widened codes bit for bit at every case; int8w on "
          f"the wgmma path and its loop twin on the loop, each one product "
          f"in the C library's counts and the wrappers'; M % blk != 0 and "
          f"N = {P1_REFUSED_N} raise ValueError; int8 on the Swin GEMM core "
          f"equal to the mma.sync loop's bit for bit; against the WMMA loop "
          f"(outputs that differ, largest difference) bf16 {differ}, int8w "
          f"{differ_w}; {card}")

    # times at the twelve shapes, core and loop in turns with the library
    rows = {}
    for what, m, k, n, blk in p1.SHAPES:
        x, w, wq, s = p1.probe_inputs(m, k, n, DEVICE, 99)
        w8 = Q8Weight(wq.t().contiguous(), s)
        wq_bf16 = wq.to(torch.bfloat16)
        codes = p1.quantize_blocks(x, blk)[0]
        fns = {"bf16": lambda: p1.gemm_bf16_cuda(x, w),
               "bf16_loop": lambda: p1.gemm_bf16_loop_cuda(x, w),
               "matmul": lambda: torch.matmul(x, w),
               "int8w": lambda: p1.gemm_int8w_cuda(x, wq, s),
               "int8w_loop": lambda: p1.gemm_int8w_loop_cuda(x, wq, s),
               "matmul_widened": lambda: torch.matmul(x, wq_bf16),
               "int8": lambda: p1.gemm_int8_cuda(x, w8, blk),
               "int8_loop": lambda: p1.gemm_int8_loop_cuda(x, w8, blk),
               "int_mm": lambda: torch._int_mm(codes, w8.codes.t())}
        if what == P1_TIMED:
            fns["plain"] = lambda: p1.gemm_bf16_reference(x, w)
            fns["int8w_plain"] = lambda: p1.gemm_int8w_reference(x, wq, s)
            fns["int8_plain"] = lambda: p1.gemm_int8_reference(x, w8, blk)
        ms, runs = in_turns(fns, dict.fromkeys(fns, 10))
        rows[what] = ms
        print(f"[kernels] swin_gemm time {what}: bf16 {ms['bf16']:.4f} ms "
              f"(loop {ms['bf16_loop']:.4f}, torch.matmul "
              f"{ms['matmul']:.4f}), int8w {ms['int8w']:.4f} ms (loop "
              f"{ms['int8w_loop']:.4f}, torch.matmul on the widened codes "
              f"{ms['matmul_widened']:.4f}), int8 {ms['int8']:.4f} ms, the "
              f"amax and quantize passes included (loop "
              f"{ms['int8_loop']:.4f}, torch._int_mm {ms['int_mm']:.4f}); "
              f"runs {runs}; {card}")
        del x, w, wq, wq_bf16, w8, codes
    what, m, k, n, blk = next(s for s in p1.SHAPES if s[0] == P1_TIMED)
    top = rows[what]
    ops = 2 * m * k * n
    int8_bound = bound(ops, m * k * 2 + k * n + 4 * n + 2 * m * n, "int8")
    int8w_bound = bound(ops, m * k * 2 + k * n + 4 * n + 2 * m * n, "bf16")
    return {"shape": what, "max_abs_err": timed_err["bf16"],
            "ms": top["bf16"], "plain_ms": top["plain"],
            **bound(ops, 2 * m * k + 2 * k * n + 2 * m * n, "bf16"),
            "library_ms": top["matmul"], "library": "torch.matmul, bf16",
            "loop_ms": top["bf16_loop"],
            "int8w": {"max_abs_err": timed_err["int8w"], "ms": top["int8w"],
                      "plain_ms": top["int8w_plain"],
                      "loop_ms": top["int8w_loop"], **int8w_bound,
                      "library_ms": top["matmul_widened"],
                      "library": "torch.matmul on the codes widened to bf16"},
            "int8": {"max_abs_err": 0.0, "ms": top["int8"],
                     "plain_ms": top["int8_plain"],
                     "loop_ms": top["int8_loop"], **int8_bound,
                     "library_ms": top["int_mm"],
                     "library": "torch._int_mm on the codes"},
            "ms_by_shape": {w_: {k_: round(v, 4) for k_, v in r.items()}
                            for w_, r in rows.items()}}


def phase_p2(card: str) -> dict:
    """P2: pack<g> and batched on the card at the probe's two stages and a
    window of 7, each with relative-position tables of std 0.02 and 0.5.
    The attention half alone (``res_add=False``) is held to the plain
    version's and to K3's within REL_TOL of its own largest magnitude: in
    the whole output the residual, tens of times larger, would hide a
    dropped bias or an unmasked key inside the tolerance. The whole output
    is held to theirs too. A group that does not divide the heads and a
    float32 x are refused. Then pack2 and batched at stage 1 and pack4 at
    stage 3 with their QKV and proj products on the Swin GEMM core and on
    the loop, in turns; returns those times."""
    from computervision_codes_tpu_torch.ops.window_mhsa import (
        window_mhsa_cuda, window_mhsa_reference)
    from computervision_codes_tpu_torch.scripts import swin_pack_probe as p2

    cases = [(what, b, hw, c, heads, groups, p2.WINDOW)
             for what, b, hw, c, heads, groups in p2.STAGES] + [P2_RAGGED]
    worst = {"branch": (-1.0, None), "y": (-1.0, None)}
    seed = 0
    for what, b, hw, c, heads, groups, w in cases:
        for std in P2_TABLE_STDS:
            seed += 1
            x, args = p2.stage_inputs(b, hw, c, heads, w, DEVICE, seed,
                                      table_std=std)
            kw = dict(window=w, num_heads=heads)
            for part, res_add in (("branch", False), ("y", True)):
                want = window_mhsa_reference(x, *args, None, res_add=res_add,
                                             **kw).float()
                k3 = window_mhsa_cuda(x, *args, None, res_add=res_add,
                                      **kw).float()
                tol = REL_TOL[torch.bfloat16] * want.abs().max().item()
                outs = {f"pack{g}": p2.mhsa_pack_cuda(
                    x, *args, group=g, res_add=res_add, **kw)
                    for g in groups}
                outs["batched"] = p2.mhsa_batched_cuda(
                    x, *args, res_add=res_add, **kw)
                for tag, got in outs.items():
                    got = got.float()
                    tagged = f"P2 {tag} {part} {what}, table std {std}"
                    check(bool(torch.isfinite(got).all()),
                          f"{tagged}: non-finite output")
                    err = (got - want).abs().max().item()
                    err_k3 = (got - k3).abs().max().item()
                    check(err <= tol and err_k3 <= tol,
                          f"{tagged}: max_abs_err {err} from the plain "
                          f"version, {err_k3} from K3's > tol {tol}")
                    if err / tol >= worst[part][0]:
                        worst[part] = (err / tol, (what, std, tag, err,
                                                   err_k3, tol))
        del x, args, want, k3, outs
    what, b, hw, c, heads, groups, w = cases[0]
    x, args = p2.stage_inputs(1, w, c, heads, w, DEVICE)
    kw = dict(window=w, num_heads=heads)
    refused(lambda: p2.mhsa_pack(x, *args, group=4, **kw), ValueError,
            f"P2 took group 4 of {heads} heads")
    refused(lambda: p2.mhsa_pack_cuda(x.float(), *(a.float() for a in args),
                                      group=2, **kw),
            TypeError, "P2 took a float32 x")
    # the kernel's chunks: six heads' q, k, v (34,560 bytes each at w = 12)
    # fit the H100's 227 KB a block, twelve at w = 7 (N pads to 64)
    chunks = {(g, w): p2.staged_heads(g, w)
              for g, w in ((2, 12), (3, 12), (6, 12), (8, 12), (24, 12),
                           (24, 7))}
    check(list(chunks.values()) == [2, 3, 6, 4, 6, 12],
          f"P2 staged heads (group, window) -> chunk: {chunks}")
    print(f"[kernels] P2 (window-MHSA head grouping) at "
          f"{[case[0] for case in cases]} with relative-position tables of "
          f"std {P2_TABLE_STDS}, each pack<g> and batched: the attention "
          f"half (res_add=False) and the whole output within "
          f"{REL_TOL[torch.bfloat16]:g} x max|ref| of the plain version's "
          f"and of K3's; worst (case, std, tag, err, err against K3, tol) "
          f"half {worst['branch'][1]}, whole {worst['y'][1]}; a group not "
          f"dividing the heads raises ValueError, a float32 x TypeError; "
          f"heads staged at once (group, window) -> chunk {chunks}; {card}")

    loops = {}
    for (what, b, hw, c, heads, _), g in ((p2.STAGES[0], 2),
                                          (p2.STAGES[0], 0),
                                          (p2.STAGES[1], 4)):
        x, args = p2.stage_inputs(b, hw, c, heads, p2.WINDOW, DEVICE)
        tag, g = (f"pack{g}", g) if g else ("batched", heads)
        kw = dict(window=p2.WINDOW, num_heads=heads, group=g)
        ms, runs = in_turns(
            {"kernel": lambda: p2.mhsa_pack_cuda(x, *args, **kw),
             "loop": lambda: p2.mhsa_pack_loop_cuda(x, *args, **kw)},
            {"kernel": 20, "loop": 20})
        loops[f"{what} {tag}"] = ms
        print(f"[kernels] P2 time {what} {tag}: its products on the Swin "
              f"GEMM core {ms['kernel']:.4f} ms, on the loop "
              f"{ms['loop']:.4f} ms; runs {runs}; {card}")
        del x, args
    return loops


def phase_probes(card: str) -> tuple:
    """The probe drivers as a user runs them: ``main()`` of
    ``int8_kernel_probe`` and of ``swin_pack_probe`` at their own shapes on
    the card, each row's output held to its plain version (int8 bit for
    bit, the rest within REL_TOL). Returns the rows of each."""
    from computervision_codes_tpu_torch.scripts import int8_kernel_probe
    from computervision_codes_tpu_torch.scripts import swin_pack_probe

    rows = {}
    for name, probe, want in (("int8_kernel_probe", int8_kernel_probe,
                               3 * len(int8_kernel_probe.SHAPES)),
                              ("swin_pack_probe", swin_pack_probe,
                               sum(len(stage[-1]) + 2
                                   for stage in swin_pack_probe.STAGES))):
        t0 = time.perf_counter()
        rows[name] = probe.main([])
        check(len(rows[name]) == want, f"{name}: {len(rows[name])} rows")
        for r in rows[name]:
            tol = REL_TOL[torch.bfloat16] * max(1.0, r["max_abs_ref"])
            if r["metric"].endswith(" int8"):
                tol = 0.0
            check(np.isfinite(r["ms"]) and r["ms"] > 0,
                  f"{name} {r['metric']}: ms {r['ms']}")
            check(r["max_abs_err"] <= tol, f"{name} {r['metric']}: "
                  f"max_abs_err {r['max_abs_err']} > tol {tol}")
        print(f"[probes] {name}.main(): {len(rows[name])} rows, each within "
              f"tolerance of its plain version (int8 rows bit for bit), "
              f"{time.perf_counter() - t0:.1f} s; {card}")
    return rows["int8_kernel_probe"], rows["swin_pack_probe"]


def check_probe_paths() -> None:
    """The probe drivers ran P1's products (int8w's among them) on the
    wgmma path only."""
    from computervision_codes_tpu_torch.ops import swin_gemm

    got = swin_gemm.launches["int8_kernel_probe"]
    check(got["wgmma"] > 0 and got["loop"] == got["fma"] == 0,
          f"probe drivers: P1's products per path {got}")


def probe_entries(p1_rows: list, p2_rows: list, p1_loops: dict,
                  p2_loops: dict) -> dict:
    """The kernels line's P1 and P2 entries, from the probe drivers' rows:
    P1 at P1_TIMED, P2 at stage 1 (pack2 and batched), each with its times
    at the other shapes beside, and the loop's times from phase_p1 and
    phase_p2 (another call of the same shape)."""
    def entry(r, library):
        return {"shape": r["metric"], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": library}

    out = {}
    by = {r["metric"]: r for r in p1_rows}
    for tag in ("bf16", "int8w", "int8"):
        r = by[f"{P1_TIMED} {tag}"]
        out[f"probe_gemm_{tag}"] = entry(r, r["lib_ms"]) | {
            "library": {"bf16": "torch.matmul, bf16",
                        "int8w": "torch.matmul on the codes widened to bf16",
                        "int8": "torch._int_mm on the codes (the GEMM "
                                "alone)"}[tag],
            "ms_by_shape": {q["metric"]: [q["ms"], q["lib_ms"]]
                            for q in p1_rows
                            if q["metric"].endswith(f" {tag}")},
            "loop_ms": p1_loops[P1_TIMED][f"{tag}_loop"]}
    by = {r["metric"]: r for r in p2_rows}
    stage, pack = P2_TIMED
    for name, tag in (("mhsa_pack", pack), ("mhsa_batched", "batched")):
        out[name] = entry(by[f"{stage} {tag}"], None) | {
            "ms_by_stage": {q["metric"]: q["ms"] for q in p2_rows},
            "loop_ms": p2_loops[f"{stage} {tag}"]["loop"]}
    return out


def write_frames(directory: Path, frames, level: int,
                 filter_type: int | None = None) -> list:
    """Write each (H, W, 3) uint8 frame as ``<i:06d>.png`` on one thread
    per CPU (zlib releases the GIL); returns the paths in order."""
    from concurrent.futures import ThreadPoolExecutor

    from computervision_codes_tpu_torch.data.synthetic import write_png

    directory.mkdir(parents=True)
    paths = [str(directory / f"{i:06d}.png") for i in range(len(frames))]
    with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:
        list(pool.map(lambda i: write_png(paths[i], frames[i], level,
                                          filter_type), range(len(frames))))
    return paths


def linked_dir(directory: Path, paths: list, n: int) -> Path:
    """A frame directory of ``n`` hard links that cycle through
    ``paths``."""
    directory.mkdir()
    for i in range(n):
        os.link(paths[i % len(paths)], directory / f"{i:06d}.png")
    return directory


def endoscope_frames(n: int, hw: tuple, seed: int) -> list:
    """``n`` synthetic frames: a smooth colour field with noise of +-8,
    panned one pixel a frame (views of one wider image). A stand-in for
    video frames: how close its PNG size and row-filter mix come to
    CholecT45's is not measured."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w + n].astype(np.float32)
    field = np.stack([128 + 100 * np.sin(xx / 41 + yy / 60),
                      128 + 80 * np.cos(yy / 53 + xx / 97),
                      100 + 50 * np.sin((xx + yy) / 90)], -1)
    noise = np.random.default_rng(seed).integers(-8, 9, field.shape)
    wide = np.clip(field + noise, 0, 255).astype(np.uint8)
    return [wide[:, i:i + w] for i in range(n)]


def counted(label: str, fn, want: dict, form: str, calls: list):
    """``fn`` wrapped: each call's launches must equal ``want`` (Q1's on
    ``form``, each after a quantize pass); appends each call's host ms."""
    def call(*args):
        before, q1_before = launches(), q1_launches()
        t0 = time.perf_counter()
        out = fn(*args)
        calls.append((time.perf_counter() - t0) * 1e3)
        count = launched_since(before)
        what = f"{label} {len(calls)}"
        check(count == want, f"{what}: launches {count}, want {want}")
        check_q1_paths(q1_before, want["qconv_bn"], form, what)
        return out
    return call


@contextlib.contextmanager
def capture_sessions(cls, method: str, label: str, want: dict, into: list,
                     calls: list):
    """While open, each session that ``cls.create`` makes is appended to
    ``into``, its ``method`` wrapped by ``counted``."""
    original = cls.__dict__["create"]

    def create(klass, *args, **kw):
        sess = original.__get__(None, klass)(*args, **kw)
        setattr(sess, method,
                counted(label, getattr(sess, method), want, "conv", calls))
        into.append(sess)
        return sess

    cls.create = classmethod(create)
    try:
        yield
    finally:
        cls.create = original


SPATIAL_STEPS = ("make_spatial_train_step", "make_spatial_eval_step")


@contextlib.contextmanager
def timed_steps(module, events: dict, names: tuple = SPATIAL_STEPS):
    """While open, each train and eval step that ``module`` (a driver)
    makes with its step factories ``names`` (train, eval) records a CUDA
    event on the current stream as it is called and one as it returns,
    with the call's ms on the host clock, into ``events["train"]`` and
    ``events["eval"]``: nothing synchronises, so the host runs ahead of the
    card as the driver runs it alone."""
    made = {kind: getattr(module, name)
            for kind, name in zip(("train", "eval"), names)}

    def wrap(kind, factory):
        def make(*args, **kw):
            step = factory(*args, **kw)

            def call(*a):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = step(*a)
                end.record()
                events.setdefault(kind, []).append(
                    (start, end, (time.perf_counter() - t0) * 1e3))
                return out
            return call
        return make

    for kind, name in zip(("train", "eval"), names):
        setattr(module, name, wrap(kind, made[kind]))
    try:
        yield
    finally:
        for kind, name in zip(("train", "eval"), names):
            setattr(module, name, made[kind])


def step_periods(pairs: list) -> list:
    """ms on the card's clock from each step's end to the next one's: the
    steady period of a loop, the card's idle gaps included."""
    return [a[1].elapsed_time(b[1]) for a, b in zip(pairs, pairs[1:])]


def driver_run(label: str, module, argv: list, want_step: dict,
               want_eval: dict, card: str, names: tuple = SPATIAL_STEPS,
               batch: int = 0, tag: str = "spatial") -> tuple:
    """``module.main(argv)`` on the card with its steps timed by events:
    every kernel's launches must be ``want_step`` per training step plus
    ``want_eval`` per eval forward, the Swin GEMM core's products on
    wgmma only; prints the training epoch's frames over the wall time of
    its loop (the driver's own ``train_seconds``), the median ms of a
    step's call on the host clock, the median period between steps and
    an eval forward's span on the card's clock, and the peak device
    memory. ``names``: the driver's step factories (``timed_steps``);
    ``batch``: the frames of a step (0: the driver's ``-b``; a temporal
    driver's steps take a clip each, whose frames the result counts);
    ``tag``: the lines' prefix. Returns (result, the steps' events by
    kind, launches)."""
    events = {}
    batch = batch or int(argv[argv.index("-b") + 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = path_launches()
    t0 = time.perf_counter()
    with timed_steps(module, events, names):
        result = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    now = path_launches()
    count = {k: now[k] - before[k] for k in now}
    steps, evals = len(events.get("train", [])), len(events.get("eval", []))
    want = {k: want_step.get(k, 0) * steps + want_eval.get(k, 0) * evals
            for k in launches()}
    check({k: count[k] for k in want} == want,
          f"{label}: launches {count} over {steps} steps and {evals} eval "
          f"forwards, want {want}")
    check(count["swin_gemm loop"] == count["swin_gemm fma"] == 0,
          f"{label}: Swin GEMM products off wgmma {count}")
    peak = torch.cuda.max_memory_allocated()
    periods = step_periods(events.get("train", []))
    step_ms = float(np.median(periods)) if periods else None
    host_ms = float(np.median([e[2] for e in events["train"][1:]])) \
        if periods else None
    spans = [e[0].elapsed_time(e[1]) for e in events.get("eval", [])]
    eval_ms = float(np.median(spans[1:])) if evals > 1 else None
    epoch_s = result.get("train_seconds", [])
    clips = result.get("train_frames")  # a temporal driver: a clip a step
    frames = sum(clips) if clips else steps * batch
    per_step = frames / steps if clips else batch
    print(f"[{tag}] {label}: {steps} training steps, {evals} eval "
          f"forwards of " + ("one video each" if clips else f"batch {batch}")
          + "; launches "
          f"{ {k: v for k, v in count.items() if v} }; "
          + (f"the epoch {frames} frames in "
             f"{sum(epoch_s):.3f} s of its training loop (host clock) = "
             f"{frames / sum(epoch_s):.1f} frames/s end to end; "
             if epoch_s else "")
          + "ms per training step, median after the first: a call on the "
          "host clock (no synchronise) "
          + (f"{host_ms:.3f}, " if host_ms else "-, ")
          + "between consecutive steps' ends on the card's clock "
          + (f"{step_ms:.3f} = {per_step / step_ms * 1e3:.1f} frames/s per "
             f"step" if step_ms else "-")
          + "; ms of an eval forward on the card's clock, median after "
          f"the first: "
          + (f"{eval_ms:.3f}" + ("" if clips else
                                  f" = {batch / eval_ms * 1e3:.1f} frames/s "
                                  f"of the batch") if eval_ms else "-")
          + f"; peak device memory {peak / 2**30:.2f} GiB; the run "
          f"{wall:.1f} s (host clock, model creation and decode included); "
          f"{card}")
    return result, events, count


def spatial_tree(root: str):
    """The phase's PNG tree and seeded teacher stores; returns the split."""
    from computervision_codes_tpu_torch.data.feature_store import (
        FeatureStore)
    from computervision_codes_tpu_torch.data.splits import resolve_split
    from computervision_codes_tpu_torch.data.synthetic import (
        synthetic_feature_dict, write_synthetic_dataset)

    split = resolve_split("cholect45-crossval", 1)
    write_synthetic_dataset(root, split.all_videos, SPATIAL_FRAMES,
                            height=TEACHER_IMG, width=TEACHER_IMG,
                            write_images=True)
    feats = f"{root}/data_feats"
    for i, k in enumerate(("i", "v", "t")):
        n = TASK_SIZES[k]
        FeatureStore(feats, "Res18").save(1, "feats", synthetic_feature_dict(
            split.all_videos, SPATIAL_FRAMES, TRAIN_TEACHER_DIM, seed=i),
            task=k)
        for version, seed in (("Res18TCN", 10 + i), ("Q2LMSTCT", 20 + i)):
            FeatureStore(feats, version).save(
                1, "pred", synthetic_feature_dict(
                    split.all_videos, SPATIAL_FRAMES, n, seed=seed), task=k)
    return split


def dump_check(label: str, path: str, split, dim: int) -> dict:
    """The driver's dump: every video, (SPATIAL_FRAMES, dim) finite
    float32."""
    import pickle

    with open(path, "rb") as f:
        feats = pickle.load(f)
    check(set(feats) == {v[3:] for v in split.all_videos},
          f"{label} dump: {len(feats)} videos")
    for v, a in feats.items():
        check(a.dtype == np.float32 and a.shape == (SPATIAL_FRAMES, dim)
              and bool(np.isfinite(a).all()),
              f"{label} dump {v}: {a.dtype} {a.shape} or non-finite")
    return feats


def finite_losses(label: str, result: dict) -> None:
    for epoch in result["train_loss"]:
        check(all(np.isfinite(v) for v in epoch.values()),
              f"{label}: non-finite loss terms {epoch}")


def phase_spatial_drivers(card: str) -> tuple:
    """Phase 16: the teacher's and the student's training drivers from one
    PNG tree (see SPATIAL_*). (a) cli.spatial_transformer ``-t -e -d``, then
    ``-e -d --quant_eval``, then ``--resume`` for one more epoch; (b)
    cli.spatial_cnn ``-t -e -d`` on (a)'s dump, then one epoch each of
    ``--optimizer sam`` and ``--qat`` and the QAT eval against a forward
    over the quantize -> dequantize weights. Returns the launches of (a)
    and of (b), each counted from 0."""
    import types

    from computervision_codes_tpu_torch.cli import spatial_cnn
    from computervision_codes_tpu_torch.cli import spatial_transformer
    from computervision_codes_tpu_torch.data.pipeline import (
        CholecDataset, video_eval_batches)
    from computervision_codes_tpu_torch.models.convert import (
        load_jax_variables)
    from computervision_codes_tpu_torch.models.qat import qat_convs
    from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
    from computervision_codes_tpu_torch.models.swin import swin_feature_dim
    from computervision_codes_tpu_torch.train import make_spatial_eval_step
    from computervision_codes_tpu_torch.train.checkpoint import (
        checkpoint_path, read_msgpack, restore_variables)

    dim = swin_feature_dim(TEACHER_BACKBONE)  # the teacher's feature

    t_phase = time.perf_counter()
    none = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as root:
        t0 = time.perf_counter()
        split = spatial_tree(root)
        write_s = time.perf_counter() - t0
        feats_root = f"{root}/data_feats"

        # (a) the teacher
        reset_launches()
        ckpt = f"{root}/ckpt_teacher"
        teacher = ["--data_dir", root, "--backbone", TEACHER_BACKBONE,
                   "--image_height", str(TEACHER_IMG), "--image_width",
                   str(TEACHER_IMG), "-b", str(SPATIAL_TEACHER_BATCH),
                   "--loss_type", "all", "--rates",
                   *map(str, TRAIN_RATES), "--teacher_dim",
                   str(TRAIN_TEACHER_DIM), "--dtype", "bfloat16",
                   "--fused_train", "--remat", "--device", DEVICE,
                   "--version", "Q2L", "--ckpt_root", ckpt]
        step_want = TRAIN_LAUNCHES | TRAIN_GEMMS
        eval_want = TEACHER_LAUNCHES | TEACHER_GEMMS
        res, events, _ = driver_run(
            "(a) teacher -t -e -d", spatial_transformer,
            teacher + ["-t", "-e", "-d", "--epochs", "1"], step_want,
            eval_want, card)
        steps = res["step"]
        check(steps == -(-len(split.train) * SPATIAL_FRAMES
                         // SPATIAL_TEACHER_BATCH)
              and len(events["eval"]) == len(split.val) + len(split.test)
              + len(split.all_videos),
              f"(a) teacher: {steps} steps, {len(events['eval'])} eval "
              f"forwards")
        finite_losses("(a) teacher", res)
        check({"soft_loss", "kd_loss", "hard_loss"} <= set(
            res["train_loss"][0]), f"(a) teacher: metrics "
                                   f"{sorted(res['train_loss'][0])}")
        check(all(0.0 <= m <= 1.0 for m in res["test_mAP"].values()),
              f"(a) teacher: test mAP {res['test_mAP']}")
        dump = dump_check("(a) teacher", res["dump_path"], split, dim)
        print(f"[spatial] (a) teacher: loss terms {res['train_loss'][0]}; "
              f"test mAP {rounded(res['test_mAP'])}; "
              f"dump {len(dump)} videos of ({SPATIAL_FRAMES}, "
              f"{dim}) float32")
        q8_root = f"{root}/feats_q8"
        res3, _, _ = driver_run(
            "(a) teacher -e -d --quant_eval", spatial_transformer,
            teacher + ["-e", "-d", "--quant_eval", "--quant_min_dim",
                       str(SPATIAL_QUANT_MIN_DIM), "--feats_dir", q8_root],
            {}, SPATIAL_Q8_LAUNCHES | TEACHER_GEMMS, card)
        check(all(0.0 <= m <= 1.0 for m in res3["test_mAP"].values()),
              f"(a) --quant_eval: test mAP {res3['test_mAP']}")
        # the int8 dump against the float one, both from the best
        # checkpoint
        q8 = dump_check("(a) --quant_eval", res3["dump_path"], split, dim)
        a = np.concatenate([q8[v].ravel() for v in sorted(q8)])
        b = np.concatenate([dump[v].ravel() for v in sorted(q8)])
        corr = float(np.corrcoef(a, b)[0, 1])
        check(not np.array_equal(a, b), "(a) --quant_eval: the int8 dump "
                                        "equals the float one")
        print(f"[spatial] (a) --quant_eval: the int8 branches' dump against "
              f"the float dump from the same checkpoint: max difference "
              f"{float(np.abs(a - b).max()):.4e} of max|float| "
              f"{float(np.abs(b).max()):.4e}, correlation {corr:.6f}; test "
              f"mAP {rounded(res3['test_mAP'])}")
        res2, _, _ = driver_run(
            "(a) teacher --resume", spatial_transformer,
            teacher + ["-t", "--resume", "--epochs", "1"], step_want,
            eval_want, card)
        check(res2["step"] == 2 * steps,
              f"(a) teacher --resume: step {res2['step']}, want {2 * steps}")
        finite_losses("(a) teacher --resume", res2)
        check_gemm_counts("(a) the teacher's driver")
        check_attn_counts("(a) the teacher's driver")
        teacher_launches = path_launches()

        # (b) the student, on the teacher's feature bus: its "all" dump
        # stands for each task's
        reset_launches()
        for k in ("i", "v", "t"):
            os.symlink(res["dump_path"], f"{feats_root}/run_Q2L/k1_{k}_"
                                         f"feats.pkl")
        student = ["--data_dir", root, "--loss_type", "all", "--rates",
                   *map(str, TRAIN_RATES), "--teacher_dim", str(dim),
                   "-b", str(SPATIAL_STUDENT_BATCH), "--epochs", "1",
                   "--device", DEVICE]
        model_name = "rendezvous_lcholect45-crossval_cholect1"
        runs = {}
        for label, extra in (("-t -e -d", ["-t", "-e", "-d"]),
                             ("--optimizer sam", ["-t", "--optimizer",
                                                  "sam"]),
                             ("--qat", ["-t", "-e", "--qat"])):
            out = f"{root}/ckpt_student_{len(runs)}"
            res, _, _ = driver_run(f"(b) student {label}", spatial_cnn,
                                   student + extra + ["--ckpt_root", out],
                                   {}, {}, card)
            finite_losses(f"(b) student {label}", res)
            stats = read_msgpack(checkpoint_path(
                f"{out}/run_", model_name, "latest"))["batch_stats"]
            means = np.concatenate([np.asarray(n["mean"]).ravel() for n in
                                    nodes_with(stats, "mean")])
            check(bool(np.isfinite(means).all()) and np.abs(means).max() > 0,
                  f"(b) student {label}: running means not moved or "
                  f"non-finite")
            print(f"[spatial] (b) student {label}: loss terms "
                  f"{res['train_loss'][0]}; running means moved (max "
                  f"|mean| {np.abs(means).max():.4e}, finite)"
                  + (f"; test mAP {rounded(res['test_mAP'])}"
                     if "test_mAP" in res else ""))
            runs[label] = (res, out)
        dump_check("(b) student", runs["-t -e -d"][0]["dump_path"], split,
                   SPATIAL_STUDENT_DIM)

        # the --qat eval is a forward over the quantize -> dequantize
        # weights, computed here without the port's quantizer
        out = runs["--qat"][1]
        variables = restore_variables(checkpoint_path(f"{out}/run_",
                                                      model_name))
        model = load_jax_variables(SpatialCNN(
            "resnet18", "all", teacher_dim=dim), variables).to(DEVICE)
        twin = copy.deepcopy(model)
        with torch.no_grad():
            for conv in qat_convs(twin.backbone):
                w = conv.weight
                scale = w.abs().amax(dim=(1, 2, 3), keepdim=True)
                scale = scale.clamp_min(1e-8) / 127.0
                conv.weight.copy_(torch.round(w / scale).clamp(-127, 127)
                                  * scale)
        ds = CholecDataset(root, image_size=(256, 448))
        images = next(video_eval_batches(ds, split.test[0],
                                         SPATIAL_STUDENT_BATCH))["image"]
        probs, _ = make_spatial_eval_step(model, qat=True, device=DEVICE)(
            types.SimpleNamespace(model=model), images)
        ref, _ = make_spatial_eval_step(twin, device=DEVICE)(
            types.SimpleNamespace(model=twin), images)
        float_probs, _ = make_spatial_eval_step(model, device=DEVICE)(
            types.SimpleNamespace(model=model), images)
        err = max((probs[k] - ref[k]).abs().max().item() for k in probs)
        moved = max((probs[k] - float_probs[k]).abs().max().item()
                    for k in probs)
        check(err <= SPATIAL_QAT_ATOL and moved > 0,
              f"(b) --qat eval against the dequantized weights' forward: "
              f"{err} (tol {SPATIAL_QAT_ATOL}); against the float weights "
              f"{moved}")
        print(f"[spatial] (b) --qat eval against a forward over the "
              f"quantize -> dequantize weights: max |probability "
              f"difference| {err:.3e} (tol {SPATIAL_QAT_ATOL:g}); against "
              f"the float weights {moved:.3e}")
        student_launches = path_launches()
        check({k: student_launches[k] for k in none} == none
              and all(v == 0 for k, v in student_launches.items()
                      if k.startswith(("swin_gemm", "qconv_bn"))),
              f"(b) the student's path launched kernels "
              f"{ {k: v for k, v in student_launches.items() if v} }")
    print(f"[spatial] phase 16 wall time {time.perf_counter() - t_phase:.1f}"
          f" s (host clock), writing the tree {write_s:.1f} s of it; {card}")
    return teacher_launches, student_launches


TCN_PATH = ("the temporal TCN driver (cli.temporal_tcn: tenco -t -e --mask, "
            "TCN_black -t -e and --resume; float32, K1 in eval only)")
TERL_PATH = ("TERL's learnT driver (cli.terl_learnt -t -e with and without "
             "--fused_train, --ht, --cam_dump; Swin-T 224, bf16)")
TCN_LENGTHS = tuple(int(t) for t in np.linspace(1000, 6000, 45))
TCN_DIM = 512  # the spatial student's pooled feature
TCN_STEPS = ("make_loss_type_train_step", "make_tcn_eval_step")
TCN_EVAL_LAUNCHES = {"dilated_residual": LAYERS_PER_FORWARD}
TCN_MODEL_T = 1000  # card vs CPU: one eval forward and one step
# the driver runs' peak learning rate (-l): at the reference's 0.01 the
# 41-layer TCN's first losses on random features are in the hundreds and
# its SGD diverges to NaN within a few steps, in both packages (CPU runs of
# their train steps); 0.001 trains
TCN_LR = 0.001
TERL_BACKBONE, TERL_IMG, TERL_FRAMES, TERL_BATCH = "swin_T_224_1k", 224, 4, 32
TERL_QUEUE = 16384
TERL_STEPS = ("make_terl_train_step", "make_terl_eval_step")
# Swin-T's 12 blocks, window 7: K3 + K4 in every eval forward (the key
# module's too); K6's two branches in the query forward under --fused_train
TERL_EVAL_LAUNCHES = {"window_mhsa": 12, "mlp_block": 12, "window_attn": 12,
                      "swin_gemm": 48}
TERL_FUSED_STEP = {"window_mhsa_branch": 12, "mlp_block_branch": 12,
                   "window_mhsa": 12, "mlp_block": 12, "window_attn": 24,
                   "swin_gemm": 96}
TERL_MODEL_BATCH = 2  # card vs CPU: one float32 kcl_k=0 step


def tcn_tree(root: str):
    """The TCN phase's CSV tree and seeded 512-d feature store ("Res18"),
    videos of TCN_LENGTHS frames, each with two frozen pairs (equal
    consecutive rows, which --dedup_black drops); returns the split. The
    features are non-negative, as the spatial student's pooled post-ReLU
    features are."""
    from computervision_codes_tpu_torch.data.feature_store import (
        FeatureStore)
    from computervision_codes_tpu_torch.data.splits import resolve_split
    from computervision_codes_tpu_torch.data.synthetic import (
        synthetic_feature_dict, write_synthetic_dataset)

    split = resolve_split("cholect45-crossval", 1)
    write_synthetic_dataset(root, split.all_videos, list(TCN_LENGTHS))
    feats = synthetic_feature_dict(split.all_videos, list(TCN_LENGTHS),
                                   TCN_DIM, seed=8)
    for f in feats.values():
        np.maximum(f, 0, out=f)  # post-ReLU, as a ResNet's pooled features
        f[101] = f[100]
        f[501] = f[500]
    FeatureStore(f"{root}/data_feats", "Res18").save(1, "feats", feats)
    return split


def phase_model_tcn() -> None:
    """The full-width TCN (512 maps, 11 + 3 x 10 layers), float32, on the
    card against the CPU: an eval forward (K1 on the card) and one
    training step with its dropouts and mask at 0 (the plain path on both:
    no K1 launch)."""
    from computervision_codes_tpu_torch.models import tcn as tcn_mod
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, make_tcn_train_step)

    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, TCN_MODEL_T, TCN_DIM)).astype(np.float32)
    batch = {"features": x} | {
        f"label_{k}": (rng.random((TCN_MODEL_T, n)) < 0.2).astype(
            np.float32) for k, n in TASK_SIZES.items()}
    readings = {}
    for device in ("cpu", DEVICE):
        model = tcn_mod.TemporalTCN(TCN_DIM, generator=torch.Generator()
                                    .manual_seed(0))
        model.mask_rate = model.channel_dropout = 0.0
        for m in model.modules():
            if isinstance(m, tcn_mod.DilatedResidualLayer):
                m.dropout = 0.0
        state = create_train_state(model, build_sgd(0.01, 1e-5),
                                   device=device)
        with torch.inference_mode():
            out = state.model.eval()(torch.from_numpy(x).to(device))
        probs = {k: torch.sigmoid(out[k][0]).float().cpu() for k in
                 TASK_SIZES}
        before = launches()
        t0 = time.perf_counter()
        _, metrics = make_tcn_train_step(model, device=device)(state, batch)
        loss = metrics["loss_total"].item()
        seconds = time.perf_counter() - t0
        count = launched_since(before)
        norm = float(torch.stack([p.grad.float().norm() for p in
                                  state.model.parameters()]).norm())
        readings[device] = (probs, loss, norm, count, seconds)
    (p_cpu, l_cpu, n_cpu, _, t_cpu), (p_dev, l_dev, n_dev, count, t_dev) = (
        readings["cpu"], readings[DEVICE])
    card_vs_cpu(f"full-width TCN eval forward, T={TCN_MODEL_T}, float32,",
                [(k, p_dev[k], p_cpu[k]) for k in TASK_SIZES], MODEL_REL_TOL)
    check(count == dict.fromkeys(KERNELS, 0),
          f"TCN training step launched {count}")
    loss_rel = abs(l_dev - l_cpu) / max(1.0, abs(l_cpu))
    norm_rel = abs(n_dev - n_cpu) / max(n_cpu, 1e-12)
    check(loss_rel <= TRAIN_F32_LOSS_REL and norm_rel <= TRAIN_F32_GRAD_REL,
          f"TCN training step card vs CPU: loss {l_dev} vs {l_cpu}, "
          f"gradient norm {n_dev} vs {n_cpu}")
    print(f"[model] float32 TCN training step (512 maps, 41 layers, T="
          f"{TCN_MODEL_T}, dropouts and mask 0, the plain path): loss "
          f"{l_dev:.6f} vs {l_cpu:.6f} (relative {loss_rel:.2e}, tol "
          f"{TRAIN_F32_LOSS_REL:g}), global gradient norm {n_dev:.6e} vs "
          f"{n_cpu:.6e} (relative {norm_rel:.2e}, tol "
          f"{TRAIN_F32_GRAD_REL:g}); no kernel launched; CPU step "
          f"{t_cpu:.2f} s, card step {t_dev:.2f} s (host clock)")


def phase_tcn_driver(card: str) -> dict:
    """The temporal TCN driver at full width (512-d features of videos of
    1,000-6,000 frames, 11 + 3 x 10 layers at 512 maps, float32): (a)
    MT4MTLKD's tenco mode ``-t -e --mask``, (b) TERL's TCN_black mode ``-t
    -e --dedup_black --loss_type single --weight_source balancing``, (c)
    (b) again with ``--resume``. K1 0 launches a training step (the plain
    path, as JAX trains) and 41 an eval forward. Returns the launches,
    counted from 0."""
    from computervision_codes_tpu_torch.cli import temporal_tcn

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as root:
        t0 = time.perf_counter()
        split = tcn_tree(root)
        write_s = time.perf_counter() - t0
        reset_launches()
        base = ["--data_dir", root, "--epochs", "1", "--device", DEVICE,
                "-l", *[str(TCN_LR)] * 3]
        runs = {"(a) tenco -t -e --mask": base + [
                    "-t", "-e", "--mask", "--ckpt_root", f"{root}/ck_a"],
                "(b) TCN_black -t -e": base + [
                    "-t", "-e", "--dedup_black", "--loss_type", "single",
                    "--weight_source", "balancing", "--ckpt_root",
                    f"{root}/ck_b"]}
        runs["(c) TCN_black --resume"] = runs["(b) TCN_black -t -e"] + [
            "--resume"]
        steps = {}
        for label, argv in runs.items():
            res, events, _ = driver_run(label, temporal_tcn, argv, {},
                                        TCN_EVAL_LAUNCHES, card, TCN_STEPS,
                                        batch=1, tag="tcn")
            finite_losses(label, res)
            check(len(events["eval"]) == len(split.val) + len(split.test),
                  f"{label}: {len(events['eval'])} eval forwards")
            check(all(0.0 <= m <= 1.0 for m in res["test_mAP"].values()),
                  f"{label}: test mAP {res['test_mAP']}")
            steps[label] = res["step"]
            frames = sum(res["train_frames"])
            print(f"[tcn] {label}: {res['step']} steps over {frames} clip "
                  f"frames ({frames / len(events['train']):.0f} a step), "
                  f"loss terms {res['train_loss'][0]}; test mAP "
                  f"{rounded(res['test_mAP'])}")
        check(steps["(c) TCN_black --resume"]
              == 2 * steps["(b) TCN_black -t -e"],
              f"--resume: steps {steps}")
        tcn = path_launches()
    print(f"[tcn] phase wall time {time.perf_counter() - t_phase:.1f} s "
          f"(host clock), writing the tree {write_s:.1f} s of it; {card}")
    return tcn


def terl_batch(rng, b: int) -> dict:
    """A seeded TERL training batch of ``b`` frames at TERL_IMG with two
    tail anchors a frame."""
    from computervision_codes_tpu_torch.models.moco import (
        select_tail_anchors)

    tails = np.zeros((b, 100), np.float32)
    for i in range(b):
        tails[i, rng.choice(100, 2, replace=False)] = 1
    s, c, v = select_tail_anchors(tails, 4 * b)
    lab = {k: (rng.random((b, n)) < 0.3).astype(np.float32)
           for k, n in TASK_SIZES.items() if k != "ivt"}
    return {"image1": rng.standard_normal((b, TERL_IMG, TERL_IMG, 3)).astype(
                np.float32),
            "image2": rng.standard_normal((b, TERL_IMG, TERL_IMG, 3)).astype(
                np.float32),
            "anchor_sample": s, "anchor_class": c, "anchor_valid": v,
            "label_ivt": np.maximum(tails, rng.random((b, 100)) < 0.05
                                    ).astype(np.float32),
            **{f"label_{k}": a for k, a in lab.items()}}


def phase_model_terl() -> None:
    """One float32 TERL step (Swin-T 224, moco_dim 768, a queue of
    TERL_QUEUE, --mlp, --fused_train, kcl_k 0, DropPath off: nothing is
    drawn) on the card against the CPU: the loss terms, the gradient
    norm, the enqueued keys."""
    from computervision_codes_tpu_torch.models import moco
    from computervision_codes_tpu_torch.models.common import DropPath
    from computervision_codes_tpu_torch.train import build_sgd
    from computervision_codes_tpu_torch.train.terl import (
        create_terl_state, make_terl_train_step)

    batch = terl_batch(np.random.default_rng(13), TERL_MODEL_BATCH)
    readings, queue0 = {}, None
    for device in ("cpu", DEVICE):
        model = moco.TERLModel(TERL_BACKBONE, 768, mlp=True,
                               fused_train=True,
                               generator=torch.Generator().manual_seed(0))
        for m in model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
        state = create_terl_state(model, build_sgd(0.01, 1e-5), seed=1,
                                  queue_size=TERL_QUEUE, device=device)
        # one queue for both: a CUDA generator draws other numbers
        if queue0 is None:
            queue0 = copy.deepcopy(state.queue.state_dict())
        else:
            state.queue.load_state_dict(queue0)
        ptr = int(state.queue.ptr)
        before = launches()
        t0 = time.perf_counter()
        _, metrics = make_terl_train_step(model, w_epoch=0, kcl_k=0)(
            state, batch, 0)
        terms = {k: v.item() for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        count = launched_since(before)
        norm = float(torch.stack([p.grad.float().norm() for p in
                                  state.model.parameters()]).norm())
        keys = state.queue.feats[ptr:int(state.queue.ptr)].float().cpu()
        readings[device] = (terms, norm, keys, count, seconds)
    (t_cpu, n_cpu, k_cpu, _, s_cpu), (t_dev, n_dev, k_dev, count, s_dev) = (
        readings["cpu"], readings[DEVICE])
    # float32: the products on the FMA loop, none counted as wgmma
    want = dict.fromkeys(KERNELS, 0) | TERL_FUSED_STEP | {"swin_gemm": 0}
    check(count == want, f"float32 TERL step launches {count}, want {want}")
    rel = {k: abs(t_dev[k] - v) / max(1.0, abs(v)) for k, v in t_cpu.items()}
    norm_rel = abs(n_dev - n_cpu) / max(n_cpu, 1e-12)
    check(all(r <= TRAIN_F32_LOSS_REL for r in rel.values())
          and norm_rel <= TRAIN_F32_GRAD_REL,
          f"TERL step card vs CPU: loss terms {t_dev} vs {t_cpu}, gradient "
          f"norm {n_dev} vs {n_cpu}")
    card_vs_cpu("float32 TERL step, the enqueued keys,",
                [("keys", k_dev, k_cpu)], MODEL_REL_TOL)
    print(f"[model] float32 TERL step ({TERL_BACKBONE} {TERL_IMG}, moco_dim "
          f"768, queue {TERL_QUEUE}, --mlp --fused_train, kcl_k 0, DropPath "
          f"off, batch {TERL_MODEL_BATCH}): loss terms card {t_dev} vs CPU "
          f"{t_cpu} (relative {max(rel.values()):.2e}, tol "
          f"{TRAIN_F32_LOSS_REL:g}); gradient norm {n_dev:.6e} vs "
          f"{n_cpu:.6e} (relative {norm_rel:.2e}); {len(k_dev)} keys "
          f"enqueued; launches { {k: v for k, v in count.items() if v} }; "
          f"CPU step {s_cpu:.2f} s, card step {s_dev:.2f} s (host clock)")


def phase_terl_driver(card: str) -> dict:
    """TERL's learnT driver at full width (Swin-T 224, moco_dim 768, a
    queue of 16384, --mlp, bf16) on synthetic PNG frames: (a) ``-t -e
    --fused_train`` (K6 in the query forward, K3 + K4 in the key module's
    and every eval forward), (b) ``-t -e`` (the query forward plain), (c)
    ``-t --ht``, (d) ``--cam_dump`` of the test frames. Returns the
    launches, counted from 0."""
    from computervision_codes_tpu_torch.cli import terl_learnt
    from computervision_codes_tpu_torch.data.splits import resolve_split
    from computervision_codes_tpu_torch.data.synthetic import (
        write_synthetic_dataset)

    t_phase = time.perf_counter()
    plain_step = {k: v for k, v in TERL_EVAL_LAUNCHES.items()}
    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as root:
        split = resolve_split("cholect45-crossval", 1)
        write_synthetic_dataset(root, split.all_videos, TERL_FRAMES,
                                height=TERL_IMG, width=TERL_IMG,
                                write_images=True)
        reset_launches()
        base = ["--data_dir", root, "--backbone", TERL_BACKBONE,
                "--img_size", str(TERL_IMG), "-b", str(TERL_BATCH),
                "--mlp", "--moco_k", str(TERL_QUEUE), "--epochs", "1",
                "--dtype", "bfloat16", "--device", DEVICE]
        runs = (("(a) -t -e --fused_train", ["-t", "-e", "--fused_train"],
                 TERL_FUSED_STEP, True),
                ("(b) -t -e", ["-t", "-e"], plain_step, True),
                ("(c) -t --ht", ["-t", "--ht"], plain_step, False))
        for i, (label, extra, step_want, tested) in enumerate(runs):
            res, events, _ = driver_run(
                label, terl_learnt, base + extra + [
                    "--ckpt_root", f"{root}/ck_{i}"], step_want,
                TERL_EVAL_LAUNCHES, card, TERL_STEPS, tag="terl")
            finite_losses(label, res)
            check(res["step"] == len(events["train"]) >= 1,
                  f"{label}: {res['step']} steps")
            print(f"[terl] {label}: loss terms {res['train_loss'][0]}"
                  + (f"; test mAP {rounded(res['test_mAP'])}" if tested
                     else ""))
        before = path_launches()
        cams = terl_learnt.main(base + ["--cam_dump", f"{root}/cams",
                                        "--ckpt_root", f"{root}/ck_1"])
        count = {k: v - before[k] for k, v in path_launches().items()}
        forwards = count["window_mhsa"] // 12
        check(forwards >= 1 and all(
            count[k] == v * forwards for k, v in TERL_EVAL_LAUNCHES.items()),
            f"(d) --cam_dump launches {count}")
        paths = cams["cam_paths"]
        check(len(paths) >= 4 and all(os.path.getsize(p) > 0 for p in paths),
              f"(d) --cam_dump wrote {len(paths)} overlays")
        print(f"[terl] (d) --cam_dump: {len(paths)} overlay PNGs over "
              f"{forwards} eval forwards")
        terl = path_launches()
    print(f"[terl] phase wall time {time.perf_counter() - t_phase:.1f} s "
          f"(host clock); {card}")
    return terl


def rounded(table: dict) -> dict:
    return {k: round(v, 4) for k, v in table.items()}


def nodes_with(tree: dict, key: str):
    """The sub-dicts of a nested dict that hold ``key``."""
    if key in tree:
        yield tree
    for v in tree.values():
        if isinstance(v, dict):
            yield from nodes_with(v, key)


def phase_frames(card: str, teacher) -> tuple:
    """The frame source and the video inference CLI (see FRAMES_*):
    (a) cli.infer offline and --streaming, int8, from PNG files, against
    the session's own predict and push on the frames in memory; (b) the
    host's decode rates and cli.infer end to end beside the int8 predict
    alone; (c) evaluate_videos over a PNG tree with ``teacher``, and
    prefetch_to_device against the host batches. Returns the launches of
    the CLI's runs in (a) and (b), each run counted from 0, and of the
    dataset path ((c))."""
    from computervision_codes_tpu_torch.cli import infer
    from computervision_codes_tpu_torch.cli.common import evaluate_videos
    from computervision_codes_tpu_torch.data import native, pipeline
    from computervision_codes_tpu_torch.data.prefetch import (
        prefetch_to_device)
    from computervision_codes_tpu_torch.data.synthetic import (
        write_synthetic_dataset)
    from computervision_codes_tpu_torch.metrics import Recognition
    from computervision_codes_tpu_torch.serving import (InferenceSession,
                                                        StreamingSession)

    t_phase = time.perf_counter()
    cpus = len(os.sched_getaffinity(0))
    int8 = dict.fromkeys(KERNELS, 0) | {
        "dilated_residual": LAYERS_PER_FORWARD, "qconv_bn": INT8_CONVS}
    b, cl = FRAMES_SPAN
    span = b * cl
    h, w = FRAMES_HW
    flags = ["--batch", str(b), "--clip_len", str(cl), "--height", str(h),
             "--width", str(w), "--device", DEVICE, "--random_init",
             "--quantize"]
    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as tmp:
        root = Path(tmp)
        frames = np.random.default_rng(11).integers(
            0, 256, (FRAMES_VIDEO, h, w, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        paths = write_frames(root / "VID01", frames, level=1, filter_type=0)
        write_s = time.perf_counter() - t0
        kib_a = np.mean([os.path.getsize(p) for p in paths]) / 1024
        check(np.array_equal(native.decode_batch_u8(paths[:b], (h, w)),
                             frames[:b]),
              "decode_batch_u8 at the PNG's own size differs from the "
              "frames written")

        # the CLI's path: each cli.infer run counted from 0, and only those
        # runs (not the reference predicts and pushes between them); each
        # run creates one int8 session, whose calibration forward launches
        # Q1 once per convolution
        cli_launches, cli_calls_n = [], 0

        def cli_run(argv: list) -> dict:
            reset_launches()  # a run of the video inference CLI starts here
            out = infer.main(argv + flags)
            cli_launches.append(path_launches())
            return out

        # (a) offline, then the same session's predict on the frames
        sessions, calls = [], []
        with capture_sessions(InferenceSession, "predict",
                              "cli.infer offline predict", int8, sessions,
                              calls):
            res = cli_run(["--video", str(root / "VID01")])
        cli_calls = list(calls)
        cli_calls_n += len(calls)
        check(len(sessions) == 1 and len(calls) == -(-FRAMES_VIDEO // span),
              f"cli.infer offline: {len(sessions)} sessions, {len(calls)} "
              f"predicts")
        sess = sessions[0]
        want = {k: [] for k in TASK_SIZES}
        for start in range(0, FRAMES_VIDEO, span):
            clip = np.zeros((span, h, w, 3), np.uint8)
            n = len(frames[start:start + span])
            clip[:n] = frames[start:start + span]
            out = sess.predict(clip.reshape(b, cl, h, w, 3))
            for k in want:
                want[k].append(out[k].reshape(span, -1)[:n])
        for k, n_cls in TASK_SIZES.items():
            got, ref = res["probs"][k], np.concatenate(want[k])
            check(got.shape == (FRAMES_VIDEO, n_cls),
                  f"cli.infer offline {k}: shape {got.shape}")
            check(np.array_equal(got, ref),
                  f"cli.infer offline {k}: differs from the session's "
                  f"predict on the frames in memory by up to "
                  f"{np.abs(got - ref).max():.3g}")
        clip = frames[:span].reshape(b, cl, h, w, 3)
        predict_ms = [timed_call(lambda: sess.predict(clip))[1]
                      for _ in range(3)]
        predict_fps = span / float(np.median(predict_ms)) * 1e3
        print(f"[frames] (a) cli.infer offline --quantize over "
              f"{FRAMES_VIDEO} PNG frames of {h}x{w} (uniform noise, zlib "
              f"level 1, filter None, {kib_a:.1f} KiB each; "
              f"{len(cli_calls)} "
              f"predicts of {b}x{cl}, the last padded): probabilities equal "
              f"to the "
              f"session's predict on the frames in memory; launches per "
              f"predict {{K1 {LAYERS_PER_FORWARD}, Q1 {INT8_CONVS} (conv "
              f"path, each after a quantize pass), no loop}}; "
              f"{res['seconds']:.3f} s = "
              f"{FRAMES_VIDEO / res['seconds']:.1f} frames/s end to end; "
              f"ms per predict in the CLI "
              f"{[round(m, 3) for m in cli_calls]} (host clock; the first "
              f"warms up); {time.perf_counter() - t_phase:.1f} s into the "
              f"phase; {card}")

        # (a) --streaming over the first frames, then direct pushes
        sessions, calls = [], []
        with capture_sessions(StreamingSession, "push",
                              "cli.infer --streaming push", int8, sessions,
                              calls):
            res = cli_run(["--video", str(linked_dir(
                root / "stream", paths, FRAMES_STREAM)), "--streaming"])
        cli_calls_n += len(calls)
        check(len(sessions) == 1 and len(calls) == FRAMES_STREAM,
              f"cli.infer --streaming: {len(sessions)} sessions, "
              f"{len(calls)} pushes")
        sess = sessions[0]
        sess.reset()
        direct = [sess.push(f) for f in frames[:FRAMES_STREAM]]
        for k in TASK_SIZES:
            got, ref = res["probs"][k], np.stack([d[k] for d in direct])
            check(got.shape == ref.shape and np.array_equal(got, ref),
                  f"cli.infer --streaming {k}: differs from direct pushes")
        print(f"[frames] (a) cli.infer --streaming --quantize over "
              f"{FRAMES_STREAM} frames: equal to {FRAMES_STREAM} direct "
              f"pushes after reset(); launches per push as per predict; "
              f"median ms per push in the CLI "
              f"{float(np.median(calls[1:])):.3f} (host clock); "
              f"{time.perf_counter() - t_phase:.1f} s into the phase; {card}")
        del sessions, sess, direct

        # (b) the host's rates at CholecT45's frame size, warm reads, on
        # synthetic frames written with PIL's adaptive row filters
        rate = endoscope_frames(FRAMES_RATE_N, FRAMES_RATE_HW, 12)
        t0 = time.perf_counter()
        rate_paths = write_frames(root / "rate", rate, level=6)
        write_s += time.perf_counter() - t0
        kib = np.mean([os.path.getsize(p) for p in rate_paths]) / 1024
        decoded = native.decode_batch_u8(rate_paths, (h, w))  # warms cache
        for i in range(0, FRAMES_RATE_N, FRAMES_RATE_N // 4):
            check(np.array_equal(decoded[i], native.resize_u8(rate[i],
                                                              (h, w))),
                  f"decode_batch_u8 of frame {i} differs from resize_u8 of "
                  f"the frame written")
        fps = {}
        for threads in dict.fromkeys(FRAMES_DECODE_THREADS + (cpus,)):
            # a quarter of the frames on one thread: the rate is per frame
            some = rate_paths[:FRAMES_RATE_N // 4 if threads == 1 else None]
            t0 = time.perf_counter()
            native.decode_batch_u8(some, (h, w), n_threads=threads)
            fps[threads] = len(some) / (time.perf_counter() - t0)
        # one thread's ms per frame: the file read and inflate (Python's
        # zlib), then the unfilter, expansion and resize (the C library)
        t_inflate = t_c = 0.0
        out = np.empty((h, w, 3), np.uint8)
        mix = np.zeros(5, np.int64)  # the rows of each filter type
        for p in rate_paths[:FRAMES_RATE_N // 8]:
            t0 = time.perf_counter()
            png = native.read_png(p)
            t1 = time.perf_counter()
            native.png_to_u8(png, out)
            t_inflate += t1 - t0
            t_c += time.perf_counter() - t1
            mix += np.bincount(np.frombuffer(png.data, np.uint8)[
                ::1 + 3 * png.width], minlength=5)
        per = FRAMES_RATE_N // 8
        split = (f"read + inflate {t_inflate / per * 1e3:.2f} ms, unfilter "
                 f"+ resize {t_c / per * 1e3:.2f} ms per frame on one "
                 f"thread")
        try:
            native.VideoReader(str(root / "VID01.avi"))
            fail("VideoReader opened an MJPEG container without libjpeg")
        except RuntimeError as e:
            check("libjpeg" in str(e), f"VideoReader's refusal: {e}")
        sessions, calls = [], []
        with capture_sessions(InferenceSession, "predict",
                              "cli.infer offline predict, 854x480 frames",
                              int8, sessions, calls):
            res = cli_run(["--video", str(linked_dir(
                root / "e2e", rate_paths, FRAMES_E2E))])
        cli_calls_n += len(calls)
        check_probs({k: v[None] for k, v in res["probs"].items()},
                    (1, FRAMES_E2E), "cli.infer over 854x480 frames")
        e2e_fps = FRAMES_E2E / res["seconds"]
        del sessions
        shares = ", ".join(f"{name} {n / mix.sum():.1%}" for name, n in zip(
            ("None", "Sub", "Up", "Average", "Paeth"), mix))
        print(f"[frames] (b) {FRAMES_RATE_N} synthetic PNG frames of "
              f"{FRAMES_RATE_HW[0]}x{FRAMES_RATE_HW[1]} (endoscope_frames; "
              f"zlib level 6, each row's filter chosen as PIL's encoder "
              f"does: {shares} of the rows; {kib:.1f} KiB each; reads "
              f"warm) -> {h}x{w} "
              f"uint8: decode_batch_u8 frames/s "
              + ", ".join(f"{t} thread{'s' if t > 1 else ''} {f:.1f}"
                          for t, f in fps.items())
              + f" (host CPUs {cpus}; {split}); VideoReader.read_u8 not "
              f"measured "
              f"(MJPEG needs libjpeg, which the data plane lacks); "
              f"cli.infer --quantize end to end over {FRAMES_E2E} of them "
              f"(decode overlapped with predict) {e2e_fps:.1f} frames/s; "
              f"the same int8 session's predict alone "
              f"{predict_fps:.1f} frames/s ({np.median(predict_ms):.3f} ms "
              f"per {span} frames); {time.perf_counter() - t_phase:.1f} s "
              f"into the phase; {card}")
        infer_launches = {k: sum(p[k] for p in cli_launches)
                          for k in cli_launches[0]}
        want = {k: n * cli_calls_n for k, n in int8.items()}
        want["qconv_bn"] += INT8_CONVS * len(cli_launches)
        got = {k: infer_launches[k] for k in int8}
        check(got == want, f"the CLI's path over its {cli_calls_n} predicts "
              f"and pushes and {len(cli_launches)} calibrations: launches "
              f"{got}, want {want}")
        print(f"[frames] the CLI's path, its {len(cli_launches)} runs each "
              f"counted from 0: {cli_calls_n} predicts and pushes and "
              f"{len(cli_launches)} int8 calibration forwards (Q1 only), "
              f"launches { {k: v for k, v in got.items() if v} }; {card}")

        # (c) evaluate_videos over a PNG tree with the teacher session
        n, side = FRAMES_TREE
        tree = str(root / "tree")
        write_synthetic_dataset(tree, ["VID01"], frames_per_video=n,
                                height=side, width=side, write_images=True)
        ds = pipeline.CholecDataset(tree, image_size=(side, side))
        reset_launches()  # the dataset path starts here
        calls = []
        predict = counted("evaluate_videos teacher predict", teacher.predict,
                          dict.fromkeys(KERNELS, 0) | TEACHER_LAUNCHES
                          | TEACHER_GEMMS, "gemm", calls)
        metrics = {"i": Recognition(TASK_SIZES["i"])}
        t0 = time.perf_counter()
        evaluate_videos(lambda images: (predict(images), None), ds,
                        ["VID01"], teacher.batch, metrics)
        eval_s = time.perf_counter() - t0
        m_ap = metrics["i"].compute_video_AP()["mAP"]
        check(len(calls) == -(-n // teacher.batch) and np.isfinite(m_ap),
              f"evaluate_videos: {len(calls)} predicts, mAP {m_ap}")
        check_gemm_counts("dataset path")
        check_attn_counts("dataset path")
        dataset_launches = path_launches()
        for train in (False, True):
            host = list(pipeline.batch_iterator(ds, ["VID01"], teacher.batch,
                                                train=train, seed=3))
            moved = list(prefetch_to_device(iter(host), depth=2,
                                            device=DEVICE))
            check(len(moved) == len(host), f"prefetch: {len(moved)} batches")
            for hb, db in zip(host, moved):
                for k, v in hb.items():
                    t = db[k]
                    check(t.device.type == torch.device(DEVICE).type
                          and torch.equal(t.cpu(), torch.from_numpy(v)),
                          f"prefetch_to_device {k} (train={train}) differs "
                          f"from the host batch")
            check(bool(np.isfinite(host[0]["image"]).all()),
                  f"batch_iterator(train={train}): non-finite image")
        print(f"[frames] (c) evaluate_videos over {n} PNG frames of "
              f"{side}x{side} with the bf16 {TEACHER_BACKBONE} teacher at "
              f"batch {teacher.batch}: mAP(i) {m_ap:.4f}, launches per "
              f"predict as phase 7's ({len(calls)} predicts), "
              f"{eval_s:.3f} s; prefetch_to_device equal to the host "
              f"batches (eval and train); {card}")
    print(f"[frames] phase wall time {time.perf_counter() - t_phase:.1f} s "
          f"(host clock), writing frames {write_s:.1f} s of it")
    return infer_launches, dataset_launches


# ---------------------------------------------------------------------------
# the backbone zoo and augmentation on the device: the CvT-w24-384/Q2L
# teacher (its attention the plain version, as JAX computes it outside any
# Pallas kernel; its int8 Dense layers on Q1's TMA path), the int8-Dense
# TResNet-L-448 teacher session, the int8 TResNet-L-448 backbone
# (models.quant_tresnet: 85 convolutions a forward on Q1, 21 of them on the
# mma.sync loop as Cin 76 and 152 are no multiple of 16), the teacher
# driver's -t at both backbones, and --device_augment in the student's and
# TERL's drivers
CVT, CVT_IMG, CVT_BATCH = "cvt_w24", 384, 16
# Q1 calls per int8 CvT-w24 Q2L("i") predict: every Dense of >= 512 inputs,
# each call of it: stage 0's MLP Dense_1 (2 blocks), stage 1's q/k/v/proj
# and both MLP Dense (2 x 6), stage 2's q/k/v/proj once and its MLP's two
# Dense twice (the spatial and the cls tokens; 20 x 8), and Q2L's 19
CVT_Q8_DENSE = 2 + 12 + 160 + 19
TRESNET_Q8_DENSE = 19  # Q2L's Dense at d_model 2432; the SE layers < 512
CVT_MODEL_FRAMES, TRESNET_Q8_MODEL_FRAMES = 2, 2  # card against CPU
# the int8 TResNet-L on the card against its plain version on the CPU: both
# take the same static scales and Q1 equals its plain version bit for bit,
# but the float parts between (cuDNN's blur pool and float32 SE against the
# CPU's) may round differently and move a code by one; bf16's cross-device
# bound: within 4% of the largest magnitude, correlation > 0.999
TRESNET_Q8_CPU_REL, TRESNET_Q8_CPU_CORR = 0.04, 0.999
# the int8 backbone against the bf16 float one on the card (PTQ noise):
# the int8 ResNet's fidelity bounds (tests/test_quantized.py)
TRESNET_Q8_COS, TRESNET_Q8_REL = 0.99, 0.15
TRESNET_Q8_REPS = 10
ZOO_DRIVER_BATCH = 8
AUG_BATCH, AUG_HW = 32, (256, 448)  # the student's batch and geometry
AUG_REPS = 20
# the whole list card against CPU: a rotation's one-level difference then
# passes through the sharpness blend (x 1.6) and the contrast jitter (up to
# x 1.2): at most 4 levels, on at most 1e-3 of the values past one
AUG_LIST_LEVELS, AUG_LIST_SHARE = 4, 1e-3
# --device_augment: the student (ResNet18 256x448, batch 32, float32) and
# TERL (Swin-T 224, batch 32, bf16) on phase 16's PNG tree, each run
# without and with the flag, in turns (a, b, b, a)
AUG_DRIVER_ORDER = (False, True, True, False)
ZOO_CVT_PATH = ("teacher sessions: CvT-w24-384 Q2L bf16 and int8 (its "
                "attention the plain version; Q1 on the int8 Dense)")
ZOO_TRESNET_PATH = ("teacher session: TResNet-L-448 Q2L quantize=True (the "
                    "float TResNet on K9; Q1 on the int8 Dense)")
INT8_TRESNET_PATH = ("the int8 TResNet-L-448 backbone (models.quant_tresnet: "
                     "Q1 loop 21, cp.async 22, TMA 42 a forward) and "
                     "scripts.zoo_bench main()")
TERL_AUG_PATH = ("TERL's learnT driver -t without and with --device_augment "
                 "(Swin-T 224, bf16)")


def tresnet_convs(width: int, layers, img: int) -> list:
    """The int8 TResNet's convolutions in call order at img x img: (what,
    Cin, Cout, k, pad, H_in, slope or None); every one at stride 1 (a
    stride-2 block's blur pool and average pool take the stride)."""
    h, out, cin = img // 4, [], width
    out.append(("stem", 48, width, 3, 1, h, 1e-2))
    for si, depth in enumerate(layers):
        filters = width * 2 ** si
        bottleneck = si >= 2
        cout = filters * (4 if bottleneck else 1)
        for bi in range(depth):
            name = f"layer{si + 1}_{bi}"
            ho = (h + 1) // 2 if si > 0 and bi == 0 else h
            if bottleneck:
                out += [(f"{name}.conv1", cin, filters, 1, 0, h, 1e-3),
                        (f"{name}.conv2", filters, filters, 3, 1, h, 1e-3),
                        (f"{name}.conv3", filters, cout, 1, 0, ho, None)]
            else:
                out += [(f"{name}.conv1", cin, filters, 3, 1, h, 1e-3),
                        (f"{name}.conv2", filters, filters, 3, 1, ho, None)]
            if ho != h or cin != cout:
                out.append((f"{name}.downsample", cin, cout, 1, 0, ho, None))
            h, cin = ho, cout
    return out


def tresnet_q1_want(width: int, layers, img: int) -> dict:
    """Q1's path launches of one int8 TResNet forward."""
    from computervision_codes_tpu_torch.ops.quant import qconv_path

    want = dict.fromkeys(q1_path_wrappers(), 0)
    for _, cin, _, k, p, _, _ in tresnet_convs(width, layers, img):
        path = qconv_path(cin, k, k, 1, ((p, p), (p, p)))
        want[path] += 1
        want["quantize"] += path != "loop"
    return want


def phase_q1_tresnet(card: str) -> dict:
    """Q1 at each distinct convolution of the int8 TResNet-L-448, in bf16
    and float32, with no activation and the leaky epilogue at 1e-2 and
    1e-3: the path ``qconv_path`` picks (the loop where Cin % 16 != 0, a
    wgmma producer elsewhere) and the loop at every shape, against the
    plain version bit for bit; then, at the teacher's batch, each shape's
    time on its path, on the loop, and the plain version's, in turns,
    summed over a forward's 85 convolutions beside the bound."""
    from computervision_codes_tpu_torch.ops.quant import (
        activation_scale, qconv_bn_cuda, qconv_bn_reference,
        qconv_loop_cuda, qconv_path)

    from computervision_codes_tpu_torch.models.tresnet import VARIANTS

    spec = TRESNET_SPEC
    check(VARIANTS[TRESNET] == spec, f"{TRESNET}: {VARIANTS[TRESNET]}")
    convs = tresnet_convs(spec["width"], spec["layers"], TRESNET_IMG)
    check(len(convs) == 85, f"{len(convs)} TResNet-L int8 convs")
    shapes = {}
    for what, cin, cout, k, p, h, slope in convs:
        shapes.setdefault((cin, cout, k, p, h), [what, 0, set()])
        shapes[(cin, cout, k, p, h)][1] += 1
        shapes[(cin, cout, k, p, h)][2].add(slope)
    by_path = dict.fromkeys(("gemm", "conv", "loop"), 0)
    for seed, ((cin, cout, k, p, h), (what, count, _)) in enumerate(
            shapes.items()):
        pad = ((p, p), (p, p))
        path = qconv_path(cin, k, k, 1, pad)
        by_path[path] += count
        for dtype in (torch.bfloat16, torch.float32):
            x, w_q, mult, bias = qconv_inputs(Q1_CHECK_N, cin, cout, k, h, h,
                                              dtype, 500 + seed)
            s_act = activation_scale(x).reshape(1)
            for slope in (None, 1e-2, 1e-3):
                tag = (f"Q1 TResNet-L {str(dtype)[6:]} {what} {cin}->{cout} "
                       f"{k}x{k} at {h}x{h} slope {slope}")
                want = qconv_bn_reference(x, s_act, w_q, mult, bias, 1, pad,
                                          leaky_slope=slope, dtype=dtype)
                for name, fn, form in (("path", qconv_bn_cuda, path),
                                       ("loop", qconv_loop_cuda, "loop")):
                    before = q1_launches()
                    got = fn(x, s_act, w_q, mult, bias, 1, pad,
                             leaky_slope=slope, dtype=dtype)
                    check_q1_paths(before, 1, form, f"{tag} {name}")
                    check(torch.equal(got, want),
                          f"{tag} {name}: output differs by "
                          f"{(got.float() - want.float()).abs().max().item()}"
                          f" at {int((got != want).sum())} of {got.numel()}")
            del x, got, want
    print(f"[kernels] Q1 at the int8 TResNet-L-448's {len(shapes)} distinct "
          f"convolutions (85 a forward: {by_path}), N={Q1_CHECK_N}, bf16 and "
          f"float32, no activation and the leaky epilogue at 1e-2 and 1e-3: "
          f"the path qconv_path picks and the loop equal the plain version "
          f"bit for bit")

    total = {"path": 0.0, "loop": 0.0, "plain": 0.0}
    loop_convs = {"path": 0.0, "loop": 0.0}  # the 21 the loop serves
    work = {"ops": 0, "bytes": 0}
    n = TRESNET_BATCH
    for (cin, cout, k, p, h), (what, count, slopes) in shapes.items():
        pad = ((p, p), (p, p))
        path = qconv_path(cin, k, k, 1, pad)
        slope = max(s for s in slopes if s) if any(slopes) else None
        x, w_q, mult, bias = qconv_inputs(n, cin, cout, k, h, h,
                                          torch.bfloat16, seed=77)
        s_act = activation_scale(x).reshape(1)
        fns = {"path": lambda: qconv_bn_cuda(x, s_act, w_q, mult, bias, 1,
                                             pad, leaky_slope=slope),
               "loop": lambda: qconv_loop_cuda(x, s_act, w_q, mult, bias, 1,
                                               pad, leaky_slope=slope),
               "plain": lambda: qconv_bn_reference(
                   x, s_act, w_q, mult, bias, 1, pad, leaky_slope=slope)}
        ms, runs = in_turns(fns, {"path": 20, "loop": 20, "plain": 3})
        for name in total:
            total[name] += count * ms[name]
        if path == "loop":
            for name in loop_convs:
                loop_convs[name] += count * ms[name]
        macs = n * h * h * cout * k * k * cin
        work["ops"] += count * 2 * macs
        work["bytes"] += count * (2 * n * h * h * (cin + cout)
                                  + cout * k * k * cin + 8 * cout)
        print(f"[kernels] Q1 TResNet-L time N={n} {what} {cin}->{cout} "
              f"{k}x{k} at {h}x{h} (x{count} a forward, leaky {slope}): its "
              f"path ({path}) {ms['path']:.4f} ms "
              f"({2 * macs / ms['path'] / 1e9:.1f} TOP/s), loop "
              f"{ms['loop']:.4f} ms ({2 * macs / ms['loop'] / 1e9:.1f} "
              f"TOP/s), plain {ms['plain']:.4f} ms; runs {runs}; {card}")
        del x
    b = bound(work["ops"], work["bytes"], "int8")
    print(f"[kernels] Q1 per int8 TResNet-L-448 forward of {n} frames (85 "
          f"convs, in turns shape by shape): the paths qconv_path picks "
          f"{total['path']:.4f} ms ({b['bound_ms'] / total['path']:.1%} of "
          f"the {b['bound_ms']:.4f} ms bound, by {b['bound_by']}), every "
          f"conv on the loop {total['loop']:.4f} ms, plain "
          f"{total['plain']:.4f} ms; the {by_path['loop']} convs with Cin % "
          f"16 != 0 (the loop's live users) {loop_convs['path']:.4f} ms; "
          f"{card}")
    return {"tresnet_l_448": {
        "convs_by_path": by_path, "ms": round(total["path"], 4),
        "loop_only_ms": round(total["loop"], 4),
        "plain_ms": round(total["plain"], 4),
        "loop_convs_ms": round(loop_convs["path"], 4), **b}}


def zoo_frames(n: int, img: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, img, img, 3)).astype(np.float32))


def int8_tresnet(seed: int):
    """The bf16 TResNet-L on the card, BatchNorm drawn from ``seed``, and
    its int8 twin calibrated on 4 frames."""
    from computervision_codes_tpu_torch.models.quant_tresnet import (
        make_int8_tresnet)
    from computervision_codes_tpu_torch.models.tresnet import build_tresnet

    model = build_tresnet(TRESNET, torch.bfloat16,
                          torch.Generator().manual_seed(seed))
    randomize_bn(model, seed + 1)
    model = model.to(DEVICE).eval()
    cal = zoo_frames(4, TRESNET_IMG, seed + 2).to(DEVICE, torch.bfloat16)
    with torch.inference_mode():
        return model, make_int8_tresnet(TRESNET, model, cal)


def phase_model_zoo() -> None:
    """Card against CPU: the float32 CvT-w24 backbone at 384 on
    CVT_MODEL_FRAMES frames (no kernel of the port on it) and the int8
    TResNet-L-448 on TRESNET_Q8_MODEL_FRAMES frames (Q1 on the card, its
    plain version on the CPU, the same static scales)."""
    from computervision_codes_tpu_torch.models.cvt import build_cvt

    cpu_model = build_cvt(CVT, generator=torch.Generator().manual_seed(0))
    randomize_bn(cpu_model, 1)
    cpu_model.eval()
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    x = zoo_frames(CVT_MODEL_FRAMES, CVT_IMG, 2)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(x)
        t_cpu = time.perf_counter() - t0
        before = launches()
        got = dev_model(x.to(DEVICE))
        count = launched_since(before)
    check(count == dict.fromkeys(KERNELS, 0),
          f"CvT model launches {count}")
    card_vs_cpu(f"CvT float32 {CVT}", [(k, got[k], want[k]) for k in (
        "feature_map", "pooled", "pre_norm_cls")], TEACHER_MODEL_REL_TOL)
    print(f"[model] CvT float32 {CVT} at {CVT_IMG}: CPU forward of "
          f"{CVT_MODEL_FRAMES} frames {t_cpu:.2f} s (host clock)")
    del cpu_model, dev_model, got, want

    _, q = int8_tresnet(10)
    q_cpu = copy.deepcopy(q).cpu()
    x = zoo_frames(TRESNET_Q8_MODEL_FRAMES, TRESNET_IMG, 13)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = q_cpu(x)
        t_cpu = time.perf_counter() - t0
        before, q1_before = launches(), q1_launches()
        got = q(x.to(DEVICE))
        count = launched_since(before)
        now = q1_launches()
    q1 = {k: now[k] - q1_before[k] for k in now}
    want_q1 = tresnet_q1_want(**TRESNET_SPEC, img=TRESNET_IMG)
    check(count == dict.fromkeys(KERNELS, 0) | {"qconv_bn": 85}
          and q1 == want_q1, f"int8 TResNet launches {count}, Q1 by path "
                             f"{q1}, want {want_q1}")
    for name, g, w in [("pooled", got["pooled"], want["pooled"])] + [
            (f"stage {i + 1}", a, b) for i, (a, b) in enumerate(
                zip(got["stages"], want["stages"]))]:
        g, w = g.float().cpu(), w.float()
        err = (g - w).abs().max().item()
        top = w.abs().max().item()
        corr = float(np.corrcoef(g.numpy().ravel(), w.numpy().ravel())[0, 1])
        same = float((g == w).float().mean())
        check(err <= TRESNET_Q8_CPU_REL * top and corr > TRESNET_Q8_CPU_CORR,
              f"int8 TResNet {name}: card vs CPU max_abs_err {err} of "
              f"{top}, correlation {corr}")
        print(f"[model] int8 {TRESNET} {name}: card vs CPU max_abs_err "
              f"{err:.3e} of max|ref| {top:.3f} (tol "
              f"{TRESNET_Q8_CPU_REL:g}), correlation {corr:.6f}, equal "
              f"{same:.2%}")
    print(f"[model] int8 {TRESNET}: Q1 by path per forward {q1}; CPU plain "
          f"forward of {TRESNET_Q8_MODEL_FRAMES} frames {t_cpu:.2f} s (host "
          f"clock)")


def phase_int8_tresnet(card: str) -> None:
    """The int8 TResNet-L-448 backbone at the teacher's batch: launches by
    Q1 path a forward, its pooled feature against the bf16 float
    backbone's (PTQ fidelity), both forwards' ms in turns and the peak
    memory; then scripts.zoo_bench's rows."""
    from computervision_codes_tpu_torch.scripts import zoo_bench

    model, q = int8_tresnet(20)
    x = zoo_frames(TRESNET_BATCH, TRESNET_IMG, 21).to(DEVICE, torch.bfloat16)
    with torch.inference_mode():
        before, q1_before = launches(), q1_launches()
        got = q(x)
        count = launched_since(before)
        now = q1_launches()
        ref = model(x)
    q1 = {k: now[k] - q1_before[k] for k in now}
    want_q1 = tresnet_q1_want(**TRESNET_SPEC, img=TRESNET_IMG)
    check(count == dict.fromkeys(KERNELS, 0) | {"qconv_bn": 85}
          and q1 == want_q1, f"int8 TResNet launches {count}, Q1 {q1}")
    g, r = got["pooled"].float(), ref["pooled"].float()
    cos = float(F.cosine_similarity(g.ravel(), r.ravel(), dim=0))
    rel = float((g - r).norm() / r.norm())
    check(bool(torch.isfinite(g).all()) and cos > TRESNET_Q8_COS
          and rel < TRESNET_Q8_REL, f"int8 TResNet pooled against bf16: cos "
                                    f"{cos}, rel {rel}")
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        q(x)
        peak = torch.cuda.max_memory_allocated() - resident
        ms, runs = in_turns({"int8": lambda: q(x), "bf16": lambda: model(x)},
                            {"int8": TRESNET_Q8_REPS,
                             "bf16": TRESNET_Q8_REPS})
    print(f"[int8 tresnet] {TRESNET} {TRESNET_BATCH} frames "
          f"{TRESNET_IMG}x{TRESNET_IMG}: Q1 by path per forward {q1} (85 "
          f"calls, no K9); pooled against the bf16 backbone's: cosine "
          f"{cos:.5f}, relative L2 {rel:.4f} (bounds {TRESNET_Q8_COS}, "
          f"{TRESNET_Q8_REL}); ms per forward in turns: int8 "
          f"{ms['int8']:.3f}, bf16 {ms['bf16']:.3f} ({runs}); a forward "
          f"adds {peak / 2**30:.2f} GiB at its peak; {card}")
    del model, q
    rows = zoo_bench.main([])
    check(len(rows) == 4 and all(r["fps"] > 0 for r in rows),
          f"zoo_bench rows {rows}")


def phase_zoo_sessions(card: str) -> tuple:
    """The CvT-w24-384 teacher session in bf16 and int8 (``quantize=True``:
    Q1's TMA path for every Dense of >= 512 inputs, CVT_Q8_DENSE calls a
    predict; the attention the plain version, no K7), then the TResNet-L
    session with ``quantize=True`` (K9 52 and Q1 TRESNET_Q8_DENSE a
    predict). Returns the launches of each, counted from 0."""
    reset_launches()
    phase_teacher(card, {"bf16": ({}, {}),
                         "int8": ({"qconv_bn": CVT_Q8_DENSE},
                                  {"quantize": True})},
                  CVT, CVT_IMG, CVT_BATCH)
    cvt = path_launches()
    reset_launches()
    phase_teacher(card, {"int8 Dense": (
        TRESNET_LAUNCHES | {"qconv_bn": TRESNET_Q8_DENSE},
        {"quantize": True})}, TRESNET, TRESNET_IMG, TRESNET_BATCH)
    return cvt, path_launches()


def phase_zoo_drivers(card: str, root: str) -> None:
    """The teacher driver's ``-t`` (one epoch and its validation, bf16,
    loss "i", batch ZOO_DRIVER_BATCH) at CvT-w24-384 (no kernel of the
    port) and TResNet-L-448 (K9 in the validation forwards only), on
    phase 16's tree."""
    from computervision_codes_tpu_torch.cli import spatial_transformer

    for backbone, img, eval_want in ((CVT, CVT_IMG, {}),
                                     (TRESNET, TRESNET_IMG,
                                      TRESNET_LAUNCHES)):
        argv = ["--data_dir", root, "--backbone", backbone,
                "--image_height", str(img), "--image_width", str(img),
                "-b", str(ZOO_DRIVER_BATCH), "--loss_type", "i", "--dtype",
                "bfloat16", "--device", DEVICE, "--epochs", "1", "-t",
                "--ckpt_root", f"{root}/ckpt_{backbone}"]
        res, events, _ = driver_run(f"teacher -t --backbone {backbone} "
                                    f"{img}", spatial_transformer, argv, {},
                                    eval_want, card, tag="zoo")
        finite_losses(f"teacher {backbone}", res)
        check(res["step"] == len(events["train"]) >= 4,
              f"teacher {backbone}: {res['step']} steps")


def phase_device_augment(card: str) -> dict:
    """``make_device_augment`` (the default list and every device
    augmentation) with fixed draws on the card against the CPU at the
    student's batch and geometry: the flips, autocontrast, sharpness and
    jitter equal, each rotation within one level (the share of differing
    pixels printed), the normalised output's largest difference; then the
    ms of a batch on the card, each list and rotation, and the host's
    PIL-free augmentation of the same frames for comparison."""
    from computervision_codes_tpu_torch.data import device_augment as da
    from computervision_codes_tpu_torch.data import transforms

    rng = np.random.default_rng(30)
    h, w = AUG_HW
    frames = endoscope_frames(AUG_BATCH, AUG_HW, 31)
    x = torch.from_numpy(np.stack(frames))
    xd = x.to(DEVICE)
    angles = torch.from_numpy(rng.uniform(-90, 90, AUG_BATCH).astype(
        np.float32))
    bf = torch.from_numpy(rng.uniform(0.9, 1.1, AUG_BATCH).astype(np.float32))
    cf = torch.from_numpy(rng.uniform(0.8, 1.2, AUG_BATCH).astype(np.float32))
    ops = {"autocontrast": (da.autocontrast_u8, ()),
           "sharpness": (da.sharpness_u8, ()),
           "jitter": (da.jitter_u8, (bf, cf)),
           "rotate gather": (da.rotate_expand_resize_u8, (angles,)),
           "rotate two_pass": (da.rotate_expand_resize_fast, (angles,))}
    shares = {}
    for name, (fn, args) in ops.items():
        want = fn(x, *args)
        got = fn(xd, *(a.to(DEVICE) for a in args)).cpu()
        diff = (got.int() - want.int()).abs()
        shares[name] = float((diff > 0).float().mean())
        exact = not name.startswith("rotate")
        check(int(diff.max()) <= (0 if exact else 1),
              f"device_augment {name}: card vs CPU up to {int(diff.max())} "
              f"levels")
    augs = ("original", "vflip", "hflip", "contrast", "rot90", "brightness",
            "jitter")
    draws = da.draw_augment(augs, AUG_BATCH,
                            torch.Generator().manual_seed(32))
    want = da.apply_augment(augs, x, draws)
    got = da.apply_augment(augs, xd, [
        None if d is None else tuple(t.to(DEVICE) for t in d)
        if isinstance(d, tuple) else d.to(DEVICE) for d in draws]).cpu()
    diff = (got - want).abs()
    err = float(diff.max())
    level = 1 / 255 / float(transforms.IMAGENET_STD.min())
    past = float((diff > level * 1.0001).float().mean())
    check(err <= AUG_LIST_LEVELS * level * 1.0001 and past <= AUG_LIST_SHARE,
          f"device_augment pipeline: card vs CPU {err} ({err / level:.2f} "
          f"levels), {past:.2e} of the values past one level")
    print(f"[augment] {AUG_BATCH} frames {h}x{w}, fixed draws, card against "
          f"CPU: share of differing pixels {shares} (flips exact; "
          f"autocontrast, sharpness and jitter must be 0, the rotations "
          f"within one level); the whole list {augs} normalised: max "
          f"|difference| {err:.3e} = {err / level:.2f} levels, "
          f"{past:.2e} of the values past one level (bounds "
          f"{AUG_LIST_LEVELS} levels, {AUG_LIST_SHARE:g})")
    gen = torch.Generator(device=DEVICE).manual_seed(33)
    fns = {"default list (gather)": da.make_device_augment(),
           "default list (two_pass)": da.make_device_augment(
               rot_impl="two_pass"),
           "flips + contrast": da.make_device_augment(
               ("original", "vflip", "hflip", "contrast")),
           "two views (TERL)": da.make_device_augment(two_view=True)}
    ms, runs = in_turns({k: functools.partial(f, gen, xd)
                         for k, f in fns.items()},
                        dict.fromkeys(fns, AUG_REPS))
    t0 = time.perf_counter()
    host_rng = np.random.default_rng(34)
    for f in frames:
        transforms.apply_augmentations(host_rng, f, transforms.DEFAULT_AUGS)
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"[augment] ms per batch of {AUG_BATCH} frames {h}x{w} on the "
          f"card, in turns: " + ", ".join(
              f"{k} {v:.3f} ({AUG_BATCH / v * 1e3:.0f} frames/s)"
              for k, v in ms.items())
          + f"; runs {runs}; the host's augmentation of the same frames on "
            f"one thread {host_ms:.1f} ms ({AUG_BATCH / host_ms * 1e3:.0f} "
            f"frames/s, host clock); {card}")
    return {k: round(v, 4) for k, v in ms.items()}


def phase_augment_drivers(card: str, root: str) -> tuple:
    """The student's and TERL's training epochs on phase 16's tree without
    and with ``--device_augment``, in turns: frames/s of each epoch and the
    steps' periods. Returns the launches of each driver's runs, counted
    from 0."""
    from computervision_codes_tpu_torch.cli import spatial_cnn, terl_learnt

    rates = {}
    counts = []
    for name, module, argv, names, step_want, eval_want, tag in (
            ("student", spatial_cnn,
             ["--data_dir", root, "-b", str(SPATIAL_STUDENT_BATCH),
              "--loss_type", "i", "--epochs", "1", "--device", DEVICE, "-t"],
             SPATIAL_STEPS, {}, {}, "spatial"),
            ("TERL", terl_learnt,
             ["--data_dir", root, "--backbone", TERL_BACKBONE,
              "--img_size", str(TERL_IMG), "-b", str(TERL_BATCH), "--mlp",
              "--moco_k", str(TERL_QUEUE), "--epochs", "1", "--dtype",
              "bfloat16", "--device", DEVICE, "-t"],
             TERL_STEPS, TERL_EVAL_LAUNCHES, TERL_EVAL_LAUNCHES, "terl")):
        reset_launches()
        for i, flag in enumerate(AUG_DRIVER_ORDER):
            label = (f"{name} -t" + (" --device_augment" if flag else ""))
            res, events, _ = driver_run(
                label, module, argv + ["--ckpt_root", f"{root}/aug_{name}_{i}"]
                + (["--device_augment"] if flag else []), step_want,
                eval_want, card, names, tag=tag)
            finite_losses(label, res)
            steps = len(events["train"])
            frames = steps * int(argv[argv.index("-b") + 1])
            periods = step_periods(events["train"])
            rates.setdefault(label, []).append(
                (frames / sum(res["train_seconds"]),
                 float(np.median(periods)) if periods else None))
        counts.append(path_launches())
    print(f"[augment] epochs in turns (without, with, with, without): "
          + "; ".join(f"{label}: frames/s {[round(r[0], 1) for r in v]}, "
                      f"median step period ms "
                      f"{[round(r[1], 3) if r[1] else None for r in v]}"
                      for label, v in rates.items()) + f"; {card}")
    return tuple(counts)


# phase_parallel, the parallel paths and the servables at world size 1 on
# NCCL: the MS-TCT video (a whole synthetic video at the driver's width),
# the TCN's (the bf16 session's own TCN), the PNG frames the servable CLI
# scores (noise, as phase 15's), the student's DP step and the Swin-T/Q2L
# TP step
PARALLEL_MSTCT_T, PARALLEL_TCN_T, PARALLEL_FRAMES = 4096, 2048, 300
PARALLEL_DP = (8, 256, 448)  # the student's batch and frames
PARALLEL_TP = ("swin_T_224_1k", 4, 224)  # the teacher, batch, image
PARALLEL_PATH = ("the parallel paths at world size 1 on NCCL (mesh "
                 "sessions, servables and cli.export / cli.infer "
                 "--servable, sharded MS-TCT and TCN eval, DP and TP steps, "
                 "the pipelined Swin stage)")
# the DP step at world size 1 takes the single-device arithmetic, so it is
# held to it bit for bit; the TP step at world size 1 is the plain step (no
# leaf splits over one rank): within float32 rounding
PARALLEL_TP_RTOL, PARALLEL_TP_ATOL = 1e-5, 1e-6


def _diff_launches(before: dict) -> dict:
    now = path_launches()
    return {k: now[k] - before[k] for k in now}


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def phase_parallel(card: str, offline: dict, clips: np.ndarray,
                   streaming: dict) -> dict:
    """The parallel layer and the servables, at world size 1 on NCCL (one
    card; more ranks are the CPU tests' gloo groups): (a) mesh sessions
    bf16 and int8 fused stem against the meshless ones of phase 5, bit for
    bit, launches per predict; (b) export and load_exported of both, and of
    phase 5's bf16 and int8 streaming sessions (the full-depth causal TCN),
    bit for bit with phase 5's launches per push, the load's time;
    cli.export --quantize from a checkpoint the port wrote, then cli.infer
    --servable over PNG frames, equal to phase 5's int8 float-stem session
    (the servable is not calibrated again: Q1 19 a predict, no more);
    (c) eval_sharded of the full-width MS-TCT on a whole video, gathered
    (K7) and ring (K8's forward), and of the TCN (K1 on the halo-extended
    shard), against the unsharded forwards; (d) a DP step of the student
    and a TP step of the Swin-T/Q2L teacher against their single-device
    steps, and a pipelined Swin-T stage against its blocks in order; (e)
    ``utils.profiling.trace`` around one predict, its Chrome trace naming
    K1's kernel. Returns the parallel paths' launches, summed over the
    calls under test only (each counted from just before it)."""
    import torch.distributed as dist

    from computervision_codes_tpu_torch.cli import export as cli_export
    from computervision_codes_tpu_torch.cli import infer
    from computervision_codes_tpu_torch.models.mstct import MSTCT
    from computervision_codes_tpu_torch.models.q2l import Q2L
    from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
    from computervision_codes_tpu_torch.models.swin import build_swin
    from computervision_codes_tpu_torch.parallel import mesh as pmesh
    from computervision_codes_tpu_torch.parallel.long_video import (
        eval_sharded)
    from computervision_codes_tpu_torch.parallel.swin_pipeline import (
        extract_stage_pairs, pipelined_swin_stage)
    from computervision_codes_tpu_torch.parallel.tp import (
        shard_state_tp, sharded_leaf_count)
    from computervision_codes_tpu_torch.serving import (InferenceSession,
                                                        StreamingSession)
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, make_spatial_train_step)
    from computervision_codes_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from computervision_codes_tpu_torch.utils.profiling import (
        TRACE_FILE, trace)

    t_phase = time.perf_counter()
    total = dict.fromkeys(path_launches(), 0)

    def run(fn):
        """fn(), its launches added to the path's and returned."""
        before = path_launches()
        out = fn()
        got = _diff_launches(before)
        for k, n in got.items():
            total[k] += n
        return out, got

    b, t, h, w = OFFLINE
    k1 = dict.fromkeys(KERNELS, 0) | {"dilated_residual": LAYERS_PER_FORWARD}
    int8_fused = k1 | {"stem_pool": 1, "qconv_bn": INT8_CONVS}
    int8_float = dict(int8_fused, stem_pool=0)

    def kernel_counts(got: dict) -> dict:
        return {k: got[k] for k in KERNELS if got.get(k)}

    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as tmp:
        root = Path(tmp)
        pmesh.init_process(0, 1, f"file://{root / 'store'}", DEVICE)
        try:
            mesh = pmesh.make_mesh(n_data=1, device_type=DEVICE)
            check(pmesh.mesh_device(mesh).type == DEVICE,
                  f"mesh device {pmesh.mesh_device(mesh)}")

            # (a) mesh sessions against the meshless ones, bit for bit
            for label, want, kw in (
                    ("bf16", k1, {}),
                    ("int8 fused stem", int8_fused,
                     {"quantize": True, "fused_stem": True})):
                sess = InferenceSession.create(batch=b, clip_len=t,
                                               height=h, width=w, mesh=mesh,
                                               **kw)
                ref = offline[label].predict(clips)
                ms = {"mesh": [], "meshless": []}
                for _ in range(3):  # in turns; the first warms up
                    (probs, call_ms), got = run(
                        lambda: timed_call(lambda: sess.predict(clips)))
                    ms["mesh"].append(round(call_ms, 3))
                    ms["meshless"].append(round(timed_call(
                        lambda: offline[label].predict(clips))[1], 3))
                    check(kernel_counts(got) == kernel_counts(want),
                          f"mesh session {label}: launches "
                          f"{kernel_counts(got)}, want {kernel_counts(want)}")
                    for k in TASK_SIZES:
                        check(np.array_equal(probs[k], ref[k]),
                              f"mesh session {label} {k}: differs from the "
                              f"meshless session by "
                              f"{np.abs(probs[k] - ref[k]).max()}")
                print(f"[parallel] (a) InferenceSession(mesh=1x1x1, NCCL) "
                      f"{label} {b}x{t} frames {h}x{w}: probabilities equal "
                      f"to the meshless session's bit for bit; launches per "
                      f"predict {kernel_counts(want)}; ms per predict in "
                      f"turns, mesh {ms['mesh']}, meshless {ms['meshless']} "
                      f"(CUDA events; the first warms up); {card}")
                del sess

            # (b) servables: export and load, bit for bit
            for label, want in (("bf16", k1),
                                ("int8 fused stem", int8_fused)):
                path = offline[label].export(str(root / label.replace(
                    " ", "_")))
                t0 = time.perf_counter()
                loaded = InferenceSession.load_exported(path, device=DEVICE)
                load_s = time.perf_counter() - t0
                ref = offline[label].predict(clips)
                (probs, call_ms), got = run(
                    lambda: timed_call(lambda: loaded.predict(clips)))
                check(kernel_counts(got) == {k: n for k, n in want.items()
                                             if n},
                      f"servable {label}: launches {kernel_counts(got)}")
                for k in TASK_SIZES:
                    check(np.array_equal(probs[k], ref[k]),
                          f"servable {label} {k}: differs from the exported "
                          f"session by {np.abs(probs[k] - ref[k]).max()}")
                mib = os.path.getsize(
                    Path(path) / "variables.msgpack") / 2 ** 20
                print(f"[parallel] (b) {label} servable: load_exported "
                      f"{load_s:.2f} s (host clock: the modules rebuilt, "
                      f"the stored variables loaded, no calibration), "
                      f"{mib:.1f} MiB of variables; its predict equal to "
                      f"the exported "
                      f"session's bit for bit, {call_ms:.3f} ms; {card}")
                del loaded
            stream_frames = np.random.default_rng(20).integers(
                0, 256, (4, h, w, 3), dtype=np.uint8)
            for label, want in (("bf16", k1),
                                ("int8 fused stem", int8_fused)):
                sess = streaming[label][0][0]  # one stream, phase 5's
                path = sess.export(str(root / f"stream_{label[:4]}"))
                t0 = time.perf_counter()
                loaded = StreamingSession.load_exported(path, device=DEVICE)
                load_s = time.perf_counter() - t0
                sess.reset()  # the servable starts from a zero buffer
                for i, frame in enumerate(stream_frames):
                    ref = sess.push(frame)
                    got_probs, got = run(lambda: loaded.push(frame))
                    check(kernel_counts(got) == kernel_counts(want),
                          f"streaming servable {label} push {i}: launches "
                          f"{kernel_counts(got)}, want {kernel_counts(want)}")
                    for k in TASK_SIZES:
                        check(np.array_equal(got_probs[k], ref[k]),
                              f"streaming servable {label} push {i} {k}: "
                              f"differs from the exported session")
                sess.reset()
                print(f"[parallel] (b) streaming {label} servable (phase "
                      f"5's session: causal, context {sess.context}, the "
                      f"default {LAYERS_PER_FORWARD}-layer TCN): "
                      f"load_exported {load_s:.2f} s; {len(stream_frames)} "
                      f"pushes equal to the exported session's bit for "
                      f"bit, launches per push {kernel_counts(want)}; {card}")
                del loaded

            # cli.export from a checkpoint the port wrote, cli.infer
            # --servable over PNG frames
            state = create_train_state(offline["bf16"].model,
                                       build_sgd(1e-2), device=DEVICE)
            CheckpointManager(str(root / "ckpt"), "student").save(state)
            del state
            servable = str(root / "cli_servable")
            t0 = time.perf_counter()
            (_, export_launches) = run(lambda: cli_export.main([
                "--ckpt_dir", str(root / "ckpt"), "--modelname", "student",
                "--out", servable, "--batch", str(b), "--clip_len", str(t),
                "--height", str(h), "--width", str(w), "--quantize",
                "--device", DEVICE]))
            export_s = time.perf_counter() - t0
            check(export_launches["qconv_bn"] == INT8_CONVS,
                  f"cli.export --quantize: its calibration forward launched "
                  f"Q1 {export_launches['qconv_bn']} times")
            frames = np.random.default_rng(21).integers(
                0, 256, (PARALLEL_FRAMES, h, w, 3), dtype=np.uint8)
            write_frames(root / "VID01", frames, level=1, filter_type=0)
            res, got = run(lambda: infer.main(
                ["--video", str(root / "VID01"), "--servable", servable,
                 "--device", DEVICE]))
            predicts = -(-PARALLEL_FRAMES // (b * t))
            check(kernel_counts(got) == {
                "dilated_residual": LAYERS_PER_FORWARD * predicts,
                "qconv_bn": INT8_CONVS * predicts},
                f"cli.infer --servable: launches {kernel_counts(got)}")
            span = b * t
            ref = {k: [] for k in TASK_SIZES}
            for start in range(0, PARALLEL_FRAMES, span):
                clip = np.zeros((span, h, w, 3), np.uint8)
                part = frames[start:start + span]
                clip[:len(part)] = part
                out = offline["int8 float stem"].predict(
                    clip.reshape(b, t, h, w, 3))
                for k in ref:
                    ref[k].append(out[k].reshape(span, -1)[:len(part)])
            for k in TASK_SIZES:
                want_k = np.concatenate(ref[k])
                check(np.array_equal(res["probs"][k], want_k),
                      f"cli.infer --servable {k}: differs from phase 5's "
                      f"int8 float-stem session by "
                      f"{np.abs(res['probs'][k] - want_k).max()}")
            print(f"[parallel] (b) cli.export --quantize from a checkpoint "
                  f"the port wrote ({export_s:.1f} s host clock, one "
                  f"calibration forward: Q1 {INT8_CONVS}), then cli.infer "
                  f"--servable over {PARALLEL_FRAMES} PNG frames of {h}x{w}: "
                  f"equal to phase 5's int8 float-stem session bit for bit; "
                  f"launches {kernel_counts(got)} ({predicts} predict, no "
                  f"calibration); {res['seconds']:.3f} s end to end; {card}")

            # (c) sequence-parallel eval of the full-width MS-TCT and TCN
            seq = pmesh.make_mesh(n_data=1, n_seq=1, device_type=DEVICE)
            g = torch.Generator().manual_seed(22)
            mstct = MSTCT(MSTCT_IN, generator=g).to(DEVICE).eval()
            feats = torch.randn(1, PARALLEL_MSTCT_T, MSTCT_IN,
                                generator=g).to(DEVICE)
            with torch.inference_mode():
                want = mstct(feats)
                timings = {}
                for label, ring in (("gather", False), ("ring", True)):
                    mstct.ring_mesh = seq if ring else None
                    calls = []
                    for _ in range(3):  # the first warms up
                        (out, ms_), got = run(lambda: timed_call(
                            lambda: eval_sharded(mstct, feats, seq)))
                        calls.append(round(ms_, 3))
                        kind = "flash_attention_fwd" if ring else "attention"
                        check(kernel_counts(got) == {kind: MSTCT_LAUNCHES},
                              f"MS-TCT eval_sharded {label}: launches "
                              f"{kernel_counts(got)}")
                        for k in ("logits", "feature"):
                            err = _max_rel(out[k], want[k])
                            check(err <= REL_TOL[torch.float32],
                                  f"MS-TCT eval_sharded {label} {k}: "
                                  f"{err:.3g} of the unsharded forward's "
                                  f"largest")
                    mstct.ring_mesh = None
                    timings[label] = (calls, _max_rel(out["logits"],
                                                      want["logits"]))
                ms_whole = [round(timed_call(lambda: mstct(feats))[1], 3)
                            for _ in range(3)]
            print(f"[parallel] (c) MS-TCT full width float32, one video of "
                  f"{PARALLEL_MSTCT_T} frames, eval_sharded over a 1-rank "
                  f"seq axis: gathered (K7 {MSTCT_LAUNCHES} a forward) "
                  f"ms {timings['gather'][0]}, max rel "
                  f"{timings['gather'][1]:.2e}; ring (K8's forward "
                  f"{MSTCT_LAUNCHES} a forward, lse merge) ms "
                  f"{timings['ring'][0]}, max rel {timings['ring'][1]:.2e}; "
                  f"unsharded ms {ms_whole} (CUDA events; the first of "
                  f"each warms up); {card}")
            tcn = offline["bf16"].model.tcn
            x = torch.randn(1, PARALLEL_TCN_T, 512, generator=g).to(
                DEVICE, torch.bfloat16)
            with torch.inference_mode():
                want = tcn(x)
                (out, ms_), got = run(lambda: timed_call(
                    lambda: eval_sharded(tcn, x, seq)))
            check(kernel_counts(got) == {
                "dilated_residual": LAYERS_PER_FORWARD},
                f"TCN eval_sharded: launches {kernel_counts(got)}")
            err = max(_max_rel(o, wv) for key in ("ivt", "i", "v", "t")
                      for o, wv in zip(out[key], want[key]))
            check(err <= REL_TOL[torch.bfloat16],
                  f"TCN eval_sharded: {err:.3g} of the unsharded forward's "
                  f"largest")
            print(f"[parallel] (c) TCN (the bf16 session's, 41 layers at "
                  f"512) over {PARALLEL_TCN_T} frames, eval_sharded: K1 "
                  f"{LAYERS_PER_FORWARD} on the halo-extended shard, max rel "
                  f"{err:.2e} against the unsharded forward, {ms_:.3f} ms; "
                  f"{card}")

            # (d) a DP step, a TP step and a pipelined Swin stage
            n, dh, dw = PARALLEL_DP
            rng = np.random.default_rng(23)
            batch = {"image": rng.standard_normal(
                (n, dh, dw, 3)).astype(np.float32)}
            for k, c in TASK_SIZES.items():
                batch[f"label_{k}"] = (rng.random((n, c)) < 0.3).astype(
                    np.float32)
            student = SpatialCNN("resnet18", loss_type="ivt",
                                 generator=torch.Generator().manual_seed(24))
            states = [create_train_state(copy.deepcopy(student),
                                         build_sgd(1e-2, 1e-5),
                                         device=DEVICE)
                      for _ in range(3)]
            cudnn = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
            # cuDNN's deterministic algorithms: the two single-device steps
            # and the DP step then take the same sums
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            try:
                ref_m = [make_spatial_train_step(student, "ivt",
                                                 device=DEVICE)(st, batch)[1]
                         for st in states[1:]]
                (_, dp_m), got = run(lambda: make_spatial_train_step(
                    student, "ivt", device=DEVICE, mesh=mesh)(states[0],
                                                              batch))
            finally:
                (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark) = cudnn
            single, again, dp = (st.model.state_dict() for st in states)
            repeat = max(float((again[k].float() - v.float()).abs().max())
                         for k, v in single.items())
            check(repeat == 0.0 and all(
                float(ref_m[0][k]) == float(ref_m[1][k]) for k in ref_m[0]),
                  f"single-device step under cuDNN's deterministic "
                  f"algorithms: two runs differ by {repeat:.3g}")
            for k, v in ref_m[0].items():
                check(float(dp_m[k]) == float(v),
                      f"DP step {k}: {float(dp_m[k])!r} against {float(v)!r}")
            for name, v in dp.items():
                err = float((v.float() - single[name].float()).abs().max())
                check(torch.equal(v, single[name]),
                      f"DP step {name}: differs from the single-device step "
                      f"by {err:.3g}")
            print(f"[parallel] (d) DP step (student ResNet18, batch {n} of "
                  f"{dh}x{dw}, 1-rank data axis: BatchNorm's moments and "
                  f"the gradients all-reduced over NCCL, cuDNN's "
                  f"deterministic algorithms) against the single-device "
                  f"step: loss {float(dp_m['loss'])!r}, every parameter and "
                  f"running statistic equal bit for bit (two single-device "
                  f"runs equal too); launches {kernel_counts(got)}"
                  f" (cuDNN and cuBLAS); {card}")
            del states, student
            backbone, tb, img = PARALLEL_TP
            teacher = Q2L(backbone, loss_type="i", fused_eval=False,
                          generator=torch.Generator().manual_seed(25))
            tstates = [create_train_state(copy.deepcopy(teacher),
                                          build_sgd(1e-2, 1e-5, 0.9),
                                          seed=26, device=DEVICE)
                       for _ in range(2)]
            tp_mesh = pmesh.make_mesh(n_data=1, n_model=1,
                                      device_type=DEVICE)
            tstates[0] = shard_state_tp(tstates[0], tp_mesh)
            tbatch = {"image": rng.standard_normal(
                (tb, img, img, 3)).astype(np.float32)}
            for k, c in TASK_SIZES.items():
                tbatch[f"label_{k}"] = (rng.random((tb, c)) < 0.3).astype(
                    np.float32)
            _, ref_m = make_spatial_train_step(teacher, "i", device=DEVICE)(
                tstates[1], tbatch)
            ((_, tp_m), tp_ms), got = run(lambda: timed_call(
                lambda: make_spatial_train_step(teacher, "i", device=DEVICE,
                                                mesh=tp_mesh)(
                    tstates[0], tbatch)))
            check(abs(float(tp_m["loss"]) - float(ref_m["loss"]))
                  <= PARALLEL_TP_RTOL * abs(float(ref_m["loss"])),
                  f"TP step loss {float(tp_m['loss'])} against "
                  f"{float(ref_m['loss'])}")
            pairs = zip(tstates[0].model.parameters(),
                        tstates[1].model.parameters())
            err = max(float((p - q).detach().abs().max()) for p, q in pairs)
            check(err <= PARALLEL_TP_ATOL, f"TP step parameters: {err:.3g}")
            check(sharded_leaf_count(tstates[0]) == 0,
                  "a leaf split over a one-rank model axis")
            print(f"[parallel] (d) TP step ({backbone}/Q2L, batch {tb} of "
                  f"{img}x{img}, 1-rank model axis: the plain path forced, "
                  f"no leaf split) against the single-device plain step: "
                  f"loss {float(tp_m['loss']):.6f}, parameters within "
                  f"{err:.2e}; {tp_ms:.3f} ms; launches {kernel_counts(got)}"
                  f"; {card}")
            del tstates, teacher
            swin = build_swin(backbone, fused_eval=False,
                              generator=torch.Generator().manual_seed(27)
                              ).to(DEVICE).eval()
            stage = 2
            dim = swin.embed_dim * 2 ** stage
            blocks = [getattr(swin, f"stage{stage}_block{d}")
                      for d in range(swin.depths[stage])]
            heads, window = blocks[0].num_heads, blocks[0].window
            side = img // 32 * 2  # stage 2's map at the image size
            x = torch.randn(tb, side, side, dim, generator=g).to(DEVICE)
            with torch.inference_mode():
                want = x
                for blk in blocks:
                    want = blk(want)
                stacked, n_blocks = extract_stage_pairs(swin, stage)
                (out, ms_), got = run(lambda: timed_call(
                    lambda: pipelined_swin_stage(
                        stacked, x, tp_mesh, n_micro=2, dim=dim,
                        num_heads=heads, window=window)))
            err = _max_rel(out, want)
            check(err <= REL_TOL[torch.float32],
                  f"pipelined Swin stage: {err:.3g}")
            print(f"[parallel] (d) pipelined {backbone} stage {stage} "
                  f"({n_blocks} blocks as {n_blocks // 2} shift pairs, 2 "
                  f"microbatches of {tb // 2}, a 1-stage model axis) against "
                  f"its blocks in order: max rel {err:.2e}, {ms_:.3f} ms; "
                  f"{card}")
            del swin, stacked

            # (e) trace() around one predict names K1's kernel
            sess = offline["bf16"]
            (_, got) = run(lambda: _traced(trace, root / "trace", sess,
                                           clips))
            events = json.loads((root / "trace" / TRACE_FILE).read_text())[
                "traceEvents"]
            k1_events = [e for e in events if e.get("cat") == "kernel"
                         and "k1_kernel" in e.get("name", "")]
            check(len(k1_events) == LAYERS_PER_FORWARD,
                  f"trace: {len(k1_events)} K1 kernel events, want "
                  f"{LAYERS_PER_FORWARD}")
            name = k1_events[0]["name"] if k1_events else ""
            print(f"[parallel] (e) utils.profiling.trace around one bf16 "
                  f"predict: the Chrome trace names K1's kernel "
                  f"{LAYERS_PER_FORWARD} times ({name[:48]}...), its device "
                  f"time "
                  f"{sum(e.get('dur', 0) for e in k1_events) / 1e3:.3f} ms; "
                  f"{card}")
        finally:
            dist.destroy_process_group()
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s (host "
          f"clock); launches on the parallel paths "
          f"{ {k: n for k, n in total.items() if n} }; {card}")
    return total


def _traced(trace, directory: Path, sess, clips):
    with trace(str(directory)):
        return sess.predict(clips)


def main() -> None:
    if not (ROOT / PACKAGE / "csrc" / "dilated_residual.cu").is_file():
        fail(f"{PACKAGE}/ not found beside {Path(__file__).name}: run from a "
             f"checkout of the repository")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False); this "
             "check runs only on the card")

    started = time.perf_counter()
    card = phase_device()
    phase_build()
    measured = {"dilated_residual": phase_k1(card),
                "stem_pool": phase_k2(card),
                "qconv_bn": phase_q1(card),
                "window_mhsa": phase_k3(card),
                "window_attn": phase_attn(card),
                "mlp_block": phase_k4(card),
                "swin_block": phase_k5(card),
                **phase_q8(card),
                "attention": phase_k7(card),
                **phase_k8(card),
                "fused_scale_bias_act": phase_k9(card),
                "window_attention": phase_k10(card)}
    check_design_pairs("the kernel phases")
    slice_s = time.perf_counter()  # the training slice's phases, summed
    measured["window_mhsa_branch"], measured["mlp_block_branch"] = \
        phase_k6(card)
    slice_s = time.perf_counter() - slice_s
    widths_s = time.perf_counter()  # K3-K6 at the widths off 64
    for name, rows in phase_swin_widths(card).items():
        measured[name]["swin_widths"] = rows
    swin_t_teacher = phase_teacher_swin_t(card)
    widths_s = time.perf_counter() - widths_s
    probe_s = time.perf_counter()  # the probes' phases, summed
    measured["swin_gemm"] = phase_p1(card)
    p2_loops = phase_p2(card)
    phase_gemm_walk(card)
    probe_s = time.perf_counter() - probe_s
    measured["qconv_bn"] |= phase_q1_dense(card)
    zoo_s = time.perf_counter()  # this slice's phases, summed
    measured["qconv_bn"] |= phase_q1_tresnet(card)
    zoo_s = time.perf_counter() - zoo_s
    phase_model()
    phase_model_int8()
    phase_model_teacher_int8(phase_model_teacher())
    phase_model_mstct()
    mstct_s = time.perf_counter()  # this slice's phases, summed
    phase_model_mstct_train()
    mstct_s = time.perf_counter() - mstct_s
    phase_model_tresnet()
    t0 = time.perf_counter()
    phase_model_zoo()
    phase_device_augment(card)
    zoo_s += time.perf_counter() - t0
    phase_model_swin_fused()
    t0 = time.perf_counter()
    phase_model_train()
    slice_s += time.perf_counter() - t0

    # the main path: the serving entry points at the serving geometry,
    # with cuDNN's TF32 at PyTorch's default (on) as a user runs them. The
    # int8 sessions' float stem convolves bf16-valued float32 tensors,
    # which TF32 holds exactly, so its sums are the float32 sums
    torch.backends.cudnn.allow_tf32 = True
    k1_only = dict.fromkeys(KERNELS, 0) | {
        "dilated_residual": LAYERS_PER_FORWARD}
    int8_fused = k1_only | {"stem_pool": 1, "qconv_bn": INT8_CONVS}
    int8_float_stem = dict(int8_fused, stem_pool=0)
    reset_launches()  # the student's main path starts here
    offline, clips = phase_offline(card, {
        "bf16": (k1_only, {}),
        "int8 float stem": (int8_float_stem, {"quantize": True}),
        "int8 fused stem": (int8_fused, {"quantize": True,
                                         "fused_stem": True})})
    streaming = {
        "bf16": phase_streaming(card, "bf16", k1_only),
        "int8 fused stem": phase_streaming(card, "int8 fused stem",
                                           int8_fused, quantize=True,
                                           fused_stem=True)}
    check_design_pairs("student sessions")
    student = path_launches()
    reset_launches()  # the teachers' main path starts here
    teachers, frames = phase_teacher(card, {
        "bf16": (TEACHER_LAUNCHES | TEACHER_GEMMS, {}),
        "int8": (TEACHER_Q8_LAUNCHES | TEACHER_GEMMS, {"quantize": True})})
    check_gemm_counts("teacher sessions")
    check_attn_counts("teacher sessions")
    teacher = path_launches()
    reset_launches()  # path A, the TResNet-L teacher, starts here
    tresnet_sessions, tresnet_frames = phase_teacher(
        card, {"bf16": (TRESNET_LAUNCHES, {})},
        TRESNET, TRESNET_IMG, TRESNET_BATCH)
    tresnet = path_launches()
    t0 = time.perf_counter()
    cvt_sessions, tresnet_q8_session = phase_zoo_sessions(card)
    reset_launches()  # the int8 TResNet-L backbone and zoo_bench start here
    phase_int8_tresnet(card)
    int8_tresnet = path_launches()
    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as root:
        spatial_tree(root)
        reset_launches()  # the teacher driver at CvT and TResNet
        phase_zoo_drivers(card, root)
        zoo_drivers = path_launches()
        student_aug, terl_aug = phase_augment_drivers(card, root)
    zoo_s += time.perf_counter() - t0
    frames_s = time.perf_counter()  # this slice's phase
    infer_path, dataset_path = phase_frames(card, teachers["bf16"])
    frames_s = time.perf_counter() - frames_s
    parallel_s = time.perf_counter()  # the parallel slice's phase
    parallel_path = phase_parallel(card, offline, clips, streaming)
    parallel_s = time.perf_counter() - parallel_s
    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as root:
        split, lengths = mstct_tree(root)
        reset_launches()  # the MS-TCT driver's main path starts here
        for dtype in ("float32", "bfloat16"):
            phase_mstct(card, root, split, lengths, dtype)
        check_design_counts("MS-TCT driver")
        mstct = path_launches()
    reset_launches()  # path B, Swin's use_fused_attn, starts here
    path_b = phase_swin_fused(card)
    check_attn_counts("path B")
    path_b |= q1_counts() | {
        k: path_launches()[k] for k in ("attention merge", "attention prev",
                                        "dilated_residual prev",
                                        "stem_pool prev")}
    reset_launches()  # the teacher's training steps start here
    t0 = time.perf_counter()
    train, train_state, train_batch = phase_train(card)
    check_gemm_counts("training steps")
    check_attn_counts("training steps")
    train = path_launches()
    slice_s += time.perf_counter() - t0
    spatial_s = time.perf_counter()  # this slice's phase: both drivers
    spatial_teacher, spatial_student = phase_spatial_drivers(card)
    spatial_s = time.perf_counter() - spatial_s
    temporal_s = time.perf_counter()  # the TCN and TERL drivers
    phase_model_tcn()
    tcn_path = phase_tcn_driver(card)
    phase_model_terl()
    terl_path = phase_terl_driver(card)
    temporal_s = time.perf_counter() - temporal_s
    t0 = time.perf_counter()
    reset_launches()  # K8's op path starts here
    phase_k8_path(card)
    check_design_counts("K8's op path")
    k8_path = path_launches()
    with tempfile.TemporaryDirectory(dir=ROOT / PACKAGE / "_build") as root:
        split, _ = mstct_train_tree(root)
        reset_launches()  # the MS-TCT driver's training starts here
        for dtype in ("float32", "bfloat16"):
            phase_mstct_train(card, root, split, dtype)
        check_design_counts("MS-TCT driver -t")
        mstct_train = path_launches()
    mstct_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    reset_launches()  # the probe drivers start here
    measured |= probe_entries(*phase_probes(card),
                              measured["swin_gemm"]["ms_by_shape"], p2_loops)
    check_gemm_counts("probe drivers")
    check_attn_counts("probe drivers")
    check_probe_paths()
    probes = path_launches()
    probe_s += time.perf_counter() - t0
    paths = {"student sessions": student,
             "teacher sessions (creation and predicts)": teacher,
             "the TResNet-L teacher session (path A)": tresnet,
             "the video inference CLI (cli.infer offline and --streaming, "
             "int8, PNG frames)": infer_path,
             "the dataset path (evaluate_videos over PNG frames, bf16 "
             "Swin-L-384 teacher)": dataset_path,
             "MS-TCT driver (-e -d, float32 and bfloat16)": mstct,
             "Swin-L-384 use_fused_attn forward (path B, a configuration)":
                 path_b,
             "the Swin-L-384 teacher's training steps (both plans) and the "
             "trained module's eval": train,
             "K8's op path (flash_attention forward and backward, "
             "flash_attention_pallas)": k8_path,
             "MS-TCT driver -t and --resume (float32 and bfloat16)":
                 mstct_train,
             "the probe drivers (int8_kernel_probe and swin_pack_probe "
             "main())": probes,
             SPATIAL_TEACHER_PATH: spatial_teacher,
             "the Swin-T-224 teacher's bf16 predict (C 96 at stage 0)":
                 swin_t_teacher,
             TCN_PATH: tcn_path,
             TERL_PATH: terl_path,
             "the student's training driver (cli.spatial_cnn -t -e -d, "
             "--optimizer sam, --qat: ResNet18 on cuDNN and cuBLAS, no "
             "kernel of the port)": spatial_student,
             ZOO_CVT_PATH: cvt_sessions,
             ZOO_TRESNET_PATH: tresnet_q8_session,
             INT8_TRESNET_PATH: int8_tresnet,
             "the teacher driver -t at CvT-w24-384 and TResNet-L-448 (bf16, "
             "loss i; K9 in TResNet's validation forwards)": zoo_drivers,
             "the student's driver -t without and with --device_augment "
             "(no kernel of the port)": student_aug,
             TERL_AUG_PATH: terl_aug,
             PARALLEL_PATH: parallel_path}
    total = {name: sum(p[name] for p in paths.values()) for name in KERNELS}
    print("[main path] launches: " + "; ".join(
        f"{label} { {k: v for k, v in p.items() if v} }"
        for label, p in paths.items()))
    # Q1: the student's convolutions take the cp.async producer, the
    # teacher's Dense layers the TMA one, and no serving path the loop
    for label, p in paths.items():
        if label == INT8_TRESNET_PATH:
            continue  # every form a forward (phase_int8_tresnet checks it)
        form = "gemm" if label.startswith("teacher") else "conv"
        got = {k: p[f"qconv_bn {k}"] for k in q1_path_wrappers()}
        check(got == q1_want(p["qconv_bn"], form),
              f"{label}: Q1 path launches {got} for {p['qconv_bn']} calls")
    measured["qconv_bn"]["launches_by_path"] = {
        k: sum(p[f"qconv_bn {k}"] for p in paths.values())
        for k in q1_path_wrappers()}
    # the Swin GEMM core: every bf16 and int8 product of the teachers and
    # the training steps on wgmma, none on the loops
    from computervision_codes_tpu_torch.ops.swin_gemm import PATHS
    for label in ("teacher sessions (creation and predicts)",
                  "the Swin-L-384 teacher's training steps (both plans) and "
                  "the trained module's eval", SPATIAL_TEACHER_PATH,
                  "the Swin-T-224 teacher's bf16 predict (C 96 at stage 0)",
                  TERL_PATH, TERL_AUG_PATH):
        got = {k: paths[label][f"swin_gemm {k}"] for k in PATHS}
        check(got["wgmma"] > 0 and got["loop"] == got["fma"] == 0,
              f"{label}: Swin GEMM products per path {got}")
    # K1, K2, K7 and K8: the previous designs on no path
    check_design_pairs("the paths after the student's")
    for label, p in paths.items():
        for name in ("attention", "dilated_residual", "stem_pool"):
            check(p[f"{name} prev"] == 0,
                  f"{label}: {p[f'{name} prev']} launches of {name}'s "
                  f"previous design")
    for name in ("attention", "flash_attention_fwd"):
        measured[name]["merge_launches_by_path"] = {
            label: p["attention merge"] for label, p in paths.items()
            if p["attention merge"]}
    measured["window_attn"]["launches_by_path"] = {
        label: p["window_attn"] for label, p in paths.items()
        if p["window_attn"]}
    by_path = {label: {k: p.get(f"swin_gemm {k}", 0) for k in PATHS}
               for label, p in paths.items()}
    measured["swin_gemm"]["launches_by_path"] = {
        label: n for label, n in by_path.items() if any(n.values())}
    measured["swin_gemm"]["times"] = {
        "K3 stage 2 bf16 shifted": {k: measured["window_mhsa"][k]
                                    for k in ("ms", "loop_ms")},
        "K4 stage 2 bf16": {k: measured["mlp_block"][k]
                            for k in ("ms", "loop_ms")},
        "K5 stage 0 bf16 shifted": {k: measured["swin_block"][k]
                                    for k in ("ms", "loop_ms")},
        "K6 per training step": {
            k: round(measured["window_mhsa_branch"][k]
                     + measured["mlp_block_branch"][k], 4)
            for k in ("step_ms", "step_loop_ms")}}
    for name in KERNELS:
        if name in OFF_MAIN_PATH:
            check(total[name] == 0, f"{name} launched on a serving path")
        else:
            check(total[name] > 0, f"the main path launched no {name} kernel")
    phase_breakdown(card, offline, clips, streaming)
    for label, sess in teachers.items():
        teacher_breakdown(card, label, sess, frames)
    tresnet_breakdown(card, f"{TRESNET} bf16", tresnet_sessions["bf16"],
                      tresnet_frames)
    del teachers, offline, streaming, tresnet_sessions
    phase_mstct_breakdown(card)
    t0 = time.perf_counter()
    train_breakdown(card, train_state, train_batch)
    slice_s += time.perf_counter() - t0
    del train_state
    t0 = time.perf_counter()
    phase_mstct_step(card)
    mstct_s += time.perf_counter() - t0
    print(f"[time] {time.perf_counter() - started:.1f} s in all; the "
          f"training slice's phases (K6, the float32 training step, phase "
          f"11 and its breakdown) {slice_s:.1f} s of it; the MS-TCT "
          f"training slice's (K8's check and time not counted: the float32 "
          f"step card vs CPU, K8's path, the driver's -t, the fixed-batch "
          f"step) {mstct_s:.1f} s; the probes' (P1's and P2's checks, both "
          f"drivers' main()) {probe_s:.1f} s; the frame source's "
          f"(phase_frames) {frames_s:.1f} s; the training drivers' "
          f"(phase 16) {spatial_s:.1f} s; the widths off 64 (their K3-K6 "
          f"times and the Swin-T teacher) {widths_s:.1f} s; the TCN and "
          f"TERL drivers (phases 17-18, card vs CPU included) "
          f"{temporal_s:.1f} s; the backbone zoo and --device_augment "
          f"(Q1 at TResNet-L's shapes, CvT and int8 TResNet card vs CPU, the "
          f"augmentation's check and times, the CvT and TResNet sessions, "
          f"the int8 backbone and zoo_bench, the drivers) {zoo_s:.1f} s; "
          f"the parallel paths and servables (phase 20) {parallel_s:.1f} s "
          f"(host clock)")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"{PACKAGE}/csrc/"
                   f"{HEADERS.get(name, SOURCES[name] + '.cu')}",
         "replaces": replaces, "launches": total[name],
         **({"on_main_path": False} if name in OFF_MAIN_PATH else {}),
         **measured[name]}
        for name, replaces in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
