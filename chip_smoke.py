#!/usr/bin/env python3
"""Drive the PyTorch port (``speech_decoding_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

What it does, in order (one JSON object per line on stdout):

  1. the card's name and power limit (``nvidia-smi``);
  2. builds the eight hand-written CUDA kernel libraries (nine kernels: K7
     shares K6's source) from
     ``speech_decoding_tpu_torch/csrc`` with ``nvcc`` (one process per source,
     all started together) and times it;
  3. K1 ``subject_matmul`` against its plain version, f32 and bf16, at the
     serving shape (B=64, T=360, D1=270, S=27, mixed subject ids), at a
     ragged small shape, at the eval chunk (B=1024), with every id on one
     odd subject, with every id distinct, and with a misaligned x and W,
     each line with the body it took (the flagship and B=1024 must take
     ``wgmma``); the pack kernel bit for bit against ``pack_weights``; an
     out-of-range id must raise. Then K1's backward (dX through the kernel
     on Wᵀ, dW by segment sum): the autograd grads against the plain
     version's, f32 and bf16, at both shapes (the flagship's dX must take
     ``wgmma``), and with a misaligned g;
  3b. K2 ``tap_conv_dw`` against ``tap_conv_dw_plain``: bf16 at B=64, T=360
     for every (Cin, Cout, dilation) of the flagship's 15 k=3 convs, f32 at
     B=4, ragged shapes (Cin=270, T=13 with d=16 >= T, T=37, B=3), and for
     the bf16 body's TMA operands 270- and 272-channel x and g, T under one
     64-row chunk, B=1, (1, 1, 1, 1, 1), and a base that is not 16-byte
     aligned (it is copied and must match); two runs on the same inputs must
     give the same bits;
  3c. K5 ``tap_conv`` against ``tap_conv_plain``: bf16 at B=64, T=360 for
     every (Cin, Cout, dilation) of the flagship's 15 k=3 convs and their dx
     forms (``tap_conv_transposed``, the backward's call: the conv with
     ``flip_taps(w)``), f32 at B=4, a ragged B=3, T=37, Cin=270, d=16, 270-
     and 272-channel inputs and outputs (forward and dx), T under one
     128-row tile, B=1, (1, 2, 1, 1, 1), misaligned x and w (copied; they
     must match); two runs must give the same bits;
  3d. K3 ``retrieval_ranks`` against ``retrieval_ranks_plain`` with Z bf16:
     the ``wgmma`` body at B=2048 and at the Trainer's B=64 (the depth split
     across SMs) at D=F·T=368,640 with Y f32 (three bf16 pieces), at B=64
     with Y bf16 (one piece) and at a ragged B=333, D=1000; the f32
     CUDA-core body at D=1001; each line with the body, pieces and depth
     slices it took (asserted); ranks must be equal except on rows whose
     plain similarity has an entry within 1e-6 of the diagonal (those rows
     are listed);
  4. K4 ``conv_block_fused`` against its plain version for blocks k=0..4 at
     (64, 360, D) in bf16 (the ``wgmma`` route, asserted: three launches of
     K6's conv body, ``csrc/conv_wg.cuh``), in f32 at a smaller batch (the
     CUDA-core body), and at ragged shapes in both where every dilation
     reaches both edges of the recording; two runs of each must give the
     same bits;
  4b. each of K6's six stages (``ops.conv_block_train`` F1, F2, F3, B1, B2,
     B3) against its plain version: blocks k=0..4 at (64, 360, 320) in bf16,
     f32 at B=4, ragged B=3, T=37 where d=16 reaches both edges (k=2, 4);
     outputs, the (2, C) sums, dW and db; every bf16 stage must take the
     ``wgmma`` route (``conv_block_train.route``), every f32 one ``tap3``;
     two runs must give the same bits; then one block's
     ``conv_block_train`` forward and backward against the module
     ``ConvBlock``'s train forward with autograd, in f32;
  4c. K7 ``f31`` (F3 of block k merged with F1 of block k+1) and
     ``f31_tile`` (K7 on the tap3 route in any dtype) against the plain
     version (the tap3 route against ``f31_plain``, the wgmma route stage by
     stage: out against ``f3_plain``, y0n and s0n against ``f1_plain`` on
     K7's own out):
     bf16 at (64, 360, 320) and f32 at B=4 for every boundary (k_next
     1..4), ragged B=3, T=37 at d0n=16 in f32 and bf16, and bf16 at B=3,
     T=400 (three time tiles) for k_next 2 and 3; each with its route
     asserted (``f31.route``: f31 ``wgmma`` in bf16, ``tap3`` in f32;
     f31_tile ``tap3``) and against K6's pair of that route on the same
     inputs (wgmma: ``f3`` then ``f1``, out, y0n and s0n bitwise; tap3:
     ``f3_tile`` then ``f1_tile``, out and y0n bitwise, s0n rtol 1e-6);
     every call repeated bit for bit;
  5. the whole encode at full width (S=27, C=208, T=360, D1=270, D2=320,
     F=1024, K=32, random BatchNorm running statistics): the fused serving
     path (K1 + five K4 launches) against the module path, f32 and bf16;
  6. the main path: ``SpeechDecoder`` with a 512-row f32 bank, then an int8
     bank, behind ``DecoderServer`` on an ephemeral port; 12 + 8 concurrent
     ``/decode`` requests of 1-16 rows each must equal a direct
     ``decoder.decode`` of the same rows. All four launch counters are set
     to 0 just before and read just after; K1 and K4 must have launched;
  7. timings with CUDA events (kernel, plain version, one PyTorch call where
     one exists, the bound for this card; K1 with and without its weight
     pack, and the decode's pack count, which must be 0; K4 beside the
     module eval ConvBlock on the same input), the fused vs module encode with
     the input on the card, retrieval against each bank, and one whole
     decode on the host clock; kernel launches per decode;
  8. one train step at full width in f32 (B=8), on the card and on the CPU
     from the same weights, batch and drop mask: loss, temperature, every
     parameter gradient and the new BN running statistics must agree; once
     through the module blocks and once with ``fused_blocks=True`` (K6);
  8b-8d. the data-preparation path at full width, with TF32 at PyTorch's
     defaults (cuDNN's on), run before any profiler trace slows the host;
     no hand-written kernel lies on it, so the launch counters, set to 0
     just before each phase and read just after, must stay 0 except for the
     bank's decode; each phase prints its peak device memory:
     ``preproc``: two (208, 48,000) recordings at 1 kHz band-passed 1-60 Hz
     and resampled to 120 Hz by ``preprocess_batch`` on the card against the
     port's own CPU run (fused and exact-grid routes) and the exact route
     against the scipy host twin ``preprocess_host``; int16 and bf16
     transfer against f32 on channels 1e-3..1e3 apart; ``preprocess_auto``
     forced onto the card and split by its measured rates (the probe and the
     split printed); then ``tools/bench_preproc``: the device-resident rate
     of the fused and the exact route on 2 x (208, 396,000) and the
     host-to-host rate per transfer dtype beside the host twin's;
     ``wav2vec2``: xlsr-53 (315M parameters, seeded random weights), the
     f32 ``last4_mean`` and ``features`` of 2 x 1 s on the card against the
     same weights on the CPU, then ``tools/bench_wav2vec`` at batch 16 in
     bf16 and f32; ``bank_from_audio``: 64 clips of 3 s at 44.1 kHz into a
     (64, 1024, 360) bank on the card (timed twice), 2 clips against the
     CPU run in f32, ``set_bank`` on the serving decoder and one decode of
     16 segments against it (K1 1, K4 5);
  8e. the CLI at the flagship widths (``cli``): a synthetic MEG-MASC-shape
     tree (27 subjects, 1 session, 1 task, 40 s, 320 words, 224 raw
     channels) built on the card (brain DSP, a random-weight xlsr-53 f32,
     the scale stats; no kernel launched), the device-resident gather bit
     for bit against ``sample_batch``, ``train.run`` at the config defaults
     with device-resident data (2 epochs of 24 updates, ``scan_steps`` 8,
     channels-last) and again on host batches, launches K1 2 a step + 1 an
     eval, K2 15 a step, K3 1 an eval, where a step launches from the host
     only in its first two calls (the module step replays a CUDA graph from
     its second call on, and a replay launches nothing that a counter sees);
     the run dir's ``config.yaml`` with
     ``resolved_seed``; ``tools.evaluate`` on the checkpoint reproducing the
     last epoch's eval (loss rel 2e-4, top-k abs 1e-6); the eval step timed;
     seconds, MEG-s/s, segments/s and peak memory printed;
  9. the second main path, training: the flagship train step as
     ``bench.py``'s ``build_flagship_step`` sets it up (B=64, bf16,
     channels-last, precomputed collate stats, ``conv_impl=gemm_pdw``)
     through ``training.make_train_step``: 3 warm-up steps, then 20 timed
     steps (CUDA events and host clock) with finite losses; the step
     replays its CUDA graph from the second warm-up step on, so the counters
     read 0 in the timed steps and in 3 profiled ones, and the CUDA kernel
     records of the profiled replays a step must be K1 2 (forward, dX) and
     K2 15, every other kernel 0;
  9b. the fused train path: the same step with ``fused_blocks=True``, 3 + 20
     steps; launches per step each K6 stage 5, K1 2, K2 15 (the dW of B1, B2
     and B3), K5 0; a ``profile`` line; then the module and the fused step in
     turns (module, fused, fused, module) in this call;
  9c. the ``pallas_taps`` path: the flagship step with
     ``tpu.conv_impl=pallas_taps``, 3 + 10 steps, replayed as in 9: kernel
     records per step K5 30 (15 forward, 15 dx), K2 15, K1 2;
  10. the third main path, eval: ``training.make_chunked_eval`` over an
     assumed test set of 2048 segments after that training, in chunks of the
     config's ``tpu.eval_chunk_size`` as the trainer takes them; launches
     must be K1 one per chunk and K3 one, K3 on its ``wgmma`` body with three
     pieces (asserted); timed; then the same eval with the
     ``pallas_taps`` encoder: K5 15 per chunk, K1 one per chunk, K3 one;
  11. timings of K1's backward dX (Wᵀ packed in the call, as each step
     does), K2 (each of the 15 launches of a step and their sum), K5 (the 30
     launches of a ``pallas_taps`` step, against ``F.conv1d``), K1 dX, K2,
     K5, K6 and K3 each by CUDA events and on the device alone (kernel
     durations summed from ``torch.profiler``) with the share of the bound;
     K1's forward (beside the wmma body, the flagship's route before the
     wgmma body, and ``torch.bmm``) and K4 (beside the module eval
     ConvBlock stack) on the device alone, taken only
     here because a profiler trace slows every later launch on the host; K6
     per block (each stage by events and on the device, F1+F2+F3 and
     B1+B2+B3 beside the module ``ConvBlock`` forward and backward, and the
     tap3 route, the parent's body, on the same inputs; at k=0 the
     272-channel copy of x) and K3 at B=2048 and B=64 (Z bf16, Y f32):
     kernel, plain, library yardstick, bound, each by CUDA events and on the
     device, the new body's preparation and products apart, the f32
     CUDA-core body (the parent's route for these inputs) with and without
     its preparation, and the yardstick with and without its own;
  12. the K7 tool path: ``speech_decoding_tpu_torch.tools.bench_cross_block_merge``
     for every boundary k_next 1..4 (equivalence, then the tap3 pair, the
     wgmma pair, f31_tile and f31 timed by CUDA events), re-emitted as one
     ``tool`` line each with the four on the device alone, K7's plain time,
     bound and f31's waits on its ready counters;
  12b. BN, the module path's train-mode BatchNorm + GELU:
     ``speech_decoding_tpu_torch.tools.bench_batchnorm_gelu`` at the
     benchmark cell's shape (B=256, T=360, C=320), with and without the
     residual input (h, the moved running statistics, dy, the skip's
     gradient, dscale and dbias against the plain version at the card
     tests' tolerances, raising past one; then ms by CUDA events and on the
     device, each kernel apart, beside the bytes' bound and the plain
     version's eager chain), one ``tool`` line with its launches;
  12c. GLU, the module path's ConvBlock GLU: ``speech_decoding_tpu_torch.tools
     .bench_glu`` at the benchmark cell's shape (Y 256 × 360 × 640): h and dY
     against the f32 formulas within one bf16 rounding (raising past it),
     then one block's forward and backward by CUDA events and on the device
     (each kernel apart), beside the bytes' bound (0.141 ms), the plain
     chain's same two times and the library's (``torch.nn.functional.glu``),
     one ``tool`` line
     with its launches; GLU's launches are counted on every path: 10 a
     module-path bf16 train step (15 with remat), 5 an eval forward, 0 on the
     fused, serving and f32 paths;
  13. the training loop, each path with every counter set to 0 just before
     and read just after: ``trainer``, the port's ``tools/scale_run`` at the
     flagship (4 epochs of 100 updates over a device-resident pool of 512 +
     64 held-out segments, ``scan_steps`` 8, checkpoints in a temporary
     directory, keep 2, best by testTop10acc): the learning gate of
     tests/test_learning_gate.py must clear, launches K1 2 a step that
     launches from the host (the first two; the rest replay the graph) + 1
     an eval, K2 15 such a step, K3 1 an epoch (on the ``wgmma`` body, one piece,
     the depth split: asserted); ``trainer_fused``: one epoch of 12
     steps with ``tpu.fused_train_blocks=true`` on host batches (pinned
     copies): each K6 stage 5 a step; ``preemption``: a real SIGTERM from
     ``PreemptionGuard(inject_after_steps=2)`` stops an epoch after 16
     steps, the state is saved, a fresh Trainer resumes it bit for bit
     (step, parameters, BN statistics, temperature, Adam moments) and runs
     one more epoch; ``checkpoint_serve``: ``SpeechDecoder.from_checkpoint
     (best=True)`` decodes the 64 held-out segments against their Y (K1 and
     K4), its top-10 hit rate within 2/64 of the same orientation computed
     through the eval path from the same checkpoint;
  13e. xlsr-53's bf16 ``last4_mean`` on 16 x 1 s by CUDA events beside
     its kernels' device time (``torch.profiler``);
  15. data parallelism in spawned ranks (``parallel.multihost.spawn_ranks``):
     one rank over NCCL at world size 1 (the flagship module and fused group
     steps beside the one-process step in the same rank, f32 B=8 against one
     process, one collective's cost) and two gloo ranks both on cuda:0 (f32
     global B=16 against one process, 3 bf16 steps with the state compared
     across the ranks after each, a Trainer epoch with checkpoint and resume
     against a one-process epoch);
  16. remat (``tpu.remat``), in a fresh NCCL rank at world size 1: the
     flagship bf16 step with and without remat on the module convs and on
     ``pallas_taps`` at B=64 and B=256: ms a step by CUDA events and host
     clock, device busy time (``torch.profiler``, taken last), the memory
     resident before the steps and the peak during them, launches a step
     (K1 2, K2 15; K5 30 plain, 45 under remat); one more B=256 remat step
     on each conv_impl in which every K1, K2 and K5 launch is held against
     its plain version on the inputs the step gave it; one f32 B=8 remat step
     against the plain step on phase 8's bounds, in one process, as an NCCL
     group step, and as a gloo group step of global B=16 on two ranks, with
     the collectives each step made (equal with and without remat); the
     bf16 group step with and without remat timed, with its collectives;
  17. the row-sharded bank (``SpeechDecoder.set_bank(..., group=)``): a
     flagship encoder and a host bank of 8,192 candidates (F·T = 368,640;
     12.1 GB f32, 3.0 GB int8, drawn on the card a chunk at a time from a
     seed) over NCCL at world size 1, and one of 512 candidates over two
     gloo ranks (they check the merge, not capacity), f32 then int8, a B=64
     decode (k=10) against the one-process decoder on the same bank (scores within
     1e-5 / 1e-6, ids equal outside near-ties, every rank's answer equal),
     each rank's resident bank bytes, peak memory above what was allocated
     before (during ``set_bank`` and through the decodes) and decode ms; the
     int8 similarity on 1,024 rows against the same products summed in f32;
     launches K1 1 and K4 5 a decode;
  18. sharded preprocessing (``parallel.preproc_sharded``): one recording
     (208, 396,000) f32 at 1000 Hz, band 1-60 Hz, to 120 Hz: the
     time-sharded band-pass (its halo by one all-gather), the channel-sharded resample and band-pass +
     resample chain, over NCCL at world size 1 and over two gloo ranks,
     each against the one-process function on the card at JAX's tolerances,
     with ms and MEG-s/s; no kernel launched;
  19. the "model" axis (``parallel.make_grid``, the encoder split by
     ``parallel.partition_encoder`` at min_dim 64: 21 of the train state's
     60 leaves) in spawned ranks: (a) a 1×2 grid of two gloo ranks on
     cuda:0, the flagship f32 step at global B=16 against the one-process
     step (gradients summed over the data axis and gathered over the model
     axis, phase 8's bounds) on the module convs, ``fused_train_blocks``
     (K6 on gathered weights) and ``pallas_taps`` (K5 on gathered weights),
     each with its launches and its collectives by axis; three bf16 steps at
     B=64 against one process (losses, host-clock ms, collectives a step,
     K1's body and launches, K2's); one more step in which every K1 (135
     output columns, ``wmma``), K1 dX and K2 (Cout 160 and 320) launch is
     held against its plain version; (c) one more step under
     ``utils.profiling.trace`` with every model-axis collective in an
     ``annotate`` range; (b) a 2×2 grid of four gloo ranks: the f32 check;
     a 1×1 grid over NCCL at world size 1 (f32 check, 3 bf16 steps beside
     the one-process step) and, in that fresh process, K1 forward and dX at
     135 against 270 columns and K2's 15 launches at the block's Cout
     against the whole, by CUDA events and on the device;
  20. ``tools.ab_int8_retrieval`` once: 4,096 flagship candidates
     (D = 368,640) and a B=64 query batch, the port's chunked bf16 upcast
     against the whole-bank upcast, int8 × int8 → int32 chunks and f32;
  14. the ``kernels`` summary line (K1, K4, K2, K3, K5, K6, K7, BN, GLU, each with its
     launches by path and device ms; K7 with its body, its bitwise partner
     and its tap3 route), the card line again, and last ``{"ok": true,
     "device": {...}}``.

Any mismatch or exception exits non-zero without the last line; so does a
machine without a CUDA device, or a directory without the port package.
Weights are random, made from ``--seed`` (default 0).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of the H100 SXM (NVIDIA data sheet, 700 W): bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores, device-memory bytes/s
H100_SXM = ("H100 80GB HBM3", {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12})


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    if H100_SXM[0] not in name:
        raise RuntimeError(f"no published peaks on record for {name!r}")
    return H100_SXM[1]


def bound_ms(flops: float, nbytes: float, peaks: dict, kind: str):
    t_ops = flops / peaks[kind] * 1e3
    t_mem = nbytes / peaks["bytes"] * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want, atol: float, rtol: float, show: bool = True, **extra) -> float:
    """Elementwise |got - want| <= atol + rtol·|want| (in f32); raises
    otherwise. Prints a ``check`` line (with ``extra``) unless ``show`` is
    false; returns max |Δ|."""
    import torch

    torch.cuda.synchronize()
    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite values")
    err = (g - w).abs()
    worst = float((err - rtol * w.abs()).max())
    max_abs = float(err.max())
    if show:
        emit(check=name, max_abs_err=max_abs, max_abs_ref=float(w.abs().max()), atol=atol, rtol=rtol, **extra)
    if worst > atol:
        raise AssertionError(f"{name}: max |got - want| - rtol·|want| = {worst} > {atol}")
    return max_abs


def misaligned(t):
    """A contiguous copy of ``t`` whose base lies one element past an
    allocation's start, so not 16-byte aligned."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


def device_ms(fn, reps: int = 10, attempts: int = 3):
    """Device ms per call: the durations of every kernel ``reps`` calls
    launch (the wrapper's operand copies included, the host's time between
    launches not), summed from a ``torch.profiler`` trace; None if the
    profiler saw no device activity in ``attempts`` traces (a trace now and
    then comes back without its device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if us:
            return us / reps / 1e3
    return None


def flagship_convs(D1: int, D2: int, dilations):
    """(Cin, Cout, dilation) of the encoder's 15 k=3 convs, in step order."""
    convs = []
    for k in range(5):
        d0, d1 = dilations(k)
        convs += [(D1 if k == 0 else D2, D2, d0), (D2, D2, d1), (D2, 2 * D2, 2)]
    return convs


# the collate of bench.py's build_flagship_step: precomputed scale stats, channels-last
FLAGSHIP_COLLATE = {"baseline_len_samp": 60, "clamp_lim": 20.0, "clamp": True, "precomputed": True,
                    "channels_last": True}


def random_bn_stats(encoder, gen) -> None:
    """Non-trivial BatchNorm parameters and running statistics."""
    import torch

    with torch.no_grad():
        for blk in encoder.conv_blocks:
            for bn in (blk.batchnorm0, blk.batchnorm1):
                n = bn.mean.numel()
                bn.mean.copy_(0.2 * torch.randn(n, generator=gen))
                bn.var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
                bn.scale.copy_(0.8 + 0.4 * torch.rand(n, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(n, generator=gen))


def data_prep_phases(seed: int, decoder, seg: int, reset_counts, read_counts, expect) -> dict:
    """Phases 8b-8d: the data-preparation path at full width, with TF32 at
    PyTorch's defaults (cuDNN on, matmuls off): the port's f32 entry points
    must stay f32 whatever the flags say. Each phase sets every launch
    counter to 0 just before and reads them just after (none of the path's
    work is a hand-written kernel; the bank's decode launches K1 and K4),
    and prints its peak device memory. ``decoder`` is the flagship serving
    decoder, whose segments are ``seg`` samples. Returns the launches by
    path."""
    import torch

    from speech_decoding_tpu_torch.inference import bank_from_audio
    from speech_decoding_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from speech_decoding_tpu_torch.models.wav2vec_util import FrozenWav2Vec2
    from speech_decoding_tpu_torch.ops import brain_preproc as bpp
    from speech_decoding_tpu_torch.ops import preproc_dispatch as ppd
    from speech_decoding_tpu_torch.ops.brain_preproc_host import preprocess_host, usable_cpus
    from speech_decoding_tpu_torch.tools import bench_preproc, bench_wav2vec

    def begin():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()

    def peak_gb(fn):
        """fn()'s result and the peak device memory (GB) while it ran."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() / 1e9

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    tf32 = {"cudnn.allow_tf32": cudnn.allow_tf32, "cuda.matmul.allow_tf32": matmul.allow_tf32}
    paths = {}
    rng = np.random.default_rng(seed + 11)
    pre = (1000.0, 1.0, 60.0, 120.0)  # 1 kHz, band-pass 1-60 Hz, to 120 Hz
    try:
        # -- 8b. preproc: two (208, 48,000) recordings, every route ------------
        begin()
        recs = [rng.standard_normal((208, 48_000), dtype=np.float32) for _ in range(2)]
        t = time.perf_counter()
        card = {r: bpp.preprocess_batch(recs, *pre, exact_grid=r == "exact") for r in ("fused", "exact")}
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = {r: bpp.preprocess_batch(recs, *pre, exact_grid=r == "exact", device="cpu") for r in card}
        cpu_s = time.perf_counter() - t
        host = preprocess_host(recs, *pre)
        # f32 FFTs on both sides (cuFFT against the CPU's pocketfft or scipy):
        # the DSP tolerance of the CPU tests, rtol 1e-4 + atol 1e-5 on
        # unit-variance inputs
        for j in range(2):
            for r in card:
                compare(f"preproc {r} card vs CPU, recording {j} (208, 48000)", torch.from_numpy(card[r][j]),
                        torch.from_numpy(cpu[r][j]), 1e-5, 1e-4)
            compare(f"preproc exact card vs host twin (scipy), recording {j}", torch.from_numpy(card["exact"][j]),
                    torch.from_numpy(host[j]), 1e-5, 1e-4)
        # quantized transfers against f32 on channels 1e-3..1e3 apart:
        # |Δ| / max|f32| of the channel within the JAX tests' bounds
        # (tests/test_ops.py:472-473)
        amps = (10.0 ** rng.uniform(-3, 3, size=(208, 1))).astype(np.float32)
        recs_q = [r * amps for r in recs]
        f32q = bpp.preprocess_batch(recs_q, *pre)
        quant = {}
        for dt, bound in (("int16", 2e-4), ("bfloat16", 6e-3)):
            got = bpp.preprocess_batch(recs_q, *pre, transfer_dtype=dt)
            quant[dt] = max(float((np.abs(g - a) / np.abs(a).max(axis=-1, keepdims=True)).max())
                            for g, a in zip(got, f32q))
            emit(check=f"preproc {dt} transfer vs f32 on the card", max_rel_err=quant[dt], bound=bound,
                 relative_to="max |f32| of each channel")
            if not quant[dt] <= bound:
                raise AssertionError(f"preproc {dt} transfer: {quant[dt]} > {bound}")
        # the dispatcher: all on the card, then split by measured rates; int16
        # transfer (its default) against the host twin within the JAX test's
        # 5e-4 of the largest entry (tests/test_preproc_dispatch.py:128)
        recs6 = recs + [rng.standard_normal((208, 48_000), dtype=np.float32) for _ in range(4)]
        host6 = preprocess_host(recs6, *pre)
        rates = ppd.probe_rates(208, *pre)
        split, dev_e2e = ppd.route_plan([48.0] * 6, rates, 208, 1000.0, 120.0)
        auto_err = {}
        for name, kw in (("force_device", {"force": "device"}), ("measured_rates", {"rates": rates})):
            outs = ppd.preprocess_auto(recs6, *pre, verbose=False, **kw)
            auto_err[name] = max(float(np.abs(o - h).max() / np.abs(h).max()) for o, h in zip(outs, host6))
            if not auto_err[name] < 5e-4 or [o.shape for o in outs] != [h.shape for h in host6]:
                raise AssertionError(f"preprocess_auto {name}: {auto_err[name]} against the host twin")
        emit(check="preprocess_auto (int16 transfer) vs host twin", max_rel_err=auto_err, bound=5e-4,
             probe=rates, device_e2e_model=dev_e2e, host_cpus=usable_cpus(), split=split)
        checks_gb = torch.cuda.max_memory_allocated() / 1e9
        fused, fused_gb = peak_gb(bench_preproc.measure_preproc_rate)
        exact, exact_gb = peak_gb(lambda: bench_preproc.measure_preproc_rate(route="exact"))
        e2e, e2e_gb = peak_gb(bench_preproc.measure_preproc_e2e)
        paths["preproc"] = read_counts()
        emit(phase="preproc", tf32=tf32, checks_card_s=card_s, checks_cpu_s=cpu_s, quantized=quant,
             rate_fused=fused, rate_exact=exact, e2e=e2e, launches=paths["preproc"],
             peak_memory_gb={"checks": checks_gb, "rate_fused": fused_gb, "rate_exact": exact_gb, "e2e": e2e_gb})
        if paths["preproc"] != expect():
            raise AssertionError(f"preproc launched a kernel: {paths['preproc']}")
        del card, cpu, host, recs_q, f32q, recs6, host6, outs

        # -- 8c. wav2vec2: xlsr-53 with seeded random weights -------------------
        begin()
        cfg = Wav2Vec2Config()
        model = Wav2Vec2Model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 12))
        model_cpu = Wav2Vec2Model(cfg, device="meta")
        model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
        n_params = sum(p.numel() for p in model.parameters())
        w_card = FrozenWav2Vec2(model, device="cuda")
        w_cpu = FrozenWav2Vec2(model_cpu, device="cpu")
        clips = (rng.standard_normal((2, 16_000)) * 0.1).astype(np.float32)
        embed = {}
        for name in ("last4_mean", "features"):
            t = time.perf_counter()
            got = getattr(w_card, name)(clips)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t
            t = time.perf_counter()
            want = getattr(w_cpu, name)(clips)
            cpu_s = time.perf_counter() - t
            # f32 on both sides, sums in another order over 24 layers: 2e-4
            # of the largest entry (the JAX package's full-scale test)
            bound = 2e-4 * float(want.abs().max())
            embed[name] = compare(f"wav2vec2 xlsr-53 {name} f32 card vs CPU, 2 x 1 s", got.cpu(), want, bound, 0.0,
                                  shape=list(got.shape), card_first_call_s=card_s, cpu_s=cpu_s)
        checks_gb = torch.cuda.max_memory_allocated() / 1e9
        rate16, rate16_gb = peak_gb(lambda: bench_wav2vec.measure_embed_rate(16, "bfloat16"))
        rate32, rate32_gb = peak_gb(lambda: bench_wav2vec.measure_embed_rate(16, "float32"))
        paths["wav2vec2"] = read_counts()
        emit(phase="wav2vec2", tf32=tf32, config="xlsr-53: 24 layers, hidden 1024, 16 heads, FFN 4096, "
             "7-layer 512-channel extractor; random weights from a seed", params=n_params, max_abs_err=embed,
             embed_rate_bf16=rate16, embed_rate_f32=rate32, launches=paths["wav2vec2"],
             peak_memory_gb={"checks": checks_gb, "rate_bf16": rate16_gb, "rate_f32": rate32_gb})
        if paths["wav2vec2"] != expect():
            raise AssertionError(f"wav2vec2 launched a kernel: {paths['wav2vec2']}")

        # -- 8d. bank_from_audio: 64 clips of 3 s at 44.1 kHz -> the serving bank
        begin()
        audio = (rng.standard_normal((64, 132_300)) * 0.1).astype(np.float32)
        build_s = []
        for _ in range(2):  # the first call includes cuDNN's and cuFFT's plans
            t = time.perf_counter()
            bank = bank_from_audio(w_card, audio, 44_100, segment_len=seg)
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t)
        if tuple(bank.shape) != (64, cfg.hidden_size, seg) or not bool(torch.isfinite(bank).all()):
            raise AssertionError(f"bank {tuple(bank.shape)} is not finite (64, {cfg.hidden_size}, {seg})")
        want = bank_from_audio(w_cpu, audio[:2], 44_100, segment_len=seg, batch_size=2)
        bank_err = compare("bank_from_audio f32 card vs CPU, clips 0-1", bank[:2].cpu(), want,
                           2e-4 * float(want.abs().max()), 0.0)
        decoder.set_bank(bank)
        Xd = rng.standard_normal((16, 208, seg), dtype=np.float32)
        scores, ids = decoder.decode(Xd, rng.integers(0, 27, size=16).astype(np.int32), k=10)
        torch.cuda.synchronize()
        paths["bank_from_audio"] = read_counts()
        if not (np.isfinite(scores).all() and ids.shape == (16, 10) and ids.min() >= 0 and ids.max() < 64):
            raise AssertionError("decode against the audio bank returned bad scores or ids")
        emit(phase="bank_from_audio", tf32=tf32, clips=64, clip_s=3.0, sample_rate=44_100,
             bank_shape=list(bank.shape), build_s=build_s, build_clips_per_s=64 / build_s[1],
             max_abs_err=bank_err, decode_rows=16, launches=paths["bank_from_audio"],
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if paths["bank_from_audio"] != expect(subject_matmul=1, conv_block_fused=5):
            raise AssertionError(f"bank_from_audio launches: {paths['bank_from_audio']}")
        del model, model_cpu, w_card, w_cpu, bank
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return paths


def cli_phase(seed: int, reset_counts, read_counts, expect) -> dict:
    """Phase 8e: the CLI at the flagship widths on a synthetic MEG-MASC-shape
    tree (27 subjects, 1 session, 1 task, 40 s, 320 words, 224 raw
    channels of which 208 are MEG; ``data/synthetic.make_gwilliams_tree``)
    in a temporary directory: the dataset built on the card (the brain DSP
    through ``preprocess_batch``, the stimulus through a random-weight
    xlsr-53 f32), the device-resident gather against ``sample_batch``, then
    ``train.run`` with the defaults of ``configs/config.yaml`` and
    device-resident data (2 epochs of 24 updates, ``scan_steps`` 8,
    channels-last by the CLI's rule), the same on host batches (native
    gather, pinned copies), ``tools.evaluate`` on the first run's
    checkpoint, and the eval step timed by CUDA events. Each path sets every
    launch counter to 0 just before and reads them just after. Run at
    PyTorch's TF32 defaults (cuDNN on, matmuls off), as the CLI runs. Returns
    the launches by path."""
    import torch
    import yaml

    from speech_decoding_tpu_torch import train
    from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams
    from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022ShallowSplit
    from speech_decoding_tpu_torch.data.layout import ch_locations_2d
    from speech_decoding_tpu_torch.data.sampling import random_split
    from speech_decoding_tpu_torch.data.synthetic import make_config, make_gwilliams_tree
    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from speech_decoding_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from speech_decoding_tpu_torch.models.wav2vec_util import FrozenWav2Vec2
    from speech_decoding_tpu_torch.ops.retrieval import retrieval_ranks
    from speech_decoding_tpu_torch.tools.evaluate import evaluate
    from speech_decoding_tpu_torch.training import CheckpointManager, create_train_state, make_eval_step

    S, SECS, WORDS, EPOCHS, UPDATES = 27, 40.0, 320, 2, 24
    dims = {"gwilliams.num_subjects": S, "gwilliams.num_sessions": 1, "gwilliams.num_tasks": 1}
    secs = {}

    class TimedBuild(Gwilliams2022ShallowSplit):
        """The shallow split with its two build stages timed (host clock,
        ending in a synchronize)."""

        def brain_preproc_all(self):
            t = time.perf_counter()
            out = super().brain_preproc_all()
            torch.cuda.synchronize()
            secs["brain_preproc"] = time.perf_counter() - t
            return out

        def audio_preproc(self):
            t = time.perf_counter()
            out = super().audio_preproc()
            torch.cuda.synchronize()
            secs["audio_embedding"] = time.perf_counter() - t
            return out

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    paths = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        make_gwilliams_tree(tmp, n_subjects=S, n_sessions=1, n_tasks=1, rec_secs=SECS, n_words_per_task=WORDS)
        secs["tree"] = time.perf_counter() - t
        raw_gb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(tmp) for f in fs) / 1e9

        # -- the build on the card: brain DSP, xlsr-53 (random weights), stats
        reset_counts()
        w2v = FrozenWav2Vec2(Wav2Vec2Model(Wav2Vec2Config(), device="cuda",
                                           generator=torch.Generator(device="cuda").manual_seed(seed + 12)),
                             device="cuda")
        t = time.perf_counter()
        ds = TimedBuild(make_config(tmp, "Gwilliams2022", rebuild_dataset=True), wav2vec=w2v, device="cuda",
                        num_subjects=S, num_sessions=1, num_tasks=1)
        torch.cuda.synchronize()
        secs["build"] = time.perf_counter() - t
        paths["cli_build"] = read_counts()
        del w2v
        if paths["cli_build"] != expect():
            raise AssertionError(f"the dataset build launched a kernel: {paths['cli_build']}")
        # every word window inside its recording (X, the shift folded into
        # the onsets) and its stimulus embedding (Y)
        L = ds.seq_len_samp
        x_in = all(int(ds.meg_onsets[k][tk].max()) + L <= ds.X[k][tk].shape[-1] and ds.meg_onsets[k][tk].min() >= 0
                   for k in ds.X for tk in ds.X[k])
        if not (x_in and len(ds) == WORDS and ds.Y.shape[1:] == (1024, L) and np.isfinite(ds.Y).all()):
            raise AssertionError(f"the build: windows inside {x_in}, {len(ds)} segments, Y {ds.Y.shape}")
        meg_secs = sum(x.shape[-1] for tasks in ds.X.values() for x in tasks.values()) / 120.0

        # -- the device-resident gather against sample_batch, bit for bit in f32
        batcher = DeviceResidentGwilliams(ds, store_dtype="float32", channels_last=True, device="cuda")
        ids = np.random.default_rng(seed).choice(len(ds), 64, replace=False)
        got = batcher.gather(batcher.make_index_batch(np.random.default_rng(seed + 1), ids))
        want = ds.sample_batch(np.random.default_rng(seed + 1), ids)
        same = {k: bool(np.array_equal(got[k].cpu().numpy().transpose(0, 2, 1) if k in ("X", "Y")
                                       else got[k].cpu().numpy(), want[k])) for k in want}
        stacks_gb = batcher.nbytes / 1e9
        emit(check="cli device-resident gather (channels-last, f32) vs sample_batch, 64 segments",
             bitwise_equal=same, stacks_gb=stacks_gb)
        if not all(same.values()):
            raise AssertionError(f"device-resident gather differs from sample_batch: {same}")
        del batcher, got, want

        def cfg_for(**over):
            return make_config(tmp, "Gwilliams2022", epochs=EPOCHS, updates=UPDATES, **dims, **over)

        def one_run(name, cfg):
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            with made_train_steps() as made:
                hist = train.run(cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            paths[name] = read_counts()
            steps, evals = EPOCHS * UPDATES, EPOCHS
            # the module step replays its graph from its second call on (one batch size)
            launched = launched_steps(steps, made)
            want = expect(subject_matmul=2 * launched + evals, tap_conv_dw=15 * launched, retrieval_ranks=evals,
                          batchnorm_gelu=BN_STEP * launched, glu=GLU_STEP * launched + GLU_FORWARD * evals)
            if (launched != 2 or paths[name] != want
                    or not all(np.isfinite([h[k] for h in hist for k in ("train_loss", "test_loss")]))):
                raise AssertionError(f"{name}: launches {paths[name]} in {launched} launched steps, expected {want}; "
                                     f"{hist}")
            return hist, wall

        # -- the device-resident run (config.yaml defaults, channels-last by the CLI's rule)
        cfg = cfg_for(run_name="device_resident", **{"tpu.device_resident_data": True})
        hist, wall = one_run("cli_device_resident", cfg)
        run_dir = [dp for dp, _, fs in os.walk(os.path.join(tmp, "outputs")) if "config.yaml" in fs][0]
        with open(os.path.join(run_dir, "config.yaml")) as f:
            snap = yaml.safe_load(f)
        if snap.get("resolved_seed") != cfg.resolved_seed or snap["tpu"]["channels_last_io"] is not True:
            raise AssertionError(f"the run dir's config.yaml: resolved_seed {snap.get('resolved_seed')}")
        emit(phase="cli_device_resident", steps=EPOCHS * UPDATES, wall_s=wall, config=(
             "configs/config.yaml defaults: B=64 D1=270 D2=320 K=32 F=1024 S=27 T=360 bf16, conv_impl gemm, "
             "scan_steps 8, shallow split, device_resident_data, channels-last"),
             train_loss=[h["train_loss"] for h in hist], test_loss=[h["test_loss"] for h in hist],
             testTop10acc=[h["testTop10acc"] for h in hist],
             segments_per_s_by_epoch=[h["train_segments_per_sec"] for h in hist],
             segments_per_s_after_first_epoch=hist[-1]["train_segments_per_sec"], run_dir_config_yaml=True,
             resolved_seed=snap["resolved_seed"], launches=paths["cli_device_resident"])

        # -- the host-batch run: native gather, pinned copies of X, Y, stats
        hist_h, wall_h = one_run("cli_host_batches", cfg_for(run_name="host_batches",
                                                              **{"tpu.device_resident_data": False}))
        # the host path's parts, one batch of 64 at a time (host clock, median
        # of 10 after one warm-up; not a path: no kernel runs)
        def host_ms(fn, reps=10):
            fn()
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            return float(np.median(ts)) * 1e3

        hb = ds.sample_batch(np.random.default_rng(seed + 2), ids)
        parts = {
            "sample_batch_ms": host_ms(lambda: ds.sample_batch(np.random.default_rng(seed + 2), ids)),
            "Y_index_ms": host_ms(lambda: ds.Y[ids]),
            "pinned_copy_to_card_ms": host_ms(lambda: [torch.from_numpy(np.asarray(v)).pin_memory().to(
                "cuda", non_blocking=True) for k, v in hb.items() if k != "subject_idxs"]),
        }
        emit(phase="cli_host_batches", steps=EPOCHS * UPDATES, wall_s=wall_h,
             train_loss=[h["train_loss"] for h in hist_h],
             segments_per_s_by_epoch=[h["train_segments_per_sec"] for h in hist_h],
             segments_per_s_after_first_epoch=hist_h[-1]["train_segments_per_sec"],
             host_bytes_per_step={"X": 64 * 208 * L * 4, "Y": 64 * 1024 * L * 4, "scale_stats": 64 * 208 * 2 * 4},
             host_batch_parts=parts, launches=paths["cli_host_batches"])
        del hb

        # -- evaluate on the first run's checkpoint, from its config.yaml
        args_e = train.parse_argv([os.path.join(run_dir, "config.yaml"),
                                   f"checkpoint.dir={os.path.join(run_dir, 'checkpoints')}"])
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        out = evaluate(args_e, device="cuda")
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        paths["cli_evaluate"] = read_counts()
        last = hist[-1]
        agree = {"epoch": out["epoch"] == last["epoch"],
                 "test_loss": abs(out["test_loss"] - last["test_loss"]) <= 2e-4 * abs(last["test_loss"]),
                 "testTop1acc": abs(out["testTop1acc"] - last["testTop1acc"]) <= 1e-6,
                 "testTop10acc": abs(out["testTop10acc"] - last["testTop10acc"]) <= 1e-6}
        emit(check="cli evaluate vs the last epoch's eval", evaluate=out, trained={k: last[k] for k in (
             "epoch", "test_loss", "testTop1acc", "testTop10acc")}, agree=agree, rel_bound=2e-4, abs_bound=1e-6,
             seconds=eval_s, launches=paths["cli_evaluate"])
        if not all(agree.values()) or paths["cli_evaluate"] != expect(subject_matmul=1, retrieval_ranks=1,
                                                                           glu=GLU_FORWARD):
            raise AssertionError(f"evaluate: {agree}, launches {paths['cli_evaluate']}")

        # -- the eval step alone on the device-resident test batch (timed; not a path)
        ds_e = Gwilliams2022ShallowSplit(args_e, device="cuda", num_subjects=S, num_sessions=1, num_tasks=1)
        b = DeviceResidentGwilliams(ds_e, channels_last=True, device="cuda")
        test_pool = random_split(len(ds_e), args_e.split_ratio, np.random.default_rng(args_e.resolved_seed))[1]
        tb = b.gather(b.make_index_batch(np.random.default_rng(args_e.resolved_seed + 1), test_pool))
        st = create_train_state(BrainEncoder.from_config(args_e, ch_locations_2d("Gwilliams2022", tmp), S),
                                device="cuda")
        st, _ = CheckpointManager(args_e.checkpoint.dir).restore_for_eval(st)
        step = make_eval_step(args_e.reduction, train.build_collate(args_e))
        eval_ms = time_ms(lambda: step(st, tb), reps=20)
        emit(phase="cli", tree_s=secs["tree"], raw_gb=raw_gb, build_s=secs["build"],
             brain_preproc_s=secs["brain_preproc"], meg_seconds=meg_secs,
             brain_meg_s_per_s=meg_secs / secs["brain_preproc"], audio_embedding_s=secs["audio_embedding"],
             stimulus_s=SECS * 0.9, device_resident_stacks_gb=stacks_gb,
             segments={"train": len(ds) - len(test_pool), "test": len(test_pool)},
             segments_per_s={"device_resident": hist[-1]["train_segments_per_sec"],
                             "host_batches": hist_h[-1]["train_segments_per_sec"]},
             eval_ms=eval_ms, eval_k3_route=retrieval_ranks.route, evaluate_s=eval_s,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             brain_preproc_note=f"brain_preproc_all: reading the {S} raw .npy files, preprocess_batch on the card")
        del ds, ds_e, b, tb, st
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return paths


def wav2vec2_device_timing(seed: int) -> None:
    """Phase 13e: xlsr-53's bf16 ``last4_mean`` on 16 x 1 s by CUDA events
    beside its kernels' device time (``torch.profiler``), taken after every
    host-clock timing as the other device readings are; the difference is
    the host's share of the call."""
    import torch

    from speech_decoding_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from speech_decoding_tpu_torch.models.wav2vec_util import FrozenWav2Vec2

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    w16 = FrozenWav2Vec2(Wav2Vec2Model(Wav2Vec2Config(), device="cuda", generator=gen), device="cuda",
                         dtype=torch.bfloat16)
    wav = torch.randn((16, 16_000), generator=gen, device="cuda") * 0.1
    ms = time_ms(lambda: w16.last4_mean(wav), reps=10)
    dev_ms = device_ms(lambda: w16.last4_mean(wav))
    emit(timing="wav2vec2 xlsr-53 last4_mean bf16, 16 x 1 s", ms=ms, device_ms=dev_ms or "not measured",
         device_share=dev_ms / ms if dev_ms else "not measured")


# -- 15. data parallelism: what each rank runs (spawned processes) -------------------------------
# NCCL refuses two ranks on one card, so on one card the data-parallel path
# runs at world size 1 over NCCL (the real collectives, each a no-op sum),
# and at world size 2 over gloo with both ranks on cuda:0 (gloo stages its
# collectives through the host: a check of the arithmetic, not a rate)

DP_SEED = 15  # the phase's weights, batches and masks, alike in every process
DP_STEPS = (3, 5)  # bf16 warm-up and timed steps of (a)
DP_TRAINER_STEPS = 12


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by name (K6 one per stage, K7
    its own, BN's kernels all under one, GLU's two under one), of this
    process."""
    from speech_decoding_tpu_torch.ops import conv_block_train as cbt
    from speech_decoding_tpu_torch.ops.batchnorm_gelu import bn_gelu_train
    from speech_decoding_tpu_torch.ops.conv_block import conv_block_fused
    from speech_decoding_tpu_torch.ops.glu import glu
    from speech_decoding_tpu_torch.ops.retrieval import retrieval_ranks
    from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul
    from speech_decoding_tpu_torch.ops.tap_conv import tap_conv, tap_conv_dw

    return {"subject_matmul": subject_matmul, "conv_block_fused": conv_block_fused, "tap_conv_dw": tap_conv_dw,
            "retrieval_ranks": retrieval_ranks, "tap_conv": tap_conv, "batchnorm_gelu": bn_gelu_train, "glu": glu,
            **{f"conv_block_train.{name}": fn for name, fn in cbt.STAGES.items()},
            **{f"conv_block_train.{name}_tile": fn for name, fn in cbt.TILE.items()},
            "conv_block_train.F31": cbt.f31, "conv_block_train.F31_tile": cbt.f31_tile}


def launched_steps(n: int, steps, captures: int = 0, replays: int = 0) -> int:
    """Of n calls of the train steps ``steps``, those whose kernels the
    launch counters see: every call but a replay of a CUDA graph, and the
    capturing call once (it launches under capture, then replays).
    ``captures`` and ``replays``: the steps' readings before the calls."""
    return (n - sum(getattr(s, "replays", 0) for s in steps) + replays
            + sum(getattr(s, "captures", 0) for s in steps) - captures)


@contextlib.contextmanager
def made_train_steps():
    """The train steps that Trainers make meanwhile (through
    ``training/trainer.py``'s ``make_train_step``), for their graph
    counters."""
    from speech_decoding_tpu_torch.training import trainer as trainer_module

    made, make = [], trainer_module.make_train_step

    def recorded(*a, **k):
        made.append(make(*a, **k))
        return made[-1]

    trainer_module.make_train_step = recorded
    try:
        yield made
    finally:
        trainer_module.make_train_step = make


# the CUDA kernels behind the train step's counters, by the names the
# profiler records (bf16 and f32 bodies; a K2 launch's split reduction is a
# kernel of its own and not counted): a replayed step's launches are read
# from these records, since a replay launches nothing from the host
KERNEL_RECORDS = {"subject_matmul": re.compile(r"\bsubject_matmul_(wg|tc|f32)_kernel"),
                  "tap_conv_dw": re.compile(r"\btap_conv_dw_(bf16|f32)_kernel"),
                  "tap_conv": re.compile(r"\btap_conv_bf16_kernel"),
                  "batchnorm_gelu": re.compile(r"\bbngelu_\w+_kernel"),
                  "glu": re.compile(r"\bglu_(fwd|bwd)_kernel")}

# BN's kernels a module-path bf16 train step with no group launches: ten
# layers (two a ConvBlock), three kernels forward and three back; with remat
# the forward runs again in the backward's recomputation
BN_STEP, BN_REMAT_STEP = 60, 90

# GLU's kernels: one forward and one backward a ConvBlock on every module
# path in bf16 (any group, any mode), so 10 a train step, 15 with remat (the
# forward again in the recomputation), 5 an eval forward; 0 on the fused,
# serving and f32 paths
GLU_STEP, GLU_REMAT_STEP, GLU_FORWARD = 10, 15, 5


def _reset_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def dp_args(dtype: str, overrides=()):
    from speech_decoding_tpu_torch.tools import scale_run

    return scale_run.flagship_args(1, [f"tpu.compute_dtype={dtype}", "tpu.scan_steps=1", *overrides])


def dp_state(dtype: str, device, group=None, lr: float = 3e-4, overrides=()):
    """The flagship train state from DP_SEED's weights (``overrides``: config
    keys such as ``tpu.remat=true``, which leave the weights as they are)."""
    from speech_decoding_tpu_torch.tools import scale_run
    from speech_decoding_tpu_torch.training import create_train_state

    enc = scale_run.make_encoder(dp_args(dtype, overrides), scale_run.FLAGSHIP, DP_SEED)
    return create_train_state(enc, lr=lr, device=device, group=group)


def dp_batch(n: int, salt: int) -> dict:
    """A host batch of n flagship segments (numpy, channels-last), with its
    precomputed collate statistics."""
    import torch

    from speech_decoding_tpu_torch.ops.scaling import window_scale_stats
    from speech_decoding_tpu_torch.tools import scale_run

    d = scale_run.FLAGSHIP
    rng = np.random.default_rng([DP_SEED, salt])
    X = (rng.standard_normal((n, d["T"], d["C"]), dtype=np.float32) * 10)
    stats = window_scale_stats(torch.from_numpy(X).transpose(1, 2)).numpy()
    return {"X": X, "Y": rng.standard_normal((n, d["T"], d["F"]), dtype=np.float32),
            "subject_idxs": rng.integers(0, d["S"], n).astype(np.int32), "scale_stats": stats}


def dp_mask(step: int):
    import torch

    from speech_decoding_tpu_torch.data.layout import ch_locations_2d
    from speech_decoding_tpu_torch.models.brain_encoder import spatial_dropout_mask

    loc = ch_locations_2d("Gwilliams2022", root_dir=ROOT, cache=False)
    return spatial_dropout_mask(torch.Generator().manual_seed(DP_SEED * 1000 + step), loc, 0.1)


def dp_f32_check(group, device, fused: bool, n: int) -> dict:
    """One f32 step on a global batch of n: the data-parallel step on the
    rank's block against the one-process step on the whole batch, on this
    card from the same weights, batch and mask. Phase 8's bounds: loss at
    rtol 1e-4, temperature 1e-6, each gradient (summed over the ranks) at
    1e-3 of its largest entry + 1e-4 of the model's largest gradient, the BN
    running statistics at atol 1e-5 + rtol 1e-4. Returns the errors over
    their bounds (<= 1 passes)."""
    import torch

    from speech_decoding_tpu_torch.parallel import shard_batch
    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    host, mask = dp_batch(n, 1), dp_mask(0)
    ref = dp_state("float32", device)
    ref, m_ref = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused)(ref, put_batch(host, ref.device),
                                                                              drop_mask=mask)
    st = dp_state("float32", device, group)
    st, m = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused, group=group)(
        st, shard_batch(host, group), drop_mask=mask)
    torch.cuda.synchronize()
    return f32_step_errors(st, m, {n: p.grad for n, p in st.encoder.named_parameters()}, ref, m_ref)


def f32_step_errors(st, m, grads, ref, m_ref) -> dict:
    """A step's loss, temperature, gradients (``grads``: by parameter name,
    whole and summed over the ranks) and BN running statistics against the
    one-process step ``ref``/``m_ref`` on phase 8's bounds (``dp_f32_check``);
    the errors over their bounds (<= 1 passes)."""
    grads = {name: (grads[name], q.grad) for name, q in ref.encoder.named_parameters()}
    grads["clip.temp"] = (st.clip.temp.grad, ref.clip.temp.grad)
    gmax = max(float(w.abs().max()) for _, w in grads.values())
    worst = (0.0, "")
    for name, (g, w) in grads.items():
        worst = max(worst, (float((g - w).abs().max()) / (1e-3 * float(w.abs().max()) + 1e-4 * gmax), name))
    stats = 0.0
    ref_bufs = dict(ref.encoder.named_buffers())
    for name, b in st.encoder.named_buffers():
        if name.endswith(("mean", "var")):
            w = ref_bufs[name]
            stats = max(stats, float(((b - w).abs() / (1e-5 + 1e-4 * w.abs())).max()))
    loss, loss_ref = float(m["loss"]), float(m_ref["loss"])
    return {"loss": loss, "loss_one_process": loss_ref,
            "loss_err_over_bound": abs(loss - loss_ref) / (1e-4 * abs(loss_ref)),
            "temp_err_over_bound": abs(float(m["temp"]) - float(m_ref["temp"])) / (1e-6 * abs(float(m_ref["temp"]))),
            "gradient_err_over_bound": worst[0], "worst_gradient": worst[1], "tensors": len(grads),
            "bn_stats_err_over_bound": stats,
            "topk_equal": [float(m["top1"]), float(m["top10"])] == [float(m_ref["top1"]), float(m_ref["top10"])]}


def dp_timed_steps(state, step, batch, n: int, first_step: int) -> dict:
    """n steps, every launch counter set to 0 just before and read just
    after; ms per step by CUDA events and the host clock; the steps that
    launched from the host (``launched_steps``: all but the replays of a
    CUDA graph, the capturing call's launches counted once)."""
    import torch

    captures, replays = getattr(step, "captures", 0), getattr(step, "replays", 0)
    torch.cuda.synchronize()
    _reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses = []
    t = time.perf_counter()
    start.record()
    for i in range(n):
        state, m = step(state, batch, drop_mask=dp_mask(first_step + i))
        losses.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    return {"ms_per_step_cuda_events": start.elapsed_time(end) / n,
            "ms_per_step_host_clock": (time.perf_counter() - t) / n * 1e3,
            "launches": _read_counts(), "losses": torch.stack(losses).float().tolist(),
            "launched_steps": launched_steps(n, [step], captures, replays)}


def dp_rank_nccl() -> dict:
    """(a): one rank over NCCL (world size 1, cuda:LOCAL_RANK)."""
    from speech_decoding_tpu_torch.parallel import data_group
    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    group = data_group()
    out = {"backend": "nccl", "world": group.world, "device": str(group.device),
           "f32_b8": {("fused" if f else "module"): dp_f32_check(group, group.device, f, 8) for f in (False, True)}}
    batch = put_batch(dp_batch(64, 2), group.device)
    warm, timed = DP_STEPS
    steps = {}
    for fused in (False, True):
        runs = {}
        for name, grp in (("one_process", None), ("group", group)):
            st = dp_state("bfloat16", group.device, grp)
            step = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused, group=grp)
            for i in range(warm):
                st, _ = step(st, batch, drop_mask=dp_mask(i))
            runs[name] = dp_timed_steps(st, step, batch, timed, warm)
            runs[name]["gradient_floats"] = sum(p.numel() for p in [*st.encoder.parameters(), st.clip.temp])
            steps[fused, name] = step, st
        out["fused" if fused else "module"] = runs
    out["collectives"] = dp_collective_ms(group)
    # device times last: a profiler trace slows every later launch on the host
    for (fused, name), (step, st) in steps.items():
        out["fused" if fused else "module"][name]["device_busy_ms_per_step"] = dp_device_busy_ms(step, st, batch)
    return out


def dp_device_busy_ms(step, state, batch, n: int = 3):
    """Device time a step (kernels and copies, summed from torch.profiler
    over n more steps), taken after the timed steps it would slow."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            state, _ = step(state, batch, drop_mask=dp_mask(100 + i))
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return us / n / 1e3 if us else "not measured"


def dp_collective_ms(group, reps: int = 50) -> dict:
    """What one collective of the step costs at this world size: an
    all-reduce of a BN sum (2, 320) f32 on the host clock (each call
    synchronised, and back to back) and by CUDA events, and the gradient
    all-reduce (9.5 M f32 flattened, then copied back) by CUDA events."""
    import torch

    from speech_decoding_tpu_torch.parallel.collectives import all_reduce_, all_reduce_grads

    small = torch.ones(2, 320, device=group.device)
    for _ in range(5):
        all_reduce_(small, group)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        all_reduce_(small, group)
        torch.cuda.synchronize()
    synced = (time.perf_counter() - t) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(reps):
        all_reduce_(small, group)
    end.record()
    host = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    st = dp_state("bfloat16", group.device)
    params = [*st.encoder.parameters(), st.clip.temp]
    for p in params:
        p.grad = torch.ones_like(p)
    all_reduce_grads(params, group)
    torch.cuda.synchronize()
    g0, g1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    g0.record()
    for _ in range(5):
        all_reduce_grads(params, group)
    g1.record()
    torch.cuda.synchronize()
    return {"bn_sum_all_reduce_ms_synced_host_clock": synced, "bn_sum_all_reduce_ms_back_to_back_host_clock": host,
            "bn_sum_all_reduce_ms_cuda_events": start.elapsed_time(end) / reps,
            "gradient_all_reduce_ms_cuda_events": g0.elapsed_time(g1) / 5,
            "gradient_all_reduce_ms_host_clock": (time.perf_counter() - t) / 5 * 1e3,
            "collectives_per_step": "28 on either path: 20 BN sums (10 forward, 10 backward), 7 in the CLIP loss "
                                    "and its top-k (gather, column max, column sums, loss; the column sums' and the "
                                    "gather's backward; hit counts), 1 gradient all-reduce"}


def dp_rank_gloo(ckdir: str) -> dict:
    """(b) and (c): one of two ranks over gloo, both on cuda:0."""
    import torch

    from speech_decoding_tpu_torch.parallel import data_group, shard_batch
    from speech_decoding_tpu_torch.parallel.collectives import assert_same_on_ranks
    from speech_decoding_tpu_torch.parallel.multihost import host_local_slice
    from speech_decoding_tpu_torch.training import CheckpointManager, Trainer, make_train_step
    from speech_decoding_tpu_torch.training.state import state_digest
    from speech_decoding_tpu_torch.tools import scale_run

    group = data_group("cuda:0")
    out = {"backend": "gloo", "world": group.world, "rank": group.rank, "device": str(group.device),
           "f32_b16": {("fused" if f else "module"): dp_f32_check(group, group.device, f, 16) for f in (False, True)}}
    # three bf16 steps at global B=64, the state compared across the ranks after each
    batch = shard_batch(dp_batch(64, 3), group)
    for fused in (False, True):
        st = dp_state("bfloat16", group.device, group)
        step = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused, group=group)
        torch.cuda.synchronize()
        _reset_counts()
        losses, ms = [], []
        for i in range(3):
            t = time.perf_counter()
            st, m = step(st, batch, drop_mask=dp_mask(i))
            losses.append(float(m["loss"]))  # waits for the step
            ms.append((time.perf_counter() - t) * 1e3)
            assert_same_on_ranks(state_digest(st), group, f"the state after bf16 step {i}")
        out["fused" if fused else "module"] = {"losses": losses, "ms_per_step_host_clock": ms,
                                               "launches": _read_counts(), "bit_identical_after_each_step": True}
    # (c) a Trainer epoch on host batches: this rank's block of each global
    # batch, the whole test batch, a checkpoint (the primary writes) and a resume
    train = [dp_batch(16, 10 + i) for i in range(DP_TRAINER_STEPS)]
    local = [{k: v[host_local_slice(16)] for k, v in b.items()} for b in train]
    args = dp_args("float32", ["lr=5e-7"])
    tr = Trainer(scale_run.make_encoder(args, scale_run.FLAGSHIP, DP_SEED), args, device=group.device,
                 checkpoints=CheckpointManager(os.path.join(ckdir, "shared"), track_metric="testTop10acc"))
    torch.cuda.synchronize()
    _reset_counts()
    hist = tr.run_epoch(0, local, dp_batch(64, 99))
    torch.cuda.synchronize()
    launches = _read_counts()
    resumed = Trainer(scale_run.make_encoder(args, scale_run.FLAGSHIP, DP_SEED + 1), args, device=group.device,
                      checkpoints=CheckpointManager(os.path.join(ckdir, "shared")))
    digest = state_digest(tr.state)
    out["trainer"] = {"history": hist, "launches": launches, "steps": tr.state.step, "multihost": tr.multihost,
                      "resumed_start_epoch": resumed.start_epoch,
                      "resumed_bitwise": state_digest(resumed.state) == digest, "digest": digest.hex(),
                      "epoch_seconds": tr.last_epoch_seconds}
    assert_same_on_ranks(digest, group, "the Trainer's state")
    if group.is_primary:  # numpy: a tensor would cross the queue as a shared-memory handle
        out["trainer"]["state"] = {k: v.detach().cpu().numpy() for k, v in tr.state.encoder.state_dict().items()}
        out["trainer"]["state"]["clip.temp"] = tr.state.clip.temp.detach().cpu().numpy()
    return out


def data_parallel_phase(step_ms: dict, expect) -> dict:
    """Phase 15 in the parent: spawn the ranks (the kernels are built
    already), check what they return, run the one-process Trainer epoch
    that (c) is held against, print the lines; returns the launch counts of
    each data-parallel path (the gloo paths summed over the two ranks)."""
    import torch

    from speech_decoding_tpu_torch.parallel.multihost import spawn_ranks
    from speech_decoding_tpu_torch.training import Trainer
    from speech_decoding_tpu_torch.tools import scale_run

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    k6 = {f"conv_block_train.{st}": 5 for st in ("F1", "F2", "F3", "B1", "B2", "B3")}
    # bf16 steps: a group's BatchNorm is TorchBatchNorm's, its GLU the op
    per_step = {"module": expect(subject_matmul=2, tap_conv_dw=15, glu=GLU_STEP),
                "fused": expect(subject_matmul=2, tap_conv_dw=15, **k6)}

    def times(counts, n):
        return {k: v * n for k, v in counts.items()}

    def f32_ok(label, checks):
        for path, c in checks.items():
            bad = {k: v for k, v in c.items() if k.endswith("over_bound") and not v <= 1.0}
            if bad or not c["topk_equal"]:
                raise AssertionError(f"{label} {path}: the data-parallel step differs from one process: {c}")

    # (a) one rank over NCCL
    t = time.perf_counter()
    a = spawn_ranks(dp_rank_nccl, 1, backend="nccl", timeout=600)[0]
    f32_ok("data_parallel_nccl f32 B=8", a["f32_b8"])
    paths = {}
    for path in ("module", "fused"):
        runs = a[path]
        for name, r in runs.items():
            # the one-process module step replays its graph, captured in the
            # warm-up, so none of its timed steps launches from the host
            launched = 0 if (path, name) == ("module", "one_process") else DP_STEPS[1]
            if (r["launched_steps"] != launched or r["launches"] != times(per_step[path], launched)
                    or not np.all(np.isfinite(r["losses"]))):
                raise AssertionError(f"data_parallel_nccl {path} {name}: launches {r['launches']} in "
                                     f"{r['launched_steps']} launched steps, losses {r['losses']}")
        paths[f"dp_nccl_{path}"] = runs["group"]["launches"]
        floats = runs["group"]["gradient_floats"]
        phase9 = step_ms["train" if path == "module" else "fused_train"]
        emit(phase="data_parallel_nccl", path=path, backend="nccl", world=a["world"], device=a["device"],
             config="flagship: B=64 C=208 T=360 D1=270 D2=320 F=1024 K=32 S=27, bf16, channels-last, "
                    "precomputed collate stats, conv_impl=gemm_pdw" + (", fused_blocks" if path == "fused" else ""),
             warmup_steps=DP_STEPS[0], steps=DP_STEPS[1], gradient_floats=floats, gradient_mbytes=floats * 4 / 1e6,
             group_ms_per_step_cuda_events=runs["group"]["ms_per_step_cuda_events"],
             group_ms_per_step_host_clock=runs["group"]["ms_per_step_host_clock"],
             one_process_ms_per_step_cuda_events=runs["one_process"]["ms_per_step_cuda_events"],
             one_process_ms_per_step_host_clock=runs["one_process"]["ms_per_step_host_clock"],
             group_device_busy_ms_per_step=runs["group"]["device_busy_ms_per_step"],
             one_process_device_busy_ms_per_step=runs["one_process"]["device_busy_ms_per_step"],
             phase9_ms_per_step=phase9, launches=runs["group"]["launches"], losses=runs["group"]["losses"],
             f32_b8_vs_one_process=a["f32_b8"][path], collectives=a["collectives"],
             seconds_with_spawn=time.perf_counter() - t)

    # (b) and (c): two ranks over gloo on this card
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t = time.perf_counter()
        b = spawn_ranks(dp_rank_gloo, 2, args=(ckdir,), backend="gloo", timeout=900)
        gloo_s = time.perf_counter() - t
        for r in b:
            f32_ok(f"data_parallel_gloo rank {r['rank']} f32 B=16", r["f32_b16"])
        for path in ("module", "fused"):
            r0, r1 = b[0][path], b[1][path]
            for r in (r0, r1):
                if r["launches"] != times(per_step[path], 3):
                    raise AssertionError(f"data_parallel_gloo {path}: launches {r['launches']}")
            if r0["losses"] != r1["losses"] or not np.all(np.isfinite(r0["losses"])):
                raise AssertionError(f"data_parallel_gloo {path}: the ranks' losses {r0['losses']} {r1['losses']}")
            paths[f"dp_gloo_{path}"] = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
            emit(phase="data_parallel_gloo", path=path, backend="gloo", world=2, device=b[0]["device"],
                 config="flagship, bf16, global B=64 (32 a rank), 3 steps; f32 global B=16 (8 a rank) against one "
                        "process", losses=r0["losses"], bit_identical_after_each_step=True,
                 launches_per_rank=[r0["launches"], r1["launches"]],
                 ms_per_step_host_clock_check_only=[r0["ms_per_step_host_clock"], r1["ms_per_step_host_clock"]],
                 f32_b16_vs_one_process=[r["f32_b16"][path] for r in b])

        # (c) against one process on the same global batches, on this card
        tr = [r["trainer"] for r in b]
        want = expect(subject_matmul=2 * DP_TRAINER_STEPS + 1, tap_conv_dw=15 * DP_TRAINER_STEPS, retrieval_ranks=1)
        for r in tr:
            if r["launches"] != want or r["steps"] != DP_TRAINER_STEPS or not r["multihost"]:
                raise AssertionError(f"data_parallel_trainer: launches {r['launches']}, steps {r['steps']}")
            if r["resumed_start_epoch"] != 1 or not r["resumed_bitwise"] or r["digest"] != tr[0]["digest"]:
                raise AssertionError(f"data_parallel_trainer: the resumed state differs: {r}")
        paths["dp_gloo_trainer"] = {k: tr[0]["launches"][k] + tr[1]["launches"][k] for k in want}
        args = dp_args("float32", ["lr=5e-7"])
        one = Trainer(scale_run.make_encoder(args, scale_run.FLAGSHIP, DP_SEED), args, device="cuda")
        want_hist = one.run_epoch(0, [dp_batch(16, 10 + i) for i in range(DP_TRAINER_STEPS)], dp_batch(64, 99))
        got = tr[0]["history"]
        keys = ("train_loss", "test_loss", "temp", "trainTop1acc", "trainTop10acc", "testTop1acc", "testTop10acc")
        if any(tr[1]["history"][k] != got[k] for k in keys):
            raise AssertionError(f"data_parallel_trainer: the ranks' histories differ: {tr[0]['history']} "
                                 f"{tr[1]['history']}")
        # f32 on the card, sums in another order: losses at rtol 1e-4, the
        # temperature 1e-5; a near-tie may move one segment in a top-k
        # (1/(16·12) of the train mean, 1/64 of the test's)
        diffs = {k: abs(got[k] - want_hist[k]) for k in keys}
        bounds = {"train_loss": 1e-4 * abs(want_hist["train_loss"]), "test_loss": 1e-4 * abs(want_hist["test_loss"]),
                  "temp": 1e-5 * abs(want_hist["temp"]), "trainTop1acc": 1 / (16 * DP_TRAINER_STEPS) + 1e-7,
                  "trainTop10acc": 1 / (16 * DP_TRAINER_STEPS) + 1e-7, "testTop1acc": 1 / 64 + 1e-7,
                  "testTop10acc": 1 / 64 + 1e-7}
        if any(diffs[k] > bounds[k] for k in keys):
            raise AssertionError(f"data_parallel_trainer: {got} against one process {want_hist}")
        # the state: each tensor at 1e-4 of its largest entry + 2·lr a step
        # (Adam's ±lr on entries whose gradient is rounding noise)
        ref = {k: v.detach().cpu() for k, v in one.state.encoder.state_dict().items()}
        ref["clip.temp"] = one.state.clip.temp.detach().cpu()
        worst = max(float((torch.from_numpy(tr[0]["state"][k]) - w).abs().max())
                    / (1e-4 * float(w.abs().max()) + 2 * 5e-7 * DP_TRAINER_STEPS + 1e-6) for k, w in ref.items())
        if not worst <= 1.0:
            raise AssertionError(f"data_parallel_trainer: the state differs from one process ({worst:.3g}x the bound)")
        emit(phase="data_parallel_trainer", backend="gloo", world=2, device=b[0]["device"],
             config="flagship, f32, lr 5e-7, 12 steps of global B=16 (8 a rank) on host batches, eval of 64, "
                    "checkpoint (the primary writes) and resume", history=got, one_process_history=want_hist,
             diffs=diffs, state_err_over_bound=worst, resumed_bitwise=True, ranks_bit_identical=True,
             launches_per_rank=[r["launches"] for r in tr], epoch_seconds_check_only=tr[0]["epoch_seconds"],
             gloo_spawn_seconds=gloo_s)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return paths


# -- 16-18. the memory-scaling paths: remat, the row-sharded bank, sharded preprocessing ---------
# Each runs in spawned ranks, as phase 15 does: one over NCCL at world size 1
# (which also takes the one-process references and the timings, in a process
# no profiler trace has slowed yet) and two over gloo, both on cuda:0

MS_REMAT_BATCHES = {64: 5, 256: 3}  # batch -> timed steps (after 2 warm-up steps)
MS_BANK_ROWS, MS_BANK_CHUNK = 8192, 512  # 8,192 flagship candidates: 12.1 GB f32, 3.0 GB int8
MS_GLOO_BANK_ROWS = 512  # the two gloo ranks check the merge, not capacity
MS_RECORDING = (208, 396_000)  # one Gwilliams recording at 1000 Hz [ref: gwilliams2022.py:249]
MS_SFREQ, MS_BAND, MS_RATE = 1000.0, (1.0, 60.0), 120.0  # configs/config.yaml:47-49


def ms_remat_overrides(impl: str, remat: bool):
    return [f"tpu.conv_impl={impl}", f"tpu.remat={str(remat).lower()}"]


def ms_remat_vs_plain(device, group=None, n: int = 8) -> dict:
    """One f32 step with remat against the same step without it (the group
    step on the rank's block under a group), from the same weights, batch
    and mask, on phase 8's bounds: loss rtol 1e-4, temperature 1e-6, each
    gradient 1e-3 of its largest entry + 1e-4 of the model's largest, BN
    statistics atol 1e-5 + rtol 1e-4; with the collectives each step made."""
    import torch

    from speech_decoding_tpu_torch.parallel import shard_batch
    from speech_decoding_tpu_torch.parallel.collectives import calls
    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    host = dp_batch(n, 1)
    runs = {}
    for remat in (False, True):
        st = dp_state("float32", device, group, overrides=ms_remat_overrides("gemm_pdw", remat))
        before = dict(calls)
        st, m = make_train_step(collate=FLAGSHIP_COLLATE, group=group)(
            st, put_batch(host, device) if group is None else shard_batch(host, group), drop_mask=dp_mask(0))
        torch.cuda.synchronize()
        grads = {n_: p.grad for n_, p in st.encoder.named_parameters()}
        grads["clip.temp"] = st.clip.temp.grad
        runs[remat] = (m, grads, {n_: b for n_, b in st.encoder.named_buffers() if n_.endswith(("mean", "var"))},
                       {k: v - before.get(k, 0) for k, v in calls.items() if v - before.get(k, 0)})
    (m0, g0, b0, c0), (m1, g1, b1, c1) = runs[False], runs[True]
    gmax = max(float(w.abs().max()) for w in g0.values())
    grad = max(float((g1[k] - w).abs().max()) / (1e-3 * float(w.abs().max()) + 1e-4 * gmax) for k, w in g0.items())
    stats = max(float(((b1[k] - w).abs() / (1e-5 + 1e-4 * w.abs())).max()) for k, w in b0.items())
    bitwise = all(torch.equal(g1[k], w) for k, w in g0.items()) and all(torch.equal(b1[k], w) for k, w in b0.items())
    return {"loss_err_over_bound": abs(float(m1["loss"]) - float(m0["loss"])) / (1e-4 * abs(float(m0["loss"]))),
            "temp_err_over_bound": abs(float(m1["temp"]) - float(m0["temp"])) / (1e-6 * abs(float(m0["temp"]))),
            "gradient_err_over_bound": grad, "bn_stats_err_over_bound": stats, "bitwise_equal": bitwise,
            "collectives_plain": c0, "collectives_remat": c1, "batch": n}


def ms_step_kernel_checks(step, state, batch, first_step: int):
    """One more step in which every launch of K1, K2 and K5 is held against
    its plain version on the very inputs the step gave it (activations,
    cotangents, weights, ids), on phase 3's bf16 tolerances: |got - want| ≤
    atol + rtol·|want| with atol a share of the plain output's largest
    entry: K1 and its dX 1e-2 and rtol 1e-2, K2 1e-4 and 1e-4, K5 and its dx
    1e-2 and 1e-2. Returns the new state and, by kernel and form, the
    launches checked, the output shapes, K1's bodies and the worst
    max(|got - want| - rtol·|want|) / atol."""
    import torch

    from speech_decoding_tpu_torch.ops import subject_conv as sc
    from speech_decoding_tpu_torch.ops import tap_conv as tc

    checks = {}

    def check(form, got, want, rel, body=None):
        g, w = got.float(), want.float()
        atol = rel * float(w.abs().max()) or rel
        worst = float(((g - w).abs() - rel * w.abs()).max()) / atol
        if not bool(torch.isfinite(g).all()):
            worst = float("inf")
        c = checks.setdefault(form, {"launches": 0, "err_over_bound": 0.0, "shapes": set()})
        c["launches"] += 1
        c["err_over_bound"] = max(c["err_over_bound"], worst)
        c["shapes"].add(tuple(got.shape))
        if body is not None:
            c.setdefault("bodies", set()).add(body)
        return got

    k1, k2, k5 = sc._launch, tc._launch, tc._launch_conv

    def k1_checked(x, w, sidx, transposed, host_ids=0):
        y = k1(x, w, sidx, transposed, host_ids)  # fills sidx from the host ids first
        return check("K1 dX" if transposed else "K1", y,
                     sc.subject_matmul_plain(x, w.transpose(1, 2) if transposed else w, sidx), 1e-2,
                     sc.subject_matmul.route)

    def k2_checked(x, g, d, padded=None):
        return check("K2", k2(x, g, d, padded), tc.tap_conv_dw_plain(x, g, d), 1e-4)

    def k5_checked(x, w, d, transposed):
        return check("K5 dx" if transposed else "K5", k5(x, w, d, transposed),
                     tc.tap_conv_plain(x, tc.flip_taps(w) if transposed else w, d), 1e-2)

    sc._launch, tc._launch, tc._launch_conv = k1_checked, k2_checked, k5_checked
    try:
        state, _ = step(state, batch, drop_mask=dp_mask(first_step))
        torch.cuda.synchronize()
    finally:
        sc._launch, tc._launch, tc._launch_conv = k1, k2, k5
    return state, {k: {**v, "shapes": sorted(map(list, v["shapes"])), **({"bodies": sorted(v["bodies"])} if "bodies" in v else {})}
                   for k, v in checks.items()}


def ms_remat_timings(device) -> dict:
    """The flagship step (bf16, one process, eager) with and without remat,
    on the module convs and on pallas_taps, at B=64 and B=256: ms a step by CUDA
    events and host clock, launches (counters set to 0 just before the timed
    steps and read just after), the memory resident before the steps and the
    peak during them. At the largest batch, one more remat step on each
    conv_impl holds every K1, K2 and K5 launch against its plain version
    (``ms_step_kernel_checks``)."""
    import torch

    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    def eager_step(state, batch, **kw):
        # a fresh step a call runs every call eagerly (its signature's first):
        # remat takes no CUDA graph, so the plain step it is held against
        # takes none either (the graph's activations, in its own pool, would
        # leave the plain peak)
        return make_train_step(collate=FLAGSHIP_COLLATE)(state, batch, **kw)

    out, kept = {}, {}
    for b, n in MS_REMAT_BATCHES.items():
        batch = put_batch(dp_batch(b, 20 + b), device)
        for impl in ("gemm_pdw", "pallas_taps"):
            for remat in (False, True):
                st = dp_state("bfloat16", device, overrides=ms_remat_overrides(impl, remat))
                step = make_train_step(collate=FLAGSHIP_COLLATE) if remat else eager_step
                for i in range(2):
                    st, _ = step(st, batch, drop_mask=dp_mask(i))
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                r = dp_timed_steps(st, step, batch, n, 2)
                r.update(steps=n, resident_gb=resident / 1e9, peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
                if remat and b == max(MS_REMAT_BATCHES):
                    st, r["kernel_checks"] = ms_step_kernel_checks(step, st, batch, 2 + n)
                key = f"{impl} B={b}" + (" remat" if remat else "")
                out[key], kept[key] = r, (step, st, batch)
    return out, kept


def ms_bank_host(device, rows: int) -> np.ndarray:
    """The (rows, F, T) f32 bank on the host, the same bytes in every process:
    drawn on ``device`` from DP_SEED a chunk of rows at a time, so no
    process holds it whole on the card."""
    import torch

    from speech_decoding_tpu_torch.tools import scale_run

    d = scale_run.FLAGSHIP
    bank = np.empty((rows, d["F"], d["T"]), np.float32)
    g = torch.Generator(device=device).manual_seed(DP_SEED)
    for i in range(0, rows, MS_BANK_CHUNK):
        n = min(MS_BANK_CHUNK, rows - i)
        torch.from_numpy(bank[i : i + n]).copy_(torch.randn(n, d["F"], d["T"], generator=g, device=device))
    return bank


def ms_decoder(device):
    from speech_decoding_tpu_torch.inference import SpeechDecoder
    from speech_decoding_tpu_torch.tools import scale_run

    return SpeechDecoder(scale_run.make_encoder(dp_args("bfloat16"), scale_run.FLAGSHIP, DP_SEED), device=device)


def ms_int8_sim_check(zq, bank_q) -> dict:
    """The int8 decode's similarity (bf16 upcasts of a chunk of bank rows at
    a time, f32 accumulation) against the same integer products summed in
    f32 from f32 copies, on up to 1,024 of the rank's rows (several
    chunks): |got - want| ≤ 1e-5 · Σ|terms| elementwise, the order of the
    f32 sums over D = 368,640."""
    from speech_decoding_tpu_torch.inference import _int8_sim

    rows = bank_q[:1024]
    got = _int8_sim(zq, rows)
    want = zq.float() @ rows.float().T
    terms = zq.float().abs() @ rows.float().abs().T
    return {"rows": int(rows.shape[0]), "max_abs_err": float((got - want).abs().max()),
            "err_over_bound": float(((got - want).abs() / (1e-5 * terms).clamp_min(1e-30)).max())}


def ms_bank(group, bank: np.ndarray) -> dict:
    """A B=64 decode (k=10) against the bank, f32 then int8: on the whole
    bank in one process first (the reference), then with the rows sharded
    over ``group``; launches of the group decodes (counters set to 0 just
    before and read just after), the rank's resident bank bytes, its peak
    memory above what was allocated before ``set_bank`` (during
    ``set_bank``, and through the decodes too) and the group decode's ms on
    the host clock."""
    import torch

    dec = ms_decoder(group.device)
    q = dp_batch(64, 30)
    X, sidx = q["X"], q["subject_idxs"]
    out = {"one_process": {}, "group": {}, "launches": None}
    for dtype in ("float32", "int8"):
        dec.set_bank(bank, dtype)
        out["one_process"][dtype] = dec.decode(X, sidx, k=10)
    answers = {}
    for dtype in ("float32", "int8"):
        dec._bank_norm = dec._bank_q = dec._bank_scale = None  # the last bank: the peaks below are this one's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(group.device)
        torch.cuda.reset_peak_memory_stats(group.device)
        t = time.perf_counter()
        dec.set_bank(bank, dtype, group=group)
        torch.cuda.synchronize()
        set_s = time.perf_counter() - t
        set_peak = torch.cuda.max_memory_allocated(group.device) - base
        held = [dec._bank_norm] if dtype == "float32" else [dec._bank_q, dec._bank_scale]
        rows, resident = int(held[0].shape[0]), sum(h.numel() * h.element_size() for h in held)
        del held
        dec.decode(X, sidx, k=10)  # warm-up
        _reset_counts()
        answers[dtype] = dec.decode(X, sidx, k=10)
        launches = _read_counts()
        out["launches"] = launches if out["launches"] is None else {k: v + launches[k] for k, v in out["launches"].items()}
        ms = []
        for _ in range(10):
            t = time.perf_counter()
            dec.decode(X, sidx, k=10)  # returns host arrays: waits for the card
            ms.append((time.perf_counter() - t) * 1e3)
        out["group"][dtype] = {"scores": answers[dtype][0], "ids": answers[dtype][1],
                               "rows": rows, "bank_size": dec.bank_size, "resident_bank_gb": resident / 1e9,
                               "set_bank_peak_gb": set_peak / 1e9,
                               "peak_gb": (torch.cuda.max_memory_allocated(group.device) - base) / 1e9,
                               "set_bank_s": set_s, "decode_ms_host_clock": ms}
    # after the counted decode and the peaks: the encode is the decode's own
    z = dec.encode(X, sidx).float().reshape(len(X), -1)
    z = z / z.norm(dim=-1, keepdim=True)
    out["int8_sim"] = ms_int8_sim_check(torch.round(z / (z.abs().amax(-1, keepdim=True) / 127)).to(torch.int8),
                                        dec._bank_q)
    return out


def ms_preproc(group) -> dict:
    """One recording (208, 396,000) f32 at 1000 Hz, drawn on the card from
    DP_SEED: the time-sharded band-pass (1-60 Hz) of the rank's time block
    and the channel-sharded resample and band-pass + resample chain (to 120
    Hz) of its channel block, each against the one-process function on the
    card at JAX's tolerances (band-pass and chain rtol 2e-4, atol 2e-5;
    resample rtol 1e-5, atol 1e-6), with ms by CUDA events (5 calls after a
    warm-up) and the launches of the sharded calls (none expected)."""
    import torch

    from speech_decoding_tpu_torch.ops.fir import bandpass_filter
    from speech_decoding_tpu_torch.ops.resample import fft_resample
    from speech_decoding_tpu_torch.parallel.preproc_sharded import (
        bandpass_filter_sharded, bandpass_resample_sharded, fft_resample_sharded,
    )

    C_, T_ = MS_RECORDING
    g = torch.Generator(device=group.device).manual_seed(DP_SEED)
    x = torch.randn(C_, T_, generator=g, device=group.device)
    tb, cb = group.block(T_), group.block(C_)
    lo, hi = MS_BAND
    calls_ = {
        "bandpass": (lambda: bandpass_filter_sharded(x[:, tb], MS_SFREQ, lo, hi, group),
                     lambda: bandpass_filter(x, MS_SFREQ, lo, hi)[:, tb], 2e-4, 2e-5),
        "resample": (lambda: fft_resample_sharded(x[cb], MS_RATE, MS_SFREQ, group),
                     lambda: fft_resample(x, up=MS_RATE, down=MS_SFREQ)[cb], 1e-5, 1e-6),
        "chain": (lambda: bandpass_resample_sharded(x[cb], MS_SFREQ, lo, hi, MS_RATE, group),
                  lambda: fft_resample(bandpass_filter(x, MS_SFREQ, lo, hi), up=MS_RATE, down=MS_SFREQ)[cb],
                  2e-4, 2e-5),
    }
    out = {"recording": list(MS_RECORDING), "recording_s": T_ / MS_SFREQ}
    for name, (sharded, one, rtol, atol) in calls_.items():
        torch.cuda.synchronize()
        _reset_counts()
        got = sharded()
        torch.cuda.synchronize()
        launches = _read_counts()
        want = one()
        err = (got - want).abs()
        out[name] = {"shape": list(got.shape), "max_abs_err": float(err.max()),
                     "err_over_bound": float((err / (atol + rtol * want.abs())).max()), "rtol": rtol, "atol": atol,
                     "finite": bool(torch.isfinite(got).all()), "launches": launches,
                     "ms_cuda_events": time_ms(sharded, reps=5, warmup=1),
                     "one_process_ms_cuda_events": time_ms(one, reps=5, warmup=1)}
    return out


def ms_rank_nccl() -> dict:
    """Phases 16-18 on one rank over NCCL (world size 1): the remat timings
    and checks, the group step with remat, the bank and the recording."""
    import torch

    from speech_decoding_tpu_torch.parallel import data_group
    from speech_decoding_tpu_torch.parallel.collectives import calls
    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = data_group()
    out = {"world": group.world, "device": str(group.device)}
    t = time.perf_counter()
    out["remat"], kept = ms_remat_timings(group.device)
    out["remat_f32_b8"] = ms_remat_vs_plain(group.device)
    out["remat_f32_b8_group"] = ms_remat_vs_plain(group.device, group)
    # the bf16 group step with and without remat: ms, launches, collectives a step
    batch = put_batch(dp_batch(64, 2), group.device)
    out["group"] = {}
    for remat in (False, True):
        st = dp_state("bfloat16", group.device, group, overrides=ms_remat_overrides("gemm_pdw", remat))
        step = make_train_step(collate=FLAGSHIP_COLLATE, group=group)
        for i in range(2):
            st, _ = step(st, batch, drop_mask=dp_mask(i))
        before = dict(calls)
        r = dp_timed_steps(st, step, batch, 5, 2)
        r["collectives_per_step"] = {k: (v - before.get(k, 0)) / 5 for k, v in calls.items() if v - before.get(k, 0)}
        out["group"]["remat" if remat else "plain"] = r
    t_remat = time.perf_counter()
    bank = ms_bank_host(group.device, MS_BANK_ROWS)
    out["bank"] = ms_bank(group, bank)
    del bank
    torch.cuda.empty_cache()
    t_bank = time.perf_counter()
    out["preproc"] = ms_preproc(group)
    t_preproc = time.perf_counter()
    # device times last: a profiler trace slows every later launch on the host
    # (one step at B=256: its trace alone holds as many kernels as three at B=64)
    for key, (step, st, b) in kept.items():
        out["remat"][key]["device_busy_ms_per_step"] = dp_device_busy_ms(step, st, b, 3 if "B=64" in key else 1)
    out["seconds"] = {"remat": t_remat - t, "bank": t_bank - t_remat, "preproc": t_preproc - t_bank,
                      "profiles": time.perf_counter() - t_preproc}
    return out


def ms_rank_gloo() -> dict:
    """Phases 16-18 on one of two gloo ranks, both on cuda:0: the f32 remat
    group step against the plain group step, the rank's block of a
    512-candidate bank, and its blocks of the recording."""
    import torch

    from speech_decoding_tpu_torch.parallel import data_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = data_group("cuda:0")
    t = time.perf_counter()
    out = {"rank": group.rank, "world": group.world, "device": str(group.device),
           "remat_f32_b16_group": ms_remat_vs_plain(group.device, group, 16)}
    t_remat = time.perf_counter()
    out["bank"] = ms_bank(group, ms_bank_host(group.device, MS_GLOO_BANK_ROWS))
    t_bank = time.perf_counter()
    out["preproc"] = ms_preproc(group)
    out["seconds"] = {"remat": t_remat - t, "bank": t_bank - t_remat, "preproc": time.perf_counter() - t_bank}
    return out


def ms_ids_agree(ids, ref_ids, ref_scores, band: float) -> int:
    """Raise unless ``ids`` equal ``ref_ids`` wherever the reference's score
    is more than ``band`` from its neighbours' (a near-tie may swap two
    candidates); returns the positions that differ."""
    differ = ids != ref_ids
    gap = np.full(ref_scores.shape, np.inf, np.float32)
    step = np.abs(np.diff(ref_scores, axis=1))
    gap[:, 1:], gap[:, :-1] = step, np.minimum(gap[:, :-1], step)
    if np.any(differ & (gap > band)):
        raise AssertionError(f"ids differ from the one-process decoder outside a near-tie: {np.argwhere(differ)[:5]}")
    return int(differ.sum())


def memory_scaling_phase(expect) -> dict:
    """Phases 16-18 in the parent: spawn the ranks, check what they return
    and print the lines; returns the launch counts of each path (the gloo
    paths summed over the two ranks)."""
    import torch

    from speech_decoding_tpu_torch.parallel.multihost import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # one process (BN's kernels), and plain or remat
    per_step = {"gemm_pdw": (expect(subject_matmul=2, tap_conv_dw=15, batchnorm_gelu=BN_STEP, glu=GLU_STEP),
                             expect(subject_matmul=2, tap_conv_dw=15, batchnorm_gelu=BN_REMAT_STEP,
                                    glu=GLU_REMAT_STEP)),
                "pallas_taps": (expect(subject_matmul=2, tap_conv_dw=15, tap_conv=30, batchnorm_gelu=BN_STEP,
                                       glu=GLU_STEP),
                                expect(subject_matmul=2, tap_conv_dw=15, tap_conv=45, batchnorm_gelu=BN_REMAT_STEP,
                                       glu=GLU_REMAT_STEP))}
    # a group's BatchNorm is TorchBatchNorm's, its GLU the op; plain and remat
    group_step = {"plain": expect(subject_matmul=2, tap_conv_dw=15, glu=GLU_STEP),
                  "remat": expect(subject_matmul=2, tap_conv_dw=15, glu=GLU_REMAT_STEP)}
    decodes = expect(subject_matmul=2, conv_block_fused=10)  # one checked B=64 decode a store dtype
    paths = {}

    def times(counts, n):
        return {k: v * n for k, v in counts.items()}

    def remat_ok(label, c):
        bad = {k: v for k, v in c.items() if k.endswith("over_bound") and not v <= 1.0}
        if bad or c["collectives_plain"] != c["collectives_remat"]:
            raise AssertionError(f"{label}: the remat step differs from the plain step: {c}")
        emit(check=label, **c, bounds="phase 8's: loss rtol 1e-4, temperature 1e-6, gradients 1e-3 of the tensor's "
                                      "largest + 1e-4 of the model's, BN statistics atol 1e-5 + rtol 1e-4")

    t = time.perf_counter()
    a = spawn_ranks(ms_rank_nccl, 1, backend="nccl", timeout=900)[0]
    nccl_s = time.perf_counter() - t
    t = time.perf_counter()
    b = spawn_ranks(ms_rank_gloo, 2, backend="gloo", timeout=900)
    gloo_s = time.perf_counter() - t
    emit(timing="phases 16-18: seconds a spawn and a part", nccl_spawn_s=nccl_s, nccl_rank_parts_s=a["seconds"],
         gloo_spawn_s=gloo_s, gloo_rank_parts_s=[r["seconds"] for r in b])

    # -- 16. remat -------------------------------------------------------------------------------
    for key, r in a["remat"].items():
        impl, bs = key.split()[:2]
        remat = key.endswith("remat")
        n = r["steps"]
        if r["launches"] != times(per_step[impl][remat], n) or not np.all(np.isfinite(r["losses"])):
            raise AssertionError(f"remat {key}: launches {r['launches']}, losses {r['losses']}")
        name = ("remat_" if remat else "") + ("taps_" if impl == "pallas_taps" else "") + f"train_b{bs[2:]}"
        paths[name] = r["launches"]
        emit(phase="remat", path=name, config="flagship: C=208 T=360 D1=270 D2=320 F=1024 K=32 S=27, bf16, "
             f"channels-last, precomputed collate stats, conv_impl={impl}, {bs}, tpu.remat={str(remat).lower()}",
             steps=n, ms_per_step_cuda_events=r["ms_per_step_cuda_events"],
             ms_per_step_host_clock=r["ms_per_step_host_clock"], device_busy_ms_per_step=r["device_busy_ms_per_step"],
             resident_gb=r["resident_gb"], peak_gb=r["peak_gb"], activation_peak_gb=r["peak_gb"] - r["resident_gb"],
             launches_per_step={k: v / n for k, v in r["launches"].items() if v}, losses=r["losses"])
    saved = {}
    for impl in ("gemm_pdw", "pallas_taps"):
        for bs in MS_REMAT_BATCHES:
            p_, r_ = a["remat"][f"{impl} B={bs}"], a["remat"][f"{impl} B={bs} remat"]
            saved[f"{impl} B={bs}"] = {"peak_saved_gb": p_["peak_gb"] - r_["peak_gb"],
                                       "ms_added_cuda_events": r_["ms_per_step_cuda_events"]
                                       - p_["ms_per_step_cuda_events"],
                                       "device_busy_ms_added": (r_["device_busy_ms_per_step"]
                                                                - p_["device_busy_ms_per_step"])
                                       if isinstance(r_["device_busy_ms_per_step"], float)
                                       and isinstance(p_["device_busy_ms_per_step"], float) else "not measured"}
    big = max(MS_REMAT_BATCHES)
    for impl, forms in (("gemm_pdw", ("K1", "K1 dX", "K2")), ("pallas_taps", ("K1", "K1 dX", "K2", "K5", "K5 dx"))):
        kc = a["remat"][f"{impl} B={big} remat"]["kernel_checks"]
        if sorted(kc) != sorted(forms) or not all(c["err_over_bound"] <= 1.0 for c in kc.values()):
            raise AssertionError(f"remat {impl} B={big}: the kernels against their plain versions: {kc}")
        emit(check=f"K1, K2 and K5 on the inputs of one remat {impl} B={big} step against their plain versions",
             by_kernel=kc, bounds="phase 3's bf16: |got - want| <= atol + rtol·|want|, atol a share of the "
                                  "plain output's largest entry: K1, K1 dX, K5, K5 dx 1e-2 and rtol 1e-2; "
                                  "K2 1e-4 and 1e-4")
    emit(timing="remat: what recomputing the five ConvBlocks saves and costs a step (plain minus remat peak; "
                "remat minus plain time)", by_config=saved)
    if not all(v["peak_saved_gb"] > 0 for v in saved.values()):
        raise AssertionError(f"remat did not lower the step's peak memory: {saved}")
    remat_ok("remat f32 B=8 step vs the plain step, one process", a["remat_f32_b8"])
    remat_ok("remat f32 B=8 group step vs the plain group step, NCCL world 1", a["remat_f32_b8_group"])
    for r in b:
        remat_ok(f"remat f32 global B=16 group step vs the plain group step, gloo rank {r['rank']} of 2",
                 r["remat_f32_b16_group"])
    g = a["group"]
    for name, r in g.items():
        if r["launches"] != times(group_step[name], 5):
            raise AssertionError(f"remat NCCL group step ({name}): launches {r['launches']}")
    if g["plain"]["collectives_per_step"] != g["remat"]["collectives_per_step"]:
        raise AssertionError(f"the remat group step's collectives differ: {g}")
    paths["dp_nccl_remat"] = g["remat"]["launches"]
    emit(phase="remat_dp_nccl", backend="nccl", world=a["world"], config="flagship bf16 B=64, conv_impl=gemm_pdw",
         steps=5, remat_ms_per_step_cuda_events=g["remat"]["ms_per_step_cuda_events"],
         plain_ms_per_step_cuda_events=g["plain"]["ms_per_step_cuda_events"],
         remat_ms_per_step_host_clock=g["remat"]["ms_per_step_host_clock"],
         plain_ms_per_step_host_clock=g["plain"]["ms_per_step_host_clock"],
         collectives_per_step_remat=g["remat"]["collectives_per_step"],
         collectives_per_step_plain=g["plain"]["collectives_per_step"], launches=g["remat"]["launches"])

    # -- 17. the row-sharded bank ------------------------------------------------------------------
    for label, ranks, n_bank in (("sharded_bank_nccl", [a], MS_BANK_ROWS),
                                 ("sharded_bank_gloo", b, MS_GLOO_BANK_ROWS)):
        w = len(ranks)
        for r in ranks:
            if r["bank"]["launches"] != decodes:
                raise AssertionError(f"{label}: launches {r['bank']['launches']}, expected {decodes}")
            if not r["bank"]["int8_sim"]["err_over_bound"] <= 1.0:
                raise AssertionError(f"{label}: the int8 similarity against f32 sums: {r['bank']['int8_sim']}")
        lines = {}
        for dtype, atol in (("float32", 1e-5), ("int8", 1e-6)):
            got = [r["bank"]["group"][dtype] for r in ranks]
            for x in got[1:]:
                if not (np.array_equal(x["ids"], got[0]["ids"]) and np.array_equal(x["scores"], got[0]["scores"])):
                    raise AssertionError(f"{label} {dtype}: the ranks' answers differ")
            for x in got:
                if x["rows"] != n_bank // w or x["bank_size"] != n_bank:
                    raise AssertionError(f"{label} {dtype}: a rank holds {x['rows']} of {x['bank_size']} rows")
            ref_scores, ref_ids = ranks[0]["bank"]["one_process"][dtype]
            score_err = float(np.abs(got[0]["scores"] - ref_scores).max())
            if not score_err <= atol:
                raise AssertionError(f"{label} {dtype}: scores {score_err} from the one-process decoder's")
            swapped = ms_ids_agree(got[0]["ids"], ref_ids, ref_scores, atol)
            lines[dtype] = {"max_abs_score_err": score_err, "atol": atol, "near_tie_positions_swapped": swapped,
                            "rows_per_rank": got[0]["rows"],
                            "resident_bank_gb_per_rank": [x["resident_bank_gb"] for x in got],
                            "set_bank_peak_gb_per_rank": [x["set_bank_peak_gb"] for x in got],
                            "peak_gb_per_rank": [x["peak_gb"] for x in got],
                            "set_bank_s_per_rank": [x["set_bank_s"] for x in got],
                            "decode_ms_host_clock": [x["decode_ms_host_clock"] for x in got]}
        paths[label] = {k: sum(r["bank"]["launches"][k] for r in ranks) for k in decodes}
        emit(phase=label, backend="nccl" if w == 1 else "gloo", world=w, device=ranks[0]["device"],
             config=f"flagship encoder (bf16, fused serving path); bank N={n_bank} x F·T=368,640 "
                    f"({n_bank * 368_640 * 4 / 1e9:.2f} GB f32, {n_bank * 368_640 / 1e9:.2f} GB int8) on the "
                    f"host, row blocks of {n_bank // w}; B=64, k=10; against one process on the same bank",
             by_store_dtype=lines, launches_per_rank=[r["bank"]["launches"] for r in ranks],
             int8_similarity_vs_f32_sums=[r["bank"]["int8_sim"] for r in ranks],
             seconds_with_spawn=nccl_s if w == 1 else gloo_s,
             note="" if w == 1 else "gloo stages its collectives through the host: the decode ms is a check, "
                                    "not a rate")

    # -- 18. sharded preprocessing ---------------------------------------------------------------------
    for label, ranks in (("sharded_preproc_nccl", [a]), ("sharded_preproc_gloo", b)):
        launches = dict.fromkeys(expect(), 0)
        for r in ranks:
            pp = r["preproc"]
            for name in ("bandpass", "resample", "chain"):
                c = pp[name]
                if not (c["finite"] and c["err_over_bound"] <= 1.0) or c["launches"] != expect():
                    raise AssertionError(f"{label} rank {r.get('rank', 0)} {name}: {c}")
                for k, v in c["launches"].items():
                    launches[k] += v
        paths[label] = launches
        rec_s = ranks[0]["preproc"]["recording_s"]
        emit(phase=label, backend="nccl" if len(ranks) == 1 else "gloo", world=len(ranks),
             halo="one all-gather of every rank's two edges", config=f"one recording {MS_RECORDING} f32 at {MS_SFREQ:g} Hz, band "
             f"{MS_BAND[0]:g}-{MS_BAND[1]:g} Hz, resampled to {MS_RATE:g} Hz; band-pass time-sharded, resample "
             "and chain channel-sharded", recording_mb=MS_RECORDING[0] * MS_RECORDING[1] * 4 / 1e6,
             by_rank=[{name: {k: r["preproc"][name][k] for k in ("shape", "max_abs_err", "err_over_bound",
                                                                 "ms_cuda_events", "one_process_ms_cuda_events")}
                       for name in ("bandpass", "resample", "chain")} for r in ranks],
             meg_s_per_s=({name: rec_s / (ranks[0]["preproc"][name]["ms_cuda_events"] / 1e3)
                           for name in ("bandpass", "chain")} if len(ranks) == 1 else "a check, not a rate"),
             one_process_meg_s_per_s={name: rec_s / (ranks[0]["preproc"][name]["one_process_ms_cuda_events"] / 1e3)
                                      for name in ("bandpass", "chain")},
             launches=launches)
    return paths


# -- 19. the "model" axis: a data × model grid (parallel.make_grid) ---------------------------------
# NCCL refuses two ranks on one card, so the grids run over gloo ranks that
# share cuda:0 (gloo stages each collective through the host: a check of the
# arithmetic, not a rate), and NCCL runs a 1×1 grid at world size 1

MA_MIN_DIM = 64  # param_shardings' default: at the flagship 21 of the train state's 60 leaves split


def ma_state(dtype: str, grid, overrides=()):
    """DP_SEED's flagship train state on the grid: the encoder partitioned
    over ``grid.model`` (``partition_encoder``), then the optimizer."""
    from speech_decoding_tpu_torch.parallel import partition_encoder
    from speech_decoding_tpu_torch.tools import scale_run
    from speech_decoding_tpu_torch.training import create_train_state

    enc = scale_run.make_encoder(dp_args(dtype, overrides), scale_run.FLAGSHIP, DP_SEED)
    partition_encoder(enc, grid, MA_MIN_DIM)
    return create_train_state(enc, lr=3e-4, device=grid.data.device, group=grid)


def ma_f32_check(grid, path: str, n: int = 16) -> dict:
    """One f32 step of global batch n on the grid against the one-process
    step on the whole batch, on this card from the same weights, batch and
    mask: the gradients summed over the data axis and gathered over the
    model axis, on phase 8's bounds (``f32_step_errors``); the grid step's
    launches (counters set to 0 just before it and read just after) and
    collectives by axis and kind. ``path``: module, fused or pallas_taps."""
    import torch

    from speech_decoding_tpu_torch.parallel import gather_split, shard_batch
    from speech_decoding_tpu_torch.parallel.collectives import calls
    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    fused = path == "fused"
    overrides = ["tpu.conv_impl=pallas_taps"] if path == "pallas_taps" else []
    host, mask = dp_batch(n, 1), dp_mask(0)
    ref = dp_state("float32", grid.data.device, overrides=overrides)
    ref, m_ref = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused)(
        ref, put_batch(host, ref.device), drop_mask=mask)
    st = ma_state("float32", grid, overrides)
    step = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused, group=grid)
    batch = shard_batch(host, grid.data)
    torch.cuda.synchronize()
    _reset_counts()
    before = dict(calls)
    st, m = step(st, batch, drop_mask=mask)
    torch.cuda.synchronize()
    launches = _read_counts()
    made = {k: v - before.get(k, 0) for k, v in calls.items() if v - before.get(k, 0)}
    grads = gather_split(st.encoder, {name: p.grad for name, p in st.encoder.named_parameters()})
    return {**f32_step_errors(st, m, grads, ref, m_ref), "launches": launches, "collectives": made}


def ma_collective_profile(step, state, batch, first_step: int, log_dir: str) -> dict:
    """One bf16 grid step under ``utils.profiling.trace``, each model-axis
    collective inside an ``annotate`` range: the ranges' calls, host ms and
    device-timeline span against the step's host ms and device busy ms, and
    the trace files written."""
    import torch
    from torch.autograd import DeviceType

    from speech_decoding_tpu_torch.parallel import collectives as col
    from speech_decoding_tpu_torch.utils import profiling

    all_reduce, all_gather = col.all_reduce_, col._all_gather

    def annotated(fn, kind):
        def wrapper(t, group, *args, **kwargs):
            if group.axis != "model":
                return fn(t, group, *args, **kwargs)
            with profiling.annotate(f"model.{kind}"):
                return fn(t, group, *args, **kwargs)
        return wrapper

    col.all_reduce_, col._all_gather = annotated(all_reduce, "all_reduce"), annotated(all_gather, "all_gather")
    try:
        with profiling.trace(log_dir) as prof:
            t = time.perf_counter()
            state, _ = step(state, batch, drop_mask=dp_mask(first_step))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t) * 1e3
    finally:
        col.all_reduce_, col._all_gather = all_reduce, all_gather
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    # each range twice: on the host (its calls and time) and on the device
    # timeline (the span from its first to its last kernel or copy)
    ranges = {}
    for e in prof.events():
        if e.name in ("model.all_reduce", "model.all_gather"):
            r = ranges.setdefault(e.name, {"calls": 0, "host_ms": 0.0, "device_span_ms": 0.0})
            if e.device_type == DeviceType.CUDA:
                r["device_span_ms"] += e.time_range.elapsed_us() / 1e3
            else:
                r["calls"] += 1
                r["host_ms"] += e.time_range.elapsed_us() / 1e3
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    return state, {"ranges": ranges, "step_host_ms": step_ms,
                   "step_device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
                   "trace_files": len(files), "trace_mb": sum(os.path.getsize(f) for f in files) / 1e6}


def ma_rank_gloo_1x2(log_dir: str) -> dict:
    """(a), (c) and (d): one of two gloo ranks on cuda:0 as a 1×2 grid."""
    import torch

    from speech_decoding_tpu_torch.ops import subject_conv as sc
    from speech_decoding_tpu_torch.parallel import make_grid, shard_batch
    from speech_decoding_tpu_torch.parallel.collectives import calls
    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = make_grid({"data": 1, "model": 2}, "cuda:0")
    t = time.perf_counter()
    out = {"rank": grid.model.rank, "device": str(grid.data.device),
           "f32_b16": {path: ma_f32_check(grid, path) for path in ("module", "fused", "pallas_taps")}}
    t_f32 = time.perf_counter()
    # (a) three bf16 steps at B=64 on the grid and in one process
    host = dp_batch(64, 2)
    one = dp_state("bfloat16", grid.data.device)
    one_step = make_train_step(collate=FLAGSHIP_COLLATE)
    out["one_process_losses"] = [float(one_step(one, put_batch(host, one.device), drop_mask=dp_mask(i))[1]["loss"])
                                 for i in range(3)]
    del one
    st = ma_state("bfloat16", grid)
    step = make_train_step(collate=FLAGSHIP_COLLATE, group=grid)
    batch = shard_batch(host, grid.data)
    torch.cuda.synchronize()
    _reset_counts()
    before = dict(calls)
    losses, ms = [], []
    for i in range(3):
        t0 = time.perf_counter()
        st, m = step(st, batch, drop_mask=dp_mask(i))
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    out["bf16"] = {"losses": losses, "ms_per_step_host_clock": ms, "launches": _read_counts(),
                   "k1_last_body": sc.subject_matmul.route,
                   "collectives_per_step": {k: (v - before.get(k, 0)) / 3 for k, v in calls.items()
                                            if v - before.get(k, 0)}}
    # one more step with every K1 and K2 launch held against its plain version
    st, out["kernel_checks"] = ms_step_kernel_checks(step, st, batch, 3)
    t_bf16 = time.perf_counter()
    # (c) one more step traced, the model-axis collectives annotated
    st, out["profile"] = ma_collective_profile(step, st, batch, 4, os.path.join(log_dir, f"rank{grid.model.rank}"))
    out["seconds"] = {"f32": t_f32 - t, "bf16": t_bf16 - t_f32, "profile": time.perf_counter() - t_bf16}
    return out


def ma_rank_gloo_2x2() -> dict:
    """(b): one of four gloo ranks on cuda:0 as a 2×2 grid: the f32 check."""
    import torch

    from speech_decoding_tpu_torch.parallel import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = make_grid({"data": 2, "model": 2}, "cuda:0")
    return {"rank": (grid.data.rank, grid.model.rank), "f32_b16": ma_f32_check(grid, "module")}


def ma_rank_nccl() -> dict:
    """A 1×1 grid over NCCL at world size 1 (nothing splits at m=1: the
    grid's process groups and its step on NCCL), f32 against one process and
    three bf16 steps timed beside the one-process step; then, in this
    process no profiler has slowed yet, K1 and K2 at the column blocks a
    1×2 grid gives them beside their whole widths, by CUDA events and on the
    device."""
    import torch

    from speech_decoding_tpu_torch.parallel import make_grid
    from speech_decoding_tpu_torch.parallel.mesh import put_batch
    from speech_decoding_tpu_torch.training import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = make_grid({"data": 1, "model": 1})
    out = {"world": grid.data.world, "device": str(grid.data.device), "f32_b8": ma_f32_check(grid, "module", 8)}
    batch = put_batch(dp_batch(64, 2), grid.data.device)
    for name, st, grp in (("one_process", dp_state("bfloat16", grid.data.device), None),
                          ("grid", ma_state("bfloat16", grid), grid)):
        step = make_train_step(collate=FLAGSHIP_COLLATE, group=grp)
        for i in range(2):
            st, _ = step(st, batch, drop_mask=dp_mask(i))
        out[name] = dp_timed_steps(st, step, batch, 3, 2)
    out["block_kernels"] = ma_block_kernel_timings(grid.data.device)
    return out


def ma_block_kernel_timings(device) -> dict:
    """K1 forward and dX at the flagship B=64 with W's 270 output columns
    whole (the ``wgmma`` body) and as a 1×2 grid's 135-column block (odd
    Dout: the ``wmma`` body), and K2's 15 launches of a step at the whole
    Cout (320, 640) and at the block's (160, 320): ms by CUDA events, then
    device ms (``torch.profiler``), the bodies taken and each bound."""
    import torch

    from speech_decoding_tpu_torch.ops import subject_conv as sc
    from speech_decoding_tpu_torch.ops.conv_block import dilations
    from speech_decoding_tpu_torch.ops.tap_conv import tap_conv_dw
    from speech_decoding_tpu_torch.tools import scale_run

    peaks = peaks_for(torch.cuda.get_device_name(device))
    d = scale_run.FLAGSHIP
    B, T, S, D1, D2 = 64, d["T"], d["S"], 270, 320
    gen = torch.Generator(device=device).manual_seed(DP_SEED)
    bf = torch.bfloat16
    sidx = torch.randint(0, S, (B,), device=device, generator=gen, dtype=torch.int32)
    w = (torch.randn(S, D1, D1, device=device, generator=gen) / D1 ** 0.5).to(bf)
    x = torch.randn(B, T, D1, device=device, generator=gen).to(bf)
    fns = {}
    for label, cols in (("whole", D1), ("block", D1 // 2)):
        wb = w[..., :cols].contiguous()
        g = torch.randn(B, T, cols, device=device, generator=gen).to(bf)
        for form, args in (("K1", (x, wb, sidx, False)), ("K1 dX", (g, wb, sidx, True))):
            flops = 2 * B * T * D1 * cols
            moved = nbytes(args[0], wb) + 2 * B * T * (D1 if form == "K1 dX" else cols)
            fns[f"{form} {label} ({cols} columns)"] = (lambda a=args: sc._launch(*a), bound_ms(flops, moved, peaks, "bf16"))
    taps = flagship_convs(D1, D2, dilations)
    for label, div in (("whole", 1), ("block", 2)):
        ops = [(torch.randn(B, T, cin, device=device, generator=gen).to(bf),
                torch.randn(B, T, cout // div, device=device, generator=gen).to(bf), dd) for cin, cout, dd in taps]
        flops = sum(2 * 3 * B * T * a.shape[2] * gg.shape[2] for a, gg, _ in ops)
        moved = sum(nbytes(a, gg) + 3 * a.shape[2] * gg.shape[2] * 4 for a, gg, _ in ops)

        def k2_all(ops=ops):
            for a, gg, dd in ops:
                tap_conv_dw(a, gg, dd)
        fns[f"K2 15 launches {label} (Cout {'320/640' if div == 1 else '160/320'})"] = (k2_all, bound_ms(flops, moved, peaks, "bf16"))
    out = {}
    for name, (fn, (bnd, by)) in fns.items():
        fn()
        out[name] = {"ms": time_ms(fn), "bound_ms": bnd, "bound_by": by}
        if name.startswith("K1"):
            out[name]["body"] = sc.subject_matmul.route
    for name, (fn, _) in fns.items():  # device times last: a profiler trace slows later launches on the host
        dev = device_ms(fn)
        out[name]["device_ms"] = dev if dev is not None else "not measured"
    return out


def model_axis_phase(expect) -> dict:
    """Phase 19 in the parent: spawn the grids' ranks, check what they
    return and print the lines; returns the launch counts of each grid path
    (summed over the ranks)."""
    import torch

    from speech_decoding_tpu_torch.parallel.multihost import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    per_step = {"module": expect(subject_matmul=2, tap_conv_dw=15),
                "fused": expect(subject_matmul=2, tap_conv_dw=15, F1=5, F2=5, F3=5, B1=5, B2=5, B3=5),
                "pallas_taps": expect(subject_matmul=2, tap_conv_dw=15, tap_conv=30)}
    bf16_step = {**per_step["module"], "glu": GLU_STEP}  # the f32 checks run the plain GLU, bf16 steps the op
    model_calls = {"module": {"model.all_reduce": 20, "model.all_gather": 19},
                   "fused": {"model.all_reduce": 5, "model.all_gather": 19},
                   "pallas_taps": {"model.all_reduce": 5, "model.all_gather": 19}}
    data_calls = {"data.all_reduce": 27, "data.all_gather": 1}
    paths = {}

    def f32_ok(label, c, path, m_split=True):
        bad = {k: v for k, v in c.items() if k.endswith("over_bound") and not v <= 1.0}
        want_calls = {**data_calls, **(model_calls[path] if m_split else {})}
        if bad or not c["topk_equal"] or c["launches"] != per_step[path] or c["collectives"] != want_calls:
            raise AssertionError(f"{label}: the grid step differs from one process: {c}")
        emit(check=label, **c, bounds="phase 8's: loss rtol 1e-4, temperature 1e-6, gradients (summed over the data "
                                      "axis, gathered over the model axis) 1e-3 of the tensor's largest + 1e-4 of "
                                      "the model's, BN statistics atol 1e-5 + rtol 1e-4")

    def summed(runs):
        return {k: sum(r[k] for r in runs) for k in runs[0]}

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        t = time.perf_counter()
        a = spawn_ranks(ma_rank_gloo_1x2, 2, args=(log_dir,), backend="gloo", timeout=600)
        a_s = time.perf_counter() - t
        t = time.perf_counter()
        b = spawn_ranks(ma_rank_gloo_2x2, 4, backend="gloo", timeout=600)
        b_s = time.perf_counter() - t
        t = time.perf_counter()
        c = spawn_ranks(ma_rank_nccl, 1, backend="nccl", timeout=600)[0]
        c_s = time.perf_counter() - t
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    emit(timing="phase 19: seconds a spawn", gloo_1x2_s=a_s, gloo_1x2_rank_parts_s=[r["seconds"] for r in a],
         gloo_2x2_s=b_s, nccl_1x1_s=c_s)

    # (a) and (d): the 1×2 grid's f32 checks, its bf16 steps and their kernels
    for path in ("module", "fused", "pallas_taps"):
        for r in a:
            f32_ok(f"model axis 1x2 f32 B=16 {path}, gloo rank {r['rank']} of 2", r["f32_b16"][path], path)
        paths[f"ma_1x2_f32_{path}"] = summed([r["f32_b16"][path]["launches"] for r in a])
    one_losses = a[0]["one_process_losses"]
    for r in a:
        bf = r["bf16"]
        if bf["launches"] != {k: 3 * v for k, v in bf16_step.items()}:
            raise AssertionError(f"model axis 1x2 bf16: launches {bf['launches']}")
        if bf["collectives_per_step"] != {**data_calls, **model_calls["module"]}:
            raise AssertionError(f"model axis 1x2 bf16: collectives {bf['collectives_per_step']}")
        rel = [abs(x - y) / abs(y) for x, y in zip(bf["losses"], one_losses)]
        if bf["losses"] != a[0]["bf16"]["losses"] or not (rel[0] <= 1e-3 and max(rel) <= 1e-2):
            raise AssertionError(f"model axis 1x2 bf16 losses {bf['losses']} against one process {one_losses}")
        kc = r["kernel_checks"]
        shapes = {form: {tuple(s_) for s_ in c_["shapes"]} for form, c_ in kc.items()}
        if (sorted(kc) != ["K1", "K1 dX", "K2"] or not all(c_["err_over_bound"] <= 1.0 for c_ in kc.values())
                or kc["K1"]["bodies"] != ["wmma"] or kc["K1 dX"]["bodies"] != ["wmma"]
                or shapes["K1"] != {(64, 360, 135)} or {s_[2] for s_ in shapes["K2"]} != {160, 320}):
            raise AssertionError(f"model axis 1x2: K1 and K2 on the column blocks: {kc}")
    paths["ma_1x2_bf16"] = summed([r["bf16"]["launches"] for r in a])
    emit(phase="model_axis_gloo_1x2", backend="gloo", world=2, grid={"data": 1, "model": 2}, device=a[0]["device"],
         config="flagship: B=64 C=208 T=360 D1=270 D2=320 F=1024 K=32 S=27, bf16, channels-last, precomputed "
                "collate stats, conv_impl=gemm_pdw; param_shardings min_dim 64 (21 of 60 leaves split)",
         losses=a[0]["bf16"]["losses"], one_process_losses=one_losses,
         loss_rel_diff=[abs(x - y) / abs(y) for x, y in zip(a[0]["bf16"]["losses"], one_losses)],
         ms_per_step_host_clock_check_only=[r["bf16"]["ms_per_step_host_clock"] for r in a],
         collectives_per_step=a[0]["bf16"]["collectives_per_step"],
         launches_per_rank=[r["bf16"]["launches"] for r in a], k1_last_body=[r["bf16"]["k1_last_body"] for r in a],
         kernel_checks=[r["kernel_checks"] for r in a],
         bounds="bf16 losses against one process: the first step's rtol 1e-3, the later ones 1e-2 (the grid sums its "
                "input-gradient partials in bf16, and Adam turns that rounding into moves of ±lr); kernels phase 3's "
                "bf16: K1, K1 dX 1e-2 and rtol 1e-2, K2 1e-4 and 1e-4")
    # (c) the traced step
    for r in a:
        pr = r["profile"]
        calls_ = {k: v["calls"] for k, v in pr["ranges"].items()}
        if pr["trace_files"] < 1 or calls_ != {"model.all_gather": 19, "model.all_reduce": 20}:
            raise AssertionError(f"model axis profile: {pr}")
    emit(profile="model axis 1x2: one bf16 grid step under utils.profiling.trace, each model-axis collective in "
                 "an annotate range (gloo: staged through the host)", by_rank=[r["profile"] for r in a])

    # (b) the 2×2 grid
    for r in b:
        f32_ok(f"model axis 2x2 f32 B=16 module, gloo rank {r['rank']} (data, model)", r["f32_b16"], "module")
    paths["ma_2x2_f32_module"] = summed([r["f32_b16"]["launches"] for r in b])

    # NCCL at world size 1: a 1×1 grid, and the column-block kernel timings
    f32_ok("model axis 1x1 f32 B=8 module, NCCL world 1", c["f32_b8"], "module", m_split=False)
    for name in ("one_process", "grid"):
        # the one-process step replays its graph, captured in the warm-up,
        # so none of its timed steps launches from the host
        launched = 0 if name == "one_process" else 3
        if c[name]["launched_steps"] != launched or \
                c[name]["launches"] != {k: launched * v for k, v in bf16_step.items()}:
            raise AssertionError(f"model axis NCCL 1x1 {name}: launches {c[name]['launches']} in "
                                 f"{c[name]['launched_steps']} launched steps")
    paths["ma_nccl_1x1"] = c["grid"]["launches"]
    emit(phase="model_axis_nccl_1x1", backend="nccl", world=c["world"], device=c["device"],
         config="flagship bf16 B=64, conv_impl=gemm_pdw, grid 1x1 (nothing splits)", steps=3,
         grid_ms_per_step_cuda_events=c["grid"]["ms_per_step_cuda_events"],
         grid_ms_per_step_host_clock=c["grid"]["ms_per_step_host_clock"],
         one_process_ms_per_step_cuda_events=c["one_process"]["ms_per_step_cuda_events"],
         one_process_ms_per_step_host_clock=c["one_process"]["ms_per_step_host_clock"],
         losses=c["grid"]["losses"], one_process_losses=c["one_process"]["losses"])
    bk = c["block_kernels"]
    for name, v in bk.items():
        if name.startswith("K1") and v["body"] != ("wgmma" if "whole" in name else "wmma"):
            raise AssertionError(f"{name}: body {v['body']}")
    emit(timing="K1 and K2 at a 1x2 grid's column blocks beside their whole widths (flagship B=64, bf16; NCCL rank, "
                "before any profiler trace)", by_call=bk)
    return paths


def int8_retrieval_ab() -> dict:
    """The port's ``tools.ab_int8_retrieval`` once at the flagship's D with
    4,096 candidates and a serving batch of 64."""
    import torch

    from speech_decoding_tpu_torch.tools import ab_int8_retrieval as ab

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r = ab.ab(4096, batch=64, device="cuda")
    if r["whole_top1_agreement"] != 1.0 or r["int32_top1_agreement"] != 1.0 or r["int32_max_score_diff"] > 1e-5:
        raise AssertionError(f"ab_int8_retrieval: the int8 routes disagree: {r}")
    emit(**{**r, "tool": "speech_decoding_tpu_torch.tools.ab_int8_retrieval"},
         port_minus_whole_ms=r["port_ms"] - r["whole_ms"])
    torch.cuda.empty_cache()
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.nn import functional as Fn

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from speech_decoding_tpu_torch.config import load_config
        from speech_decoding_tpu_torch.data.layout import ch_locations_2d
        from speech_decoding_tpu_torch.inference import SpeechDecoder
        from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder, ConvBlock, spatial_dropout_mask
        from speech_decoding_tpu_torch.ops import _build
        from speech_decoding_tpu_torch.ops import conv_block_train as cbt
        from speech_decoding_tpu_torch.ops.conv_block import (
            conv_block_fused, conv_block_plain, dilations, prepare_fused_stack,
        )
        from speech_decoding_tpu_torch.ops import retrieval as k3_module
        from speech_decoding_tpu_torch.ops.retrieval import (
            near_tie_rows, retrieval_metrics_kernel, retrieval_ranks, retrieval_ranks_plain,
        )
        from speech_decoding_tpu_torch.ops.scaling import window_scale_stats
        from speech_decoding_tpu_torch.ops import subject_conv as sc
        from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul, subject_matmul_plain
        from speech_decoding_tpu_torch.ops.tap_conv import (
            flip_taps, pad_channels, tap_conv, tap_conv_dw, tap_conv_dw_plain, tap_conv_plain, tap_conv_transposed,
        )
        from speech_decoding_tpu_torch.serving import DecoderServer, decode_request
        from speech_decoding_tpu_torch.tools import bench_batchnorm_gelu as bn_tool
        from speech_decoding_tpu_torch.tools import bench_glu as glu_tool
        from speech_decoding_tpu_torch.tools import bench_cross_block_merge as merge_tool
        from speech_decoding_tpu_torch.tools import scale_run
        from speech_decoding_tpu_torch.training import (
            CheckpointManager, PreemptionGuard, Trainer, create_train_state, make_chunked_eval, make_eval_step,
            make_train_step,
        )
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here ({e})", file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    peaks = peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    # -- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    libs = _build.build(["subject_matmul", "conv_block", "tap_conv_dw", "retrieval_ranks", "tap_conv",
                         "conv_block_train", "batchnorm_gelu", "glu"])
    emit(phase="build", seconds=time.perf_counter() - t, libraries=[os.path.relpath(p, ROOT) for p in libs])

    # every path's run sets all launch counters to 0 just before and reads them all just after
    counted = launch_counters()
    reset_counts, read_counts = _reset_counts, _read_counts

    def expect(**nonzero):
        """Launch counts with every counter 0 except those named (K6's stages as F1=..., K7 as F31=...)."""
        want = dict.fromkeys(counted, 0)
        for name, n in nonzero.items():
            want[name if name in want else f"conv_block_train.{name}"] = n
        return want

    B, C, T, D1, D2, F, K, S = 64, 208, 360, 270, 320, 1024, 32, 27
    bf16, f32 = torch.bfloat16, torch.float32

    # -- 3. K1 vs plain ------------------------------------------------------
    def k1_inputs(b, t_, din, dout, s, dtype):
        x = torch.randn(b, t_, din, generator=gen).to(dev, dtype)
        w = (torch.rand(s, din, dout, generator=gen) * 2 - 1).div(din ** 0.5).to(dev, dtype)
        ids = torch.from_numpy(rng.integers(0, s, size=b).astype(np.int32)).to(dev)
        return x, w, ids

    # the route each product took ("wgmma": the Hopper body, x read where it
    # lies; "wmma": ragged shapes and misaligned bases; "f32"); the flagship
    # and the eval chunk must take the wgmma body, forward and dX
    def k1_check(name, x, w, ids, atol, rtol, want_route=None):
        got = subject_matmul(x, w, ids)
        route = subject_matmul.route
        k1_err[name] = compare(name, got, subject_matmul_plain(x, w, ids), atol, rtol, route=route)
        if want_route and route != want_route:
            raise AssertionError(f"{name} took the {route} body, expected {want_route}")

    k1_err = {}
    for dtype, atol, rtol in ((f32, 1e-5, 1e-5), (bf16, 1e-2, 1e-2)):
        for shape in ((B, T, D1, D1, S), (3, 37, 19, 150, 4)):
            x, w, ids = k1_inputs(*shape, dtype)
            want_route = "f32" if dtype == f32 else "wgmma" if shape[0] == B else "wmma"
            k1_check(f"K1 {str(dtype)[6:]} {shape}", x, w, ids, atol, rtol, want_route)
    x, w, ids = k1_inputs(1024, T, D1, D1, S, bf16)  # the eval chunk
    k1_check(f"K1 bf16 {(1024, T, D1, D1, S)}", x, w, ids, 1e-2, 1e-2, "wgmma")
    x, w, ids = k1_inputs(B, T, D1, D1, S, bf16)
    k1_check(f"K1 bf16 {(B, T, D1, D1, S)} every id 13 (an odd subject)", x, w, torch.full_like(ids, 13),
             1e-2, 1e-2, "wgmma")
    k1_check(f"K1 bf16 {(S, T, D1, D1, S)} every id distinct", x[:S], w,
             torch.randperm(S, generator=gen).to(dev, torch.int32), 1e-2, 1e-2, "wgmma")
    k1_check(f"K1 bf16 {(B, T, D1, D1, S)} misaligned x", misaligned(x), w, ids, 1e-2, 1e-2, "wmma")
    k1_check(f"K1 bf16 {(B, T, D1, D1, S)} misaligned W", x, misaligned(w), ids, 1e-2, 1e-2, "wgmma")
    # the weight image: the pack kernel against its plain version, bit for bit
    for transposed in (False, True):
        sc._packs.clear()
        img = sc.packed_weights(w, transposed)
        torch.cuda.synchronize()
        if not torch.equal(img, sc.pack_weights(w, transposed)):
            raise AssertionError(f"K1 pack kernel (transposed={transposed}) differs from pack_weights")
        emit(check=f"K1 pack kernel {'Wᵀ ' if transposed else ''}(S, {D1}, {D1}) against pack_weights",
             bitwise_equal=True)
    try:
        subject_matmul(x, w, torch.full_like(ids, w.shape[0]))
        raise AssertionError("K1 accepted an out-of-range subject id")
    except ValueError:
        emit(check="K1 rejects an out-of-range subject id")

    # K1 backward: dX through the kernel on Wᵀ, dW by segment sum, against the
    # plain version's autograd; tolerance relative to the largest entry (f32:
    # order of the sums; bf16: the outputs round to bf16)
    k1b_err = {}
    for dtype, rel in ((f32, 1e-5), (bf16, 1e-2)):
        for shape in ((B, T, D1, D1, S), (3, 37, 19, 150, 4)):
            x, w, ids = k1_inputs(*shape, dtype)
            gy = torch.randn(shape[0], shape[1], shape[3], generator=gen).to(dev, dtype)
            grads = []
            for fn in (subject_matmul, subject_matmul_plain):
                xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
                fn(xa, wa, ids).backward(gy)
                grads.append((xa.grad, wa.grad))
                if fn is subject_matmul:
                    route = subject_matmul.route  # the dX's
            if dtype == bf16 and shape[0] == B and route != "wgmma":
                raise AssertionError(f"K1 backward dX at the flagship took the {route} body")
            for part, got, want in zip(("dX", "dW"), *grads):
                name = f"K1 backward {part} {str(dtype)[6:]} {shape}"
                k1b_err[name] = compare(name, got, want, rel * float(want.abs().max()), rel,
                                        **({"route": route} if part == "dX" else {}))
    # a misaligned g: the dX takes the wmma body on a copy and must match
    x, w, ids = k1_inputs(B, T, D1, D1, S, bf16)
    gy = torch.randn(B, T, D1, generator=gen).to(dev, bf16)
    xa = x.clone().requires_grad_()
    subject_matmul(xa, w, ids).backward(misaligned(gy))
    want = subject_matmul_plain(gy, w.transpose(1, 2), ids)
    name = f"K1 backward dX bf16 {(B, T, D1, D1, S)} misaligned g"
    k1b_err[name] = compare(name, xa.grad, want, 1e-2 * float(want.abs().max()), 1e-2, route=subject_matmul.route)

    # -- 3b. K2 vs plain -----------------------------------------------------
    # bf16 x and g: products exact in f32, both sides sum in f32 in another
    # order (1e-4 of the largest entry); f32 likewise at 1e-5
    convs = flagship_convs(D1, D2, dilations)
    k2_err = {}
    xs = {c: torch.randn(B, T, c, generator=gen).to(dev, bf16) for c in (D1, D2)}
    gs = {c: torch.randn(B, T, c, generator=gen).to(dev, bf16) for c in (D2, 2 * D2)}
    for cin, cout, d in sorted(set(convs)):
        want = tap_conv_dw_plain(xs[cin], gs[cout], d)
        name = f"K2 bf16 {(B, T, cin, cout)} d={d}"
        k2_err[name] = compare(name, tap_conv_dw(xs[cin], gs[cout], d), want, 1e-4 * float(want.abs().max()), 1e-4)
    for dtype, rel, shapes in ((f32, 1e-5, [(4, T, D1, D2, 1), (4, T, D2, D2, 16), (4, T, D2, 2 * D2, 2)]),
                               (f32, 1e-5, [(3, 13, 270, 40, 16), (3, 13, 270, 40, 4), (3, 37, 270, 72, 8)]),
                               (bf16, 1e-4, [(3, 13, 270, 40, 16), (3, 37, 270, 72, 8), (1, 1, 1, 1, 1),
                                             (1, T, 272, 270, 2), (2, 40, 270, 272, 4), (3, 13, 272, 272, 16)])):
        for b_, t_, cin, cout, d in shapes:
            x = torch.randn(b_, t_, cin, generator=gen).to(dev, dtype)
            gy = torch.randn(b_, t_, cout, generator=gen).to(dev, dtype)
            want = tap_conv_dw_plain(x, gy, d)
            name = f"K2 {str(dtype)[6:]} {(b_, t_, cin, cout)} d={d}"
            k2_err[name] = compare(name, tap_conv_dw(x, gy, d), want, rel * float(want.abs().max()), rel)
    # a base that is not 16-byte aligned (TMA needs one; the wrapper copies
    # it): x, then g
    x = torch.randn(4, 90, D2, generator=gen).to(dev, bf16)
    gy = torch.randn(4, 90, D2, generator=gen).to(dev, bf16)
    want = tap_conv_dw_plain(x, gy, 4)
    for label, args_ in (("x", (misaligned(x), gy)), ("g", (x, misaligned(gy)))):
        name = f"K2 bf16 (4, 90, {D2}, {D2}) d=4, misaligned {label}"
        k2_err[name] = compare(name, tap_conv_dw(*args_, 4), want, 1e-4 * float(want.abs().max()), 1e-4)
    for dtype in (bf16, f32):
        x, gy = xs[D2].to(dtype), gs[2 * D2].to(dtype)
        first, second = tap_conv_dw(x, gy, 2), tap_conv_dw(x, gy, 2)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"K2 {dtype}: two runs on the same inputs differ")
        emit(check=f"K2 {str(dtype)[6:]} deterministic", shape=[B, T, D2, 2 * D2], bitwise_equal=True)
    del xs, gs

    # -- 3c. K5 vs plain -----------------------------------------------------
    # both sides sum the three taps in f32 and cast once: they differ by a
    # flipped bf16 rounding (1e-2 of the largest entry + 1e-2 relative) at
    # most; f32 by the order of the sums (1e-5)
    # dx: tap_conv_transposed(g, w) against the plain conv with flip_taps(w)
    k5_err = {}
    for cin, cout, d in sorted(set(convs)):
        x = torch.randn(B, T, cin, generator=gen).to(dev, bf16)
        w = torch.randn(3, cin, cout, generator=gen).div((3 * cin) ** 0.5).to(dev, bf16)
        gy = torch.randn(B, T, cout, generator=gen).to(dev, bf16)
        for form, got, want in (("", lambda: tap_conv(x, w, d), tap_conv_plain(x, w, d)),
                                (" dx", lambda: tap_conv_transposed(gy, w, d), tap_conv_plain(gy, flip_taps(w), d))):
            name = f"K5 bf16{form} {(B, T, cin, cout)} d={d}"
            k5_err[name] = compare(name, got(), want, 1e-2 * float(want.abs().max()), 1e-2)
    for dtype, rel, shapes in ((f32, 1e-5, [(4, T, D1, D2, 1), (4, T, D2, D2, 16), (4, T, D2, 2 * D2, 2),
                                            (4, T, 2 * D2, D2, 2), (3, 37, 270, 40, 16)]),
                               (bf16, 1e-2, [(3, 37, 270, 40, 16), (1, 2, 1, 1, 1), (1, T, 272, 270, 2),
                                             (2, 40, 270, 272, 4), (1, 17, 272, 272, 16)])):
        for b_, t_, cin, cout, d in shapes:
            x = torch.randn(b_, t_, cin, generator=gen).to(dev, dtype)
            w = torch.randn(3, cin, cout, generator=gen).div((3 * cin) ** 0.5).to(dev, dtype)
            want = tap_conv_plain(x, w, d)
            name = f"K5 {str(dtype)[6:]} {(b_, t_, cin, cout)} d={d}"
            k5_err[name] = compare(name, tap_conv(x, w, d), want, rel * float(want.abs().max()), rel)
            gy = torch.randn(b_, t_, cout, generator=gen).to(dev, dtype)
            want = tap_conv_plain(gy, flip_taps(w), d)
            name = f"K5 {str(dtype)[6:]} dx {(b_, t_, cin, cout)} d={d}"
            k5_err[name] = compare(name, tap_conv_transposed(gy, w, d), want, rel * float(want.abs().max()), rel)
    # misaligned bases (copied by the wrapper): x, then w, then the dx's w
    x = torch.randn(3, 70, D2, generator=gen).to(dev, bf16)
    w = torch.randn(3, D2, D2 // 2, generator=gen).div((3 * D2) ** 0.5).to(dev, bf16)
    gy = torch.randn(3, 70, D2 // 2, generator=gen).to(dev, bf16)
    want, want_dx = tap_conv_plain(x, w, 2), tap_conv_plain(gy, flip_taps(w), 2)
    for label, got, ref in (("x", lambda: tap_conv(misaligned(x), w, 2), want),
                            ("w", lambda: tap_conv(x, misaligned(w), 2), want),
                            ("w, dx", lambda: tap_conv_transposed(gy, misaligned(w), 2), want_dx)):
        name = f"K5 bf16 (3, 70, {D2}, {D2 // 2}) d=2, misaligned {label}"
        k5_err[name] = compare(name, got(), ref, 1e-2 * float(ref.abs().max()), 1e-2)
    for dtype in (bf16, f32):
        x = torch.randn(B, T, D2, generator=gen).to(dev, dtype)
        w = torch.randn(3, D2, D2, generator=gen).div((3 * D2) ** 0.5).to(dev, dtype)
        first, second = tap_conv(x, w, 4), tap_conv(x, w, 4)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"K5 {dtype}: two runs on the same inputs differ")
        emit(check=f"K5 {str(dtype)[6:]} deterministic", shape=[B, T, D2, D2], bitwise_equal=True)

    # -- 3d. K3 vs plain -----------------------------------------------------
    # Z = a·Y + noise with a = 2/sqrt(D): the diagonal cosine sits two
    # standard deviations above a random pair's, so ranks spread
    NE = 2048  # segments in the eval phase below: an assumed test-set size
    gdev = torch.Generator(device=dev).manual_seed(args.seed)

    def k3_inputs(b, d):
        Y = torch.randn(b, d, generator=gdev, device=dev)
        return (2 / d ** 0.5 * Y + torch.randn(b, d, generator=gdev, device=dev)).to(bf16), Y

    # the wgmma body at the eval's B=2048 and the Trainer's B=64 (split
    # depth), Y f32 (three bf16 pieces) and bf16 (one), a ragged B on it, and
    # D % 8 != 0 on the f32 CUDA-core body
    k3_err = 0
    for b_, d, ydt, route, pieces in ((NE, F * T, f32, "wgmma", 3), (64, F * T, f32, "wgmma", 3),
                                      (64, F * T, bf16, "wgmma", 1), (333, 1000, f32, "wgmma", 3),
                                      (333, 1001, f32, "f32", None)):
        Z, Y = k3_inputs(b_, d)
        Y = Y.to(ydt)
        got = retrieval_ranks(Z, Y)
        took = (retrieval_ranks.route, retrieval_ranks.pieces, retrieval_ranks.splits)
        want = retrieval_ranks_plain(Z, Y)
        torch.cuda.synchronize()
        differ = set(torch.nonzero(got != want).flatten().tolist())
        ties = near_tie_rows(Z, Y)
        err = int((got - want).abs().max())
        emit(check=f"K3 ranks B={b_} D={d} (Z bf16, Y {str(ydt)[6:]})", route=took[0], pieces=took[1],
             depth_splits=took[2], rows_differing=sorted(differ), near_tie_rows=sorted(ties),
             distinct_ranks=int(torch.unique(want).numel()), max_abs_err=err)
        if took[:2] != (route, pieces):
            raise AssertionError(f"K3 B={b_} D={d}: took {took[:2]}, expected {(route, pieces)}")
        if not differ <= ties:
            raise AssertionError(f"K3: rows {sorted(differ - ties)[:10]} differ from the plain ranks without a near-tie")
        if torch.unique(want).numel() < 10:
            raise AssertionError("K3 check inputs give too few distinct ranks")
        if b_ == 64 and took[2] < 2:
            raise AssertionError(f"K3 B=64 D={d}: the depth was not split ({took[2]})")
        k3_err = max(k3_err, err)
        del Z, Y

    # -- 4. K4 vs plain ------------------------------------------------------
    loc = ch_locations_2d("Gwilliams2022", root_dir=ROOT, cache=False)
    enc_kw = dict(num_subjects=S, loc=loc, D1=D1, D2=D2, F=F, K=K)
    enc16 = BrainEncoder(compute_dtype=bf16, generator=torch.Generator().manual_seed(args.seed), **enc_kw)
    random_bn_stats(enc16, gen)
    enc32 = BrainEncoder(compute_dtype=f32, generator=torch.Generator().manual_seed(args.seed), **enc_kw)
    enc32.load_state_dict(enc16.state_dict())
    enc16.to(dev).eval()
    enc32.to(dev).eval()
    staged16 = prepare_fused_stack(enc16.conv_blocks, bf16)
    staged32 = prepare_fused_stack(enc32.conv_blocks, f32)

    # bf16 on the wgmma route (three conv_wg launches a block, one count):
    # h0, h1 and the output round to bf16, so a flipped rounding is one ulp
    # (1e-2 + 1e-2 relative); two runs on the same inputs must give the same
    # bits. f32 on the CUDA-core body: sums in another order (1e-4)
    k4_err = {}

    def k4_check(name, x, staged, k, want_route, tol):
        got = conv_block_fused(x, *staged, k=k)
        route = conv_block_fused.route
        again = conv_block_fused(x, *staged, k=k)
        torch.cuda.synchronize()
        if route != want_route or not torch.equal(got, again):
            raise AssertionError(f"{name}: route {route} (want {want_route}), bitwise repeat {torch.equal(got, again)}")
        k4_err[name] = compare(name, got, conv_block_plain(x, *staged, k=k), tol, tol, route=route,
                               bitwise_repeat=True)

    for k in range(5):
        cin = D1 if k == 0 else D2
        x = torch.randn(B, T, cin, generator=gen).to(dev, bf16)
        k4_check(f"K4 k={k} bf16 {(B, T, cin)}", x, staged16[k], k, "wgmma", 1e-2)
        x = torch.randn(4, T, cin, generator=gen).to(dev, f32)
        k4_check(f"K4 k={k} f32 {(4, T, cin)}", x, staged32[k], k, "f32", 1e-4)
    # ragged: D2 not a multiple of the 128-channel tile, Cin not of the
    # 32-deep chunk, T shorter than the widest halo (every dilation hits an
    # edge); bf16: T under one 192-row tile, Cin=40 and D2=48 under one
    # 64-channel chunk and one 160-column tile (inputs from their own
    # generator, so every later input is the parent's)
    small = BrainEncoder(num_subjects=2, loc=loc, D1=40, D2=48, F=16, K=4,
                         generator=torch.Generator().manual_seed(args.seed + 1))
    random_bn_stats(small, gen)
    small.to(dev)
    staged_small = prepare_fused_stack(small.conv_blocks, f32)
    staged_small16 = prepare_fused_stack(small.conv_blocks, bf16)
    g_ragged = torch.Generator().manual_seed(args.seed + 7)
    for k in range(5):
        for t_ in (37, 13):
            x = torch.randn(3, t_, 40 if k == 0 else 48, generator=gen).to(dev)
            k4_check(f"K4 k={k} f32 ragged {tuple(x.shape)}", x, staged_small[k], k, "f32", 1e-4)
            x = torch.randn(3, t_, 40 if k == 0 else 48, generator=g_ragged).to(dev, bf16)
            k4_check(f"K4 k={k} bf16 ragged {tuple(x.shape)}", x, staged_small16[k], k, "wgmma", 1e-2)

    # -- 4b. K6 stages vs plain ------------------------------------------------
    # activations in bf16: a flipped rounding (1e-2 + 1e-2 relative); f32
    # results (sums, dW, db; f32 activations): 1e-3 (bf16 inputs) or 1e-4
    # (f32 inputs) of the tensor's largest entry + the same relative, since
    # a flipped bf16 rounding inside the stage moves a sum by a few ulps of
    # one term
    gk6 = torch.Generator(device=dev).manual_seed(args.seed + 4)
    k6_err = {}

    def k6_check(tag, b_, t_, k, dtype):
        rel = 1e-3 if dtype == bf16 else 1e-4
        cin = D1 if k == 0 else D2
        ins = cbt.stage_inputs(b_, t_, cin, D2, k, dtype, dev, gk6)
        want_route = "wgmma" if dtype == bf16 else "tap3"
        for st, fn in cbt.STAGES.items():
            got = fn(*ins[st])
            if cbt.conv_block_train.route != want_route:
                raise AssertionError(f"K6 {st} k={k} {tag} took {cbt.conv_block_train.route}, not {want_route}")
            want = cbt.PLAIN[st](*ins[st])
            got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
            errs = [compare(f"K6 {st} k={k} {tag} output {i}", a, b,
                            *((1e-2, 1e-2) if a.dtype == bf16 else (rel * float(b.abs().max()), rel)), show=False)
                    for i, (a, b) in enumerate(zip(got, want))]
            name = f"K6 {st} k={k} {tag} {(b_, t_, cin, D2)}"
            emit(check=name, route=want_route, outputs=len(got), max_abs_err=max(errs),
                 bf16_outputs="atol 1e-2 rtol 1e-2", f32_outputs=f"{rel} of the largest entry, rtol {rel}")
            k6_err[name] = max(errs)

    for k in range(5):
        k6_check("bf16", B, T, k, bf16)
        k6_check("f32", 4, T, k, f32)
    for k in (2, 4):  # d=16 against T=37: the halo reaches both edges of the recording
        k6_check("f32 ragged", 3, 37, k, f32)
        k6_check("bf16 ragged", 3, 37, k, bf16)
    for dtype in (bf16, f32):
        ins = cbt.stage_inputs(B, T, D2, D2, 2, dtype, dev, gk6)
        for st, fn in cbt.STAGES.items():
            first, second = (v if isinstance(v, tuple) else (v,) for v in (fn(*ins[st]), fn(*ins[st])))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"K6 {st} {dtype}: two runs on the same inputs differ")
        emit(check=f"K6 {str(dtype)[6:]} all six stages deterministic", shape=[B, T, D2, D2], k=2,
             bitwise_equal=True)
    del ins

    # -- 4c. K7 vs plain and vs the pair of its route ------------------------------
    # f31 and f31_tile against the plain version (activations as K6's: a
    # flipped bf16 rounding, 1e-2 + 1e-2 relative; s0n at 1e-3 (bf16) or 1e-4
    # (f32) of its largest entry): the tap3 route against f31_plain, the
    # wgmma route stage by stage (out against f3_plain, y0n and s0n against
    # f1_plain on K7's own out, as K6's stages are held: chained, a flipped
    # bf16 rounding of out reaches y0n through the skip, where y0n can cancel
    # to near zero; the chained error is reported). Each with its route
    # asserted (f31: wgmma in bf16, tap3 in f32; f31_tile: tap3) and against
    # the K6 pair of that route on the same inputs: wgmma, out, y0n and s0n
    # bitwise f3 then f1; tap3, out and y0n bitwise f3_tile then f1_tile, s0n
    # within rtol 1e-6 (the same chunk walk and tap order); every call
    # repeated bit for bit. The T=400 checks (three time tiles: the middle
    # one's F1 reads both neighbours' F3 tiles) draw from their own generator
    k7_err = {}
    gk7 = torch.Generator(device=dev).manual_seed(args.seed + 7)

    def k7_check(tag, b_, t_, k_next, dtype, gen=gk6):
        ins = cbt.stage_inputs(b_, t_, D2, D2, k_next, dtype, dev, gen)
        args7 = (*ins["F3"], *ins["F1"][1:3], k_next)  # block k's F3, block k_next's conv0
        want = cbt.f31_plain(*args7)
        rel = 1e-3 if dtype == bf16 else 1e-4
        for fn, want_route in ((cbt.f31, "wgmma" if dtype == bf16 else "tap3"), (cbt.f31_tile, "tap3")):
            got = fn(*args7)
            route = cbt.f31.route
            name = f"K7 {fn.__name__} k_next={k_next} {tag} {(b_, t_, D2)}"
            if route != want_route:
                raise AssertionError(f"{name} took {route}, not {want_route}")
            ref = want if route == "tap3" else (want[0], *cbt.f1_plain(got[0], args7[5], args7[6], k_next))
            errs = [compare(f"{name} output {i}", a, b, *((1e-2, 1e-2) if a.dtype == bf16 else
                                                          (rel * float(b.abs().max()), rel)), show=False)
                    for i, (a, b) in enumerate(zip(got, ref))]
            chained = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            f3p, f1p = (cbt.f3, cbt.f1) if route == "wgmma" else (cbt.f3_tile, cbt.f1_tile)
            out_p = f3p(*args7[:5])
            pair = (out_p, *f1p(out_p, args7[5], args7[6], k_next))
            torch.cuda.synchronize()
            if not (torch.equal(got[0], pair[0]) and torch.equal(got[1], pair[1])):
                raise AssertionError(f"{name}: out or y0n differs from its pair {f3p.__name__} + {f1p.__name__}")
            s0n_equal = bool(torch.equal(got[2], pair[2]))
            if not (s0n_equal or (route == "tap3" and torch.allclose(got[2], pair[2], rtol=1e-6, atol=0.0))):
                raise AssertionError(f"{name}: s0n differs from its pair's")
            again = fn(*args7)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two runs on the same inputs differ")
            emit(check=name, route=route, d0n=dilations(k_next)[0], max_abs_err=max(errs),
                 max_abs_ref={n: float(b.abs().max()) for n, b in zip(("out", "y0n", "s0n"), want)},
                 vs_plain="f31_plain" if route == "tap3" else "f3_plain; f1_plain on K7's own out",
                 vs_plain_bf16="atol 1e-2 rtol 1e-2", vs_plain_f32=f"{rel} of the largest entry, rtol {rel}",
                 chained_vs_f31_plain_max_abs_err=chained,
                 pair=f"{f3p.__name__} + {f1p.__name__}",
                 vs_pair="out, y0n, s0n bitwise" if route == "wgmma" else "out, y0n bitwise; s0n rtol 1e-6",
                 s0n_bitwise_equal_to_pair=s0n_equal, repeat_bitwise_equal=True)
            k7_err[name] = max(errs)

    for k_next in range(1, 5):
        k7_check("bf16", B, T, k_next, bf16)
        k7_check("f32", 4, T, k_next, f32)
    for dtype in (f32, bf16):  # d0n=16 against T=37: the reads pass both edges of the recording
        k7_check(f"{str(dtype)[6:]} ragged", 3, 37, 2, dtype)
    for k_next in (2, 3):  # three time tiles
        k7_check("bf16 ragged", 3, 400, k_next, bf16, gk7)

    # one block: conv_block_train's forward and backward against the module
    # ConvBlock's train forward with autograd, f32 on the card (the same
    # function; sums in another order): out and each gradient at 1e-4 of its
    # largest entry + 1e-5 of the largest gradient (the conv biases ahead of
    # a batch-stat BN hold rounding noise on both sides)
    for k in (0, 3):
        cin = D1 if k == 0 else D2
        blk = ConvBlock(k, cin, D2, generator=torch.Generator().manual_seed(args.seed + k)).to(dev)
        x = torch.randn(8, T, cin, generator=gk6, device=dev).requires_grad_()
        gy = torch.randn(8, T, D2, generator=gk6, device=dev)
        params = [p.detach().clone().requires_grad_() for p in blk.parameters()]
        want_out = blk(x, train=True)
        want_out.backward(gy)
        want = [x.grad] + [p.grad for p in blk.parameters()]
        x2 = x.detach().clone().requires_grad_()
        out, _ = cbt.conv_block_train(x2, *params, k)
        out.backward(gy)
        gmax = max(float(g.abs().max()) for g in want)
        errs = [compare(f"K6 block k={k} out", out, want_out, 1e-4 * float(want_out.detach().abs().max()), 0.0,
                        show=False)]
        for name, a, b in zip(["x"] + [n for n, _ in blk.named_parameters()], [x2.grad] + [p.grad for p in params],
                              want):
            errs.append(compare(f"K6 block k={k} d{name}", a, b, 1e-4 * float(b.abs().max()) + 1e-5 * gmax, 0.0,
                                show=False))
        emit(check=f"K6 block k={k} f32 (8, {T}, {cin}): conv_block_train vs module ConvBlock, out and 11 grads",
             max_abs_err=max(errs), largest_gradient=gmax,
             bound="1e-4 * max|ref| of the tensor + 1e-5 * the largest gradient")
    del blk, x, x2, gy, params, want

    # -- 5. whole encode: fused serving path vs module path --------------------
    X = torch.randn(B, C, T, generator=gen).numpy()
    sidx = rng.integers(0, S, size=B).astype(np.int32)
    for enc, dtype, rows, atol, rtol in ((enc32, "f32", 8, 2e-6, 1e-4), (enc16, "bf16", B, 2e-3, 2e-2)):
        fused = SpeechDecoder(enc, use_fused_blocks=True, device="cuda")
        module = SpeechDecoder(enc, use_fused_blocks=False, device="cuda")
        compare(f"encode fused vs module {dtype} B={rows}", fused.encode(X[:rows], sidx[:rows]),
                module.encode(X[:rows], sidx[:rows]), atol, rtol)

    # -- 6. the main path: HTTP serving at full width -------------------------
    decoder = SpeechDecoder(enc16, device="cuda")  # fused blocks: the default on the card
    bank = torch.randn(512, F, T, generator=torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev)
    requests = {
        "float32": [1, 3, 16, 5, 8, 2, 11, 16, 7, 4, 1, 9],
        "int8": [16, 2, 7, 1, 12, 4, 9, 3],
    }
    # reference answers first: launches made for the comparison do not count
    want = {}
    for store, sizes in requests.items():
        decoder.set_bank(bank, store_dtype=store)
        for j, n in enumerate(sizes):
            Xr = rng.standard_normal((n, C, T), dtype=np.float32)
            ids = rng.integers(0, S, size=n).astype(np.int32)
            pad = B - n  # the batcher dispatches at max_batch rows
            s, i = decoder.decode(np.concatenate([Xr, np.zeros((pad, C, T), np.float32)]),
                                  np.concatenate([ids, np.zeros(pad, np.int32)]), k=10)
            want[store, j] = (Xr, ids, s[:n], i[:n])
    server = DecoderServer(decoder, segment_shape=(C, T), max_batch=B, max_wait_ms=20.0).start()
    answers = {}
    try:
        reset_counts()
        t = time.perf_counter()
        for store, sizes in requests.items():
            decoder.set_bank(bank, store_dtype=store)

            def call(j, store=store):
                Xr, ids, _, _ = want[store, j]
                answers[store, j] = decode_request(server.host, server.port, Xr, ids, k=10)

            threads = [threading.Thread(target=call, args=(j,)) for j in range(len(sizes))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        launches = read_counts()
        stats ={"dispatches": server.batcher.dispatches, "rows": server.batcher.rows}
    finally:
        server.shutdown()
    for key, (_, _, s_want, i_want) in want.items():
        if key not in answers:
            raise AssertionError(f"request {key} got no answer")
        s_got, i_got = answers[key]
        if not (np.array_equal(i_got, i_want) and np.allclose(s_got, s_want, rtol=0, atol=1e-5)):
            raise AssertionError(f"request {key}: served answer differs from direct decode")
    emit(phase="serve", requests=len(answers), rows=stats["rows"], dispatches=stats["dispatches"],
         seconds=serve_s, launches=launches, bank_rows=512, bank_dtypes=list(requests))
    if launches["subject_matmul"] < 1 or launches["conv_block_fused"] < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")

    # -- 7. timings at the serving shape (bf16, B=64) ---------------------------
    reset_counts()
    packs = sc.packed_weights.packs
    decoder.decode(X, sidx, k=10)
    per_decode = read_counts()
    packs_per_decode = sc.packed_weights.packs - packs
    if packs_per_decode:
        raise AssertionError(f"a decode on unchanged weights packed K1's weights {packs_per_decode} times")
    x, w, ids = k1_inputs(B, T, D1, D1, S, bf16)
    ids_host = ids.cpu()  # as serving and training pass them: checked on the host, no wait
    subject_matmul(x, w, ids_host)
    k1_route = subject_matmul.route

    def k1_pack(w_, transposed):
        """W's (or Wᵀ's) weight image made anew: one pack-kernel launch."""
        sc._packs.pop(transposed, None)
        return sc.packed_weights(w_, transposed)

    def k1_fresh(a, w_, ids_, transposed):
        """The product with its weight image made anew, as a train step runs
        it (a new bf16 cast of W each step): pack kernel, then the kernel."""
        k1_pack(w_, transposed)
        return sc._apply(a, w_, ids_, transposed)

    # kernel_ms: the serving call (host ids, image cached); with_pack_ms: the
    # image made in the call, as in training; device times in phase 11
    k1_ms = time_ms(lambda: subject_matmul(x, w, ids_host))
    k1_pack_ms = time_ms(lambda: k1_fresh(x, w, ids, False))
    k1_plain = time_ms(lambda: subject_matmul_plain(x, w, ids))
    k1_lib = time_ms(lambda: torch.bmm(x, w[ids.long()]))
    k1_args = (x, w, ids, ids_host)
    present = int(torch.unique(ids).numel())
    k1_bound, k1_by = bound_ms(2 * B * T * D1 * D1,
                               nbytes(x, ids) + present * D1 * D1 * 2 + B * T * D1 * 2, peaks, "bf16")

    def pct(ms):
        return 100 * k1_bound / ms if ms else "not measured"

    emit(timing="K1 subject_matmul", shape=[B, T, D1, D1, S], dtype="bf16", route=k1_route, kernel_ms=k1_ms,
         pct_of_bound=pct(k1_ms), with_pack_ms=k1_pack_ms, plain_ms=k1_plain, library_ms=k1_lib,
         library="torch.bmm over W[sidx] (the gather included)", bound_ms=k1_bound, bound_by=k1_by,
         launches_per_decode=per_decode["subject_matmul"], packs_per_decode=packs_per_decode)

    # K4 by CUDA events (the wrapper's host time and block 0's 272-channel
    # copy of x included), its plain version, and the module eval ConvBlock
    # (cuBLAS convs) on the same x as its yardstick; device times in phase 11
    k4 = {"ms": 0.0, "plain_ms": 0.0, "module_ms": 0.0, "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    for k in range(5):
        cin = D1 if k == 0 else D2
        x = torch.randn(B, T, cin, generator=gen).to(dev, bf16)
        args_k, blk = staged16[k], enc16.conv_blocks[k]
        ms = time_ms(lambda: conv_block_fused(x, *args_k, k=k), reps=10)
        plain = time_ms(lambda: conv_block_plain(x, *args_k, k=k), reps=5)
        with torch.inference_mode():
            module_ms = time_ms(lambda: blk(x), reps=10)
        flops = 2 * B * T * 3 * (cin * D2 + D2 * D2 + D2 * 2 * D2)
        moved = nbytes(x, *args_k) + B * T * D2 * 2
        bnd, by = bound_ms(flops, moved, peaks, "bf16")
        emit(timing=f"K4 conv_block_fused k={k}", shape=[B, T, cin, D2], dtype="bf16", route=conv_block_fused.route,
             kernel_ms=ms, plain_ms=plain, module_block_ms=module_ms, library_ms=None,
             library="none: no single PyTorch call computes a ConvBlock; the module eval ConvBlock is beside it",
             bound_ms=bnd, bound_by=by, gflop=flops / 1e9, mbytes=moved / 1e6,
             launches_per_decode=per_decode["conv_block_fused"] / 5)
        k4["ms"] += ms
        k4["plain_ms"] += plain
        k4["module_ms"] += module_ms
        k4["bound_ms"] += bnd
        k4["flops"] += flops
        k4["bytes"] += moved
    k4_by = bound_ms(k4["flops"], k4["bytes"], peaks, "bf16")[1]

    # encode with the input already on the card, fused and module in turns
    Xd = torch.from_numpy(X).to(dev)
    fused = SpeechDecoder(enc16, use_fused_blocks=True, device="cuda")
    module = SpeechDecoder(enc16, use_fused_blocks=False, device="cuda")
    turns = {"fused": [], "module": []}
    for name in ("fused", "module", "module", "fused"):
        dec = fused if name == "fused" else module
        turns[name].append(time_ms(lambda: dec.encode(Xd, sidx), reps=10))
    Z = fused.encode(Xd, sidx)
    retrieve = {}
    for store in ("float32", "int8"):
        decoder.set_bank(bank, store_dtype=store)
        retrieve[store] = time_ms(lambda: decoder.retrieve(Z, k=10), reps=10)
    t = time.perf_counter()
    for _ in range(5):
        decoder.decode(X, sidx, k=10)  # numpy in and out: host copies included
    decode_ms = (time.perf_counter() - t) / 5 * 1e3
    del bank
    emit(timing="decode B=64 bf16", encode_fused_ms=sum(turns["fused"]) / 2,
         encode_module_ms=sum(turns["module"]) / 2, turns=turns,
         retrieve_ms={f"{k} bank (512 rows)": v for k, v in retrieve.items()},
         decode_ms_int8_bank_host_clock=decode_ms, launches_per_decode=per_decode)

    # -- 8. one train step, card against CPU (full width, f32, B=8) ------------
    # f32 on both sides; the sums run in another order (cuBLAS, the f32 paths
    # of K1, K2 and K6 against the CPU's BLAS), over up to 2880 rows and 320
    # channels. Each gradient tensor is held at 1e-3 of its largest entry
    # plus 1e-4 of the model's largest gradient: the conv biases ahead of a
    # batch-stat BN have a zero gradient in exact arithmetic, so both sides
    # hold rounding noise there, which scales with the gradients around it.
    # Once through the module blocks, once with fused_blocks=True (K6).
    nb = 8
    X8 = torch.randn(nb, T, C, generator=gen) * 10
    batch8 = {"X": X8, "Y": torch.randn(nb, T, F, generator=gen),
              "subject_idxs": torch.from_numpy(rng.integers(0, S, size=nb).astype(np.int32)),
              "scale_stats": window_scale_stats(X8.transpose(1, 2))}
    mask8 = spatial_dropout_mask(torch.Generator().manual_seed(args.seed), loc, 0.1)
    for fused in (False, True):
        label = "fused train step" if fused else "train step"
        pair = []
        for device in ("cpu", "cuda"):
            enc = BrainEncoder(compute_dtype=f32, channels_last_io=True,
                               generator=torch.Generator().manual_seed(args.seed + 2), **enc_kw)
            st = create_train_state(enc, device=device)
            bt = {k: v if k == "subject_idxs" else v.to(st.device) for k, v in batch8.items()}
            t = time.perf_counter()
            st, m = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused)(st, bt, drop_mask=mask8)
            torch.cuda.synchronize()
            pair.append((st, m, time.perf_counter() - t))
        (cpu_st, cpu_m, cpu_s), (gpu_st, gpu_m, gpu_s) = pair
        compare(f"{label} f32 B=8 loss, card vs CPU", gpu_m["loss"].cpu(), cpu_m["loss"], 0.0, 1e-4)
        compare(f"{label} f32 B=8 temperature, card vs CPU", gpu_m["temp"].cpu(), cpu_m["temp"], 0.0, 1e-6)
        cpu_grads = {n: p.grad for n, p in cpu_st.encoder.named_parameters()}
        cpu_grads["clip.temp"] = cpu_st.clip.temp.grad
        gpu_grads = {n: p.grad for n, p in gpu_st.encoder.named_parameters()}
        gpu_grads["clip.temp"] = gpu_st.clip.temp.grad
        gmax = max(float(g.abs().max()) for g in cpu_grads.values())
        worst = (0.0, "")
        for name, want in cpu_grads.items():
            got = gpu_grads[name].cpu()
            bound = 1e-3 * float(want.abs().max()) + 1e-4 * gmax
            excess = float((got - want).abs().max()) / bound
            worst = max(worst, (excess, name))
            if not (bool(torch.isfinite(got).all()) and excess <= 1.0):
                raise AssertionError(f"{label} gradient {name}: card vs CPU off by {excess:.3g}x the bound")
        emit(check=f"{label} f32 B=8 gradients, card vs CPU", tensors=len(cpu_grads), largest_gradient=gmax,
             worst_tensor=worst[1], worst_error_over_bound=worst[0],
             bound="1e-3 * max|g| of the tensor + 1e-4 * max|g| of the model")
        cpu_bufs = dict(cpu_st.encoder.named_buffers())
        stats_err = 0.0
        for name, got in gpu_st.encoder.named_buffers():
            if name.endswith(("mean", "var")):
                stats_err = max(stats_err, compare(name, got.cpu(), cpu_bufs[name], 1e-5, 1e-4, show=False))
        emit(check=f"{label} f32 B=8 BN running stats, card vs CPU", max_abs_err=stats_err, atol=1e-5,
             rtol=1e-4, cpu_seconds=cpu_s, card_seconds_first_step=gpu_s)
        del pair, cpu_st, gpu_st

    # -- 8b-8d. the data-preparation path, before any profiler trace slows the host
    prep_paths = data_prep_phases(args.seed, decoder, T, reset_counts, read_counts, expect)

    # -- 8e. the CLI at the flagship: build, device-resident and host-batch runs, evaluate
    cli_paths = cli_phase(args.seed, reset_counts, read_counts, expect)

    # -- 9. the train paths: the flagship step --------------------------------
    Xt = torch.randn(B, T, C, generator=gdev, device=dev) * 10
    batch = {"X": Xt, "Y": torch.randn(B, T, F, generator=gdev, device=dev),
             "subject_idxs": torch.from_numpy(rng.integers(0, S, size=B).astype(np.int32)),  # host ids
             "scale_stats": window_scale_stats(Xt.transpose(1, 2))}
    drop_gen = torch.Generator().manual_seed(args.seed)

    def drop(state):
        # the mask the encoder would draw from drop_gen, passed in: the module
        # paths then replay the step's CUDA graph from its second call on
        return spatial_dropout_mask(drop_gen, state.encoder.loc, state.encoder.d_drop)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def flagship_state(impl):
        cfg_ = load_config(None, ["tpu.compute_dtype=bfloat16", f"tpu.conv_impl={impl}", "tpu.channels_last_io=true"])
        enc_ = BrainEncoder.from_config(cfg_, loc, num_subjects=S,
                                        generator=torch.Generator().manual_seed(args.seed + 3))
        if (enc_.D1, enc_.D2, enc_.F, enc_.K, enc_.compute_dtype) != (D1, D2, F, K, bf16):
            raise AssertionError("the config does not give the flagship encoder")
        return cfg_, enc_, create_train_state(enc_, device="cuda")

    def run_steps(step, state, n):
        """n steps timed by CUDA events and the host clock, all launch
        counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        losses = []
        t = time.perf_counter()
        start.record()
        for _ in range(n):
            state, m = step(state, batch, drop_mask=drop(state))
            losses.append(m["loss"])
        end.record()
        torch.cuda.synchronize()
        return m, losses, start.elapsed_time(end) / n, (time.perf_counter() - t) / n * 1e3, read_counts()

    def profile_steps(step, state, ms, phase):
        """Where the step's time goes: device time of every kernel over 3
        more steps under torch.profiler (the profiler's own cost stretches
        the host side, so the idle share is taken against the unprofiled
        step time), all launch counters set to 0 just before. Returns the
        hand-written kernels' CUDA records a step, by counter, and the
        counters' reading."""
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(state, batch, drop_mask=drop(state))
            torch.cuda.synchronize()
        counters = read_counts()
        by_name = {}
        for e in prof.events():
            # kernels and copies; a user annotation (Optimizer.step's range) spans kernels already counted
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy_ms = sum(us for _, us in by_name.values()) / 3e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        traced = bool(by_name)  # the profiler saw device activity
        records = expect()
        for name, (n, _) in by_name.items():
            for counter, pattern in KERNEL_RECORDS.items():
                if pattern.search(name):
                    records[counter] += n / 3
        emit(profile=f"{phase}: flagship train step, torch.profiler over 3 steps",
             device_busy_ms_per_step=busy_ms if traced else "not measured",
             device_idle_share=1 - busy_ms / ms if traced else "not measured",
             device_ops_per_step=sum(n for n, _ in by_name.values()) / 3,
             kernel_records_per_step={k: v for k, v in records.items() if v},
             top_kernels_ms_per_step={name[:80]: us / 3e3 for name, (_, us) in top})
        return records, counters

    step_ms = {}  # the phase-9 paths' ms per step, beside which phase 15 prints its own

    def train_path(phase, impl, fused, n_steps, expected, profiled):
        cfg_, enc_, state_ = flagship_state(impl)
        step_ = make_train_step(collate=FLAGSHIP_COLLATE, fused_blocks=fused)
        warm = []
        for _ in range(3):  # warm-up: cuBLAS heuristics, first launches, the graph's capture
            state_, m = step_(state_, batch, drop_mask=drop(state_))
            warm.append(m["loss"])
        replays = step_.replays
        m, losses, ms, host_ms, launches = run_steps(step_, state_, n_steps)
        replayed = step_.replays - replays  # timed steps that replayed the graph
        step_ms[phase] = {"cuda_events": ms, "host_clock": host_ms}
        losses = torch.stack(warm + losses).tolist()
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite {phase} loss: {losses}")
        # the module paths replay a graph from the warm-up's second step on,
        # K6's path runs eagerly
        if (step_.captures, replayed) != ((0, 0) if fused else (1, n_steps)):
            raise AssertionError(f"{phase}: {step_.captures} graph captures, {replayed} timed replays")
        if replayed:
            # a replay launches nothing from the host, so the counters read 0
            # and its launches are the CUDA kernel records of profiled replays
            if launches != expect():
                raise AssertionError(f"{phase}: the counters saw launches in replayed steps: {launches}")
            per_step_, profiled_counts = profile_steps(step_, state_, ms, phase)
            if profiled_counts != expect():
                raise AssertionError(f"{phase}: the counters saw launches in profiled replays: {profiled_counts}")
        else:
            per_step_ = {k: v / n_steps for k, v in launches.items()}
            if profiled:
                profile_steps(step_, state_, ms, phase)
        emit(phase=phase, config="flagship: B=64 C=208 T=360 D1=270 D2=320 F=1024 K=32 S=27, bf16, "
             f"channels-last, precomputed collate stats, conv_impl={impl}" + (", fused_blocks" if fused else ""),
             warmup_steps=3, steps=n_steps, ms_per_step_cuda_events=ms, ms_per_step_host_clock=host_ms,
             steps_per_s=1e3 / host_ms, launches=launches, launches_per_step=per_step_,
             launches_per_step_from="CUDA kernel records of 3 profiled replays" if replayed else "the counters",
             graph_captures=step_.captures, graph_replays=step_.replays,
             loss_first=losses[0], loss_last=losses[-1], losses=losses, temp=float(m["temp"]))
        if per_step_ != expected:
            raise AssertionError(f"launches per {phase} step: {per_step_}, expected {expected}")
        return cfg_, enc_, step_, state_, launches, per_step_

    cfg, enc_t, step, state, train_launches, per_step = train_path(
        "train", "gemm_pdw", False, 20,
        expect(subject_matmul=2, tap_conv_dw=15, batchnorm_gelu=BN_STEP, glu=GLU_STEP), True)

    # -- 9b. the fused train path (K6) ------------------------------------------
    k6_step = dict(F1=5, F2=5, F3=5, B1=5, B2=5, B3=5)
    _, _, fstep, fstate, fused_launches, fused_per_step = train_path(
        "fused_train", "gemm_pdw", True, 20, expect(subject_matmul=2, tap_conv_dw=15, **k6_step), True)
    # the module step and the fused step in turns, in this call
    turns = {"module": [], "fused": []}
    for name in ("module", "fused", "fused", "module"):
        _, _, ms, host_ms, _ = run_steps(*((step, state) if name == "module" else (fstep, fstate)), 10)
        turns[name].append({"cuda_events_ms": ms, "host_clock_ms": host_ms})
    emit(timing="flagship train step: module blocks vs fused blocks (K6), turns of 10 steps", turns=turns,
         module_ms_per_step=sum(x["cuda_events_ms"] for x in turns["module"]) / 2,
         fused_ms_per_step=sum(x["cuda_events_ms"] for x in turns["fused"]) / 2)

    # -- 9c. the pallas_taps train path (K5) ---------------------------------
    cfg_taps, _, _, tstate, taps_launches, taps_per_step = train_path(
        "taps_train", "pallas_taps", False, 10,
        expect(subject_matmul=2, tap_conv_dw=15, tap_conv=30, batchnorm_gelu=BN_STEP, glu=GLU_STEP), False)

    # -- 10. the eval paths: chunked eval over 2048 segments ----------------------
    Xe = torch.randn(NE, T, C, generator=gdev, device=dev) * 10
    ebatch = {"X": Xe, "Y": torch.randn(NE, T, F, generator=gdev, device=dev),
              "subject_idxs": torch.from_numpy(rng.integers(0, S, size=NE).astype(np.int32)),
              "scale_stats": window_scale_stats(Xe.transpose(1, 2))}
    # the trainer's rule: chunks of tpu.eval_chunk_size when 0 < chunk < test set, else one eval step
    chunk = int(cfg.select("tpu.eval_chunk_size"))
    chunked = 0 < chunk < NE
    forwards = -(-NE // chunk) if chunked else 1
    eval_paths = {}
    for phase, state_, more in (("eval", state, {}), ("taps_eval", tstate, {"tap_conv": 15 * forwards})):
        evaluate = make_chunked_eval(collate=FLAGSHIP_COLLATE, chunk_size=chunk) if chunked else \
            make_eval_step(collate=FLAGSHIP_COLLATE)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        ev = {k: float(v) for k, v in evaluate(state_, ebatch).items()}
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        eval_paths[phase] = read_counts()
        emit(phase=phase, segments=NE, test_set_size="assumed (2048 segments)",
             chunk=chunk if chunked else NE, chunk_from="tpu.eval_chunk_size", forwards=forwards,
             conv_impl="pallas_taps" if more else "gemm_pdw", seconds_host_clock=eval_s,
             launches=eval_paths[phase], k3_route=retrieval_ranks.route, k3_pieces=retrieval_ranks.pieces,
             k3_depth_splits=retrieval_ranks.splits, **ev)
        if not (np.isfinite(ev["loss"]) and 0 <= ev["top1"] <= ev["top10"] <= 1):
            raise AssertionError(f"{phase} metrics out of range: {ev}")
        if (retrieval_ranks.route, retrieval_ranks.pieces) != ("wgmma", 3):  # bf16 embeddings, f32 targets
            raise AssertionError(f"{phase}: K3 took {retrieval_ranks.route} with {retrieval_ranks.pieces} pieces")
        want = expect(subject_matmul=forwards, retrieval_ranks=1, glu=GLU_FORWARD * forwards, **more)
        if eval_paths[phase] != want:
            raise AssertionError(f"{phase} launches: {eval_paths[phase]}, expected {want}")
    eval_launches = eval_paths["eval"]
    del ebatch, Xe

    # -- 11. timings of the train and eval kernels ---------------------------
    # dX as the backward runs it every step: Wᵀ's image packed from W in the
    # call (ids already on the card), then the product; the library call
    # gathers Wᵀ[sidx] from the same W
    x, w, ids = k1_inputs(B, T, D1, D1, S, bf16)
    gy = torch.randn(B, T, D1, generator=gen).to(dev, bf16)
    wT = w.transpose(1, 2)
    k1_fresh(gy, w, ids, True)
    k1b_route = subject_matmul.route
    compare("K1 dX at the flagship (timed call)", k1_fresh(gy, w, ids, True), subject_matmul_plain(gy, wT, ids),
            1e-2, 1e-2, show=False)
    k1b_ms = time_ms(lambda: k1_fresh(gy, w, ids, True))
    k1b_plain = time_ms(lambda: subject_matmul_plain(gy, wT, ids))
    k1b_lib = time_ms(lambda: torch.bmm(gy, wT[ids.long()]))

    # device times (torch.profiler) of K1 and K4, taken only now: a
    # profiler trace leaves tracing attached that slows every later launch
    # on the host, so none is taken before the train phases' timings
    k1b_dev = device_ms(lambda: k1_fresh(gy, w, ids, True))
    packT_dev = device_ms(lambda: k1_pack(w, True))
    k1b_lib_dev = device_ms(lambda: torch.bmm(gy, wT[ids.long()]))
    emit(timing="K1 backward dX (the product on g and Wᵀ, Wᵀ's image packed in the call)",
         shape=[B, T, D1, D1, S], dtype="bf16", route=k1b_route, kernel_ms=k1b_ms,
         device_ms=k1b_dev or "not measured", pct_of_bound=pct(k1b_ms), device_pct_of_bound=pct(k1b_dev),
         pack_device_ms=packT_dev or "not measured", plain_ms=k1b_plain, library_ms=k1b_lib,
         library_device_ms=k1b_lib_dev or "not measured", library="torch.bmm over Wᵀ[sidx] (the gather included)",
         bound_ms=k1_bound, bound_by=k1_by, launches_per_train_step=per_step["subject_matmul"])
    x, w, ids, ids_host = k1_args  # the forward's inputs of phase 7
    k1_dev = device_ms(lambda: subject_matmul(x, w, ids_host))
    k1_pack_dev = device_ms(lambda: k1_fresh(x, w, ids, False))
    pack_dev = device_ms(lambda: k1_pack(w, False))
    k1_lib_dev = device_ms(lambda: torch.bmm(x, w[ids.long()]))
    # the wmma body (the flagship's route before the wgmma body, kept for other shapes), called directly
    wmma_out = torch.empty_like(x)

    def k1_wmma():
        sc.LIB("subject_matmul_bf16", x.device, x, w, ids, 0, wmma_out, B, T, D1, D1)

    k1_wmma()
    compare("K1 wmma body at the flagship", wmma_out, subject_matmul_plain(x, w, ids),
            1e-2, 1e-2, show=False)
    k1_wmma_dev = device_ms(k1_wmma)
    emit(timing="K1 subject_matmul on the device (the inputs of phase 7's line)", shape=[B, T, D1, D1, S],
         dtype="bf16", device_ms=k1_dev or "not measured", device_pct_of_bound=pct(k1_dev),
         with_pack_device_ms=k1_pack_dev or "not measured", pack_device_ms=pack_dev or "not measured",
         library_device_ms=k1_lib_dev or "not measured", wmma_body_device_ms=k1_wmma_dev or "not measured",
         wmma_body="the flagship's route before the wgmma body, called directly on the same inputs",
         bound_ms=k1_bound, bound_by=k1_by)
    k4_dev, k4_mod_dev = [], []
    for k in range(5):
        x = torch.randn(B, T, D1 if k == 0 else D2, generator=gen).to(dev, bf16)
        blk = enc16.conv_blocks[k]
        k4_dev.append(device_ms(lambda: conv_block_fused(x, *staged16[k], k=k)))
        with torch.inference_mode():
            k4_mod_dev.append(device_ms(lambda: blk(x)))
    k4["device_ms"] = sum(k4_dev) if all(k4_dev) else None
    k4["module_device_ms"] = sum(k4_mod_dev) if all(k4_mod_dev) else None
    emit(timing="K4 conv_block_fused on the device, blocks k=0..4", shape=[B, T, D1, D2], dtype="bf16",
         route=conv_block_fused.route, device_ms=k4_dev, total_device_ms=k4["device_ms"] or "not measured",
         device_pct_of_bound=100 * k4["bound_ms"] / k4["device_ms"] if k4["device_ms"] else "not measured",
         module_blocks_device_ms=k4_mod_dev, module_total_device_ms=k4["module_device_ms"] or "not measured",
         bound_ms=k4["bound_ms"], bound_by=k4_by)
    del x, w, gy, wT, wmma_out, k1_args

    # kernel_ms by CUDA events around back-to-back wrapper calls; device_ms the
    # same calls' kernels alone (torch.profiler durations, the wrapper's
    # operand copies included); pct_of_bound = bound / time
    traced = True
    k2 = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
          "bytes": 0.0}
    per_conv = []
    xs = {c: torch.randn(B, T, c, generator=gen).to(dev, bf16) for c in (D1, D2)}
    gs = {c: torch.randn(B, T, c, generator=gen).to(dev, bf16) for c in (D2, 2 * D2)}
    for cin, cout, d in convs:
        x, gy = xs[cin], gs[cout]
        ms = time_ms(lambda: tap_conv_dw(x, gy, d), reps=10)
        dms = device_ms(lambda: tap_conv_dw(x, gy, d))
        plain = time_ms(lambda: tap_conv_dw_plain(x, gy, d), reps=5)
        xp = torch.nn.functional.pad(x, (0, 0, d, d))
        taps = [xp[:, j * d : j * d + T].reshape(B * T, cin) for j in range(3)]
        gf = gy.reshape(B * T, cout)
        lib = time_ms(lambda: [torch.matmul(xj.T, gf) for xj in taps], reps=10)
        flops = 2 * cin * cout * B * (T + 2 * max(T - d, 0))  # the shifted taps see T-d valid rows
        moved = nbytes(x, gy) + 3 * cin * cout * 4
        bnd, by = bound_ms(flops, moved, peaks, "bf16")
        per_conv.append({"cin": cin, "cout": cout, "d": d, "ms": ms, "device_ms": dms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bnd, "bound_by": by, "pct_of_bound": 100 * bnd / ms})
        for key, v in (("ms", ms), ("device_ms", dms or 0.0), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bnd), ("flops", flops), ("bytes", moved)):
            k2[key] += v
        traced = traced and dms is not None
    k2_by = bound_ms(k2["flops"], k2["bytes"], peaks, "bf16")[1]
    if not traced:
        k2["device_ms"] = "not measured"
    emit(timing="K2 tap_conv_dw, the 15 launches of one flagship step", dtype="bf16", B=B, T=T,
         kernel_ms=k2["ms"], device_ms=k2["device_ms"], pct_of_bound=100 * k2["bound_ms"] / k2["ms"],
         device_pct_of_bound=100 * k2["bound_ms"] / k2["device_ms"] if traced else "not measured",
         plain_ms=k2["plain_ms"], library_ms=k2["library_ms"],
         library="three torch.matmul(x_jᵀ, g) per conv (bf16 out; shifted copies made outside the timing)",
         bound_ms=k2["bound_ms"], bound_by=k2_by, tflop=k2["flops"] / 1e12, per_conv=per_conv,
         launches_per_train_step=per_step["tap_conv_dw"])
    del xs, gs, taps, xp

    # K5: the 30 launches of a pallas_taps step (each conv forward and its
    # dx), against F.conv1d on the (B, C, T) layout (transposes made outside
    # the timing; cuDNN without TF32), which must compute the same function
    k5 = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
          "bytes": 0.0}
    traced = True
    k5_per_conv, k5_lib_err = [], 0.0
    for cin, cout, d in convs:
        for form, ci, co in (("forward", cin, cout), ("dx", cout, cin)):
            # dx as the backward runs it: tap_conv_transposed(g, w) with w
            # (3, Cin, Cout) of the forward conv; wf the weights it applies
            x = torch.randn(B, T, ci, generator=gdev, device=dev).to(bf16)
            w = torch.randn(3, *((ci, co) if form == "forward" else (co, ci)), generator=gdev,
                            device=dev).div((3 * ci) ** 0.5).to(bf16)
            k5_fn = tap_conv if form == "forward" else tap_conv_transposed
            wf = w if form == "forward" else flip_taps(w)
            xc, wc = x.transpose(1, 2).contiguous(), wf.permute(2, 1, 0).contiguous()  # (B, Cin, T), (Cout, Cin, 3)
            want = tap_conv_plain(x, wf, d)
            lib_y = Fn.conv1d(xc, wc, dilation=d, padding=d).transpose(1, 2)
            k5_lib_err = max(k5_lib_err, compare(f"F.conv1d d={d}", lib_y, want, 1e-2 * float(want.abs().max()),
                                                 1e-2, show=False))
            ms = time_ms(lambda: k5_fn(x, w, d), reps=10)
            dms = device_ms(lambda: k5_fn(x, w, d))
            plain = time_ms(lambda: tap_conv_plain(x, wf, d), reps=5)
            lib = time_ms(lambda: Fn.conv1d(xc, wc, dilation=d, padding=d), reps=10)
            flops = 2 * ci * co * B * (T + 2 * max(T - d, 0))  # the shifted taps see T-d valid rows
            moved = nbytes(x, w) + B * T * co * 2
            bnd, by = bound_ms(flops, moved, peaks, "bf16")
            k5_per_conv.append({"form": form, "cin": ci, "cout": co, "d": d, "ms": ms, "device_ms": dms,
                                "plain_ms": plain, "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                                "pct_of_bound": 100 * bnd / ms})
            for key, v in (("ms", ms), ("device_ms", dms or 0.0), ("plain_ms", plain), ("library_ms", lib),
                           ("bound_ms", bnd), ("flops", flops), ("bytes", moved)):
                k5[key] += v
            traced = traced and dms is not None
    k5_by = bound_ms(k5["flops"], k5["bytes"], peaks, "bf16")[1]
    if not traced:
        k5["device_ms"] = "not measured"
    emit(timing="K5 tap_conv, the 30 launches of one pallas_taps step (15 forward, 15 dx)", dtype="bf16", B=B, T=T,
         kernel_ms=k5["ms"], device_ms=k5["device_ms"], pct_of_bound=100 * k5["bound_ms"] / k5["ms"],
         device_pct_of_bound=100 * k5["bound_ms"] / k5["device_ms"] if traced else "not measured",
         plain_ms=k5["plain_ms"], library_ms=k5["library_ms"],
         library="F.conv1d(x (B, C, T), w (Cout, Cin, 3), dilation=d, padding=d), cuDNN, no TF32",
         library_vs_plain_max_abs_err=k5_lib_err, bound_ms=k5["bound_ms"], bound_by=k5_by,
         tflop=k5["flops"] / 1e12, per_conv=k5_per_conv, launches_per_train_step=taps_per_step["tap_conv"])
    del x, w, wf, xc, wc, want, lib_y

    # K6 per block, bf16 on the wgmma route: each stage (with its
    # reductions, weight packs and BN·GELU pass; the backward stages with
    # their K2 launch) by CUDA events and on the device, the block's six
    # stages on the device, and all of it again on the tap3 route (the
    # parent's body, TILE) on the same inputs; the plain stages; the module
    # ConvBlock's train forward and forward+backward on the same shapes. At
    # k=0 the stages reuse x's 272-channel copy, as B3 reuses F1's within a
    # step, so the copy is timed apart and added to the block once (the tap3
    # route's B3 makes its own inside its K2 launch, timed with it)
    def conv_flops(ci, co, d):
        return 2 * ci * co * B * (T + 2 * max(T - d, 0))

    def tensors(v):
        return [a for a in (v if isinstance(v, tuple) else (v,)) if torch.is_tensor(a)]

    def none_sum(vals):
        return sum(vals) if all(v is not None for v in vals) else None

    k6 = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0,
          "module_ms": 0.0, "tap3_ms": 0.0, "tap3_device_ms": 0.0}
    fwd, bwd = ("F1", "F2", "F3"), ("B1", "B2", "B3")
    for k in range(5):
        cin = D1 if k == 0 else D2
        d0, d1 = dilations(k)
        ins = cbt.stage_inputs(B, T, cin, D2, k, bf16, dev, gk6)
        for st in cbt.STAGES:
            cbt.STAGES[st](*ins[st])
            new_route = cbt.conv_block_train.route
            cbt.TILE[st](*ins[st])
            if (new_route, cbt.conv_block_train.route) != ("wgmma", "tap3"):
                raise AssertionError(f"K6 timing k={k} {st}: routes {new_route}, {cbt.conv_block_train.route}")
        per_route = {}
        for route, stages in (("wgmma", cbt.STAGES), ("tap3", cbt.TILE)):
            ms = {st: time_ms(lambda st=st: stages[st](*ins[st]), reps=10) for st in stages}
            st_dev = {st: device_ms(lambda st=st: stages[st](*ins[st]), reps=5) for st in stages}
            dms = device_ms(lambda: [stages[st](*ins[st]) for st in stages])  # the block's six stages
            per_route[route] = {"forward_ms": sum(ms[s] for s in fwd), "backward_ms": sum(ms[s] for s in bwd),
                                "ms": sum(ms.values()), "per_stage_ms": ms, "per_stage_device_ms": st_dev,
                                "device_ms": dms}
        pad = {}
        if cin % 8:
            xk = ins["F1"][0]
            pad = {"x_pad_ms": time_ms(lambda: pad_channels(xk), reps=10),
                   "x_pad_device_ms": device_ms(lambda: pad_channels(xk), reps=5)}
        plain = {st: time_ms(lambda st=st: cbt.PLAIN[st](*ins[st]), reps=3) for st in cbt.STAGES}
        flops = {"F1": conv_flops(cin, D2, d0), "F2": conv_flops(D2, D2, d1), "F3": conv_flops(D2, 2 * D2, 2),
                 "B1": 3 * conv_flops(D2, 2 * D2, 2), "B2": 2 * conv_flops(D2, D2, d1),
                 "B3": 2 * conv_flops(cin, D2, d0)}
        moved = {st: nbytes(*tensors(ins[st]), *tensors(cbt.STAGES[st](*ins[st]))) for st in cbt.STAGES}
        bounds = {st: bound_ms(flops[st], moved[st], peaks, "bf16") for st in cbt.STAGES}
        blk = enc_t.conv_blocks[k]
        xm = torch.randn(B, T, cin, generator=gdev, device=dev).to(bf16).requires_grad_()
        gm = torch.randn(B, T, D2, generator=gdev, device=dev).to(bf16)
        mod_f = time_ms(lambda: blk(xm, train=True), reps=10)
        mod_fb = time_ms(lambda: blk(xm, train=True).backward(gm), reps=10)
        new, old = per_route["wgmma"], per_route["tap3"]
        blk_ms = new["ms"] + pad.get("x_pad_ms", 0.0)
        blk_dev = none_sum([new["device_ms"], pad.get("x_pad_device_ms", 0.0)])
        bound_blk = sum(b[0] for b in bounds.values())
        emit(timing=f"K6 conv_block_train k={k}", shape=[B, T, cin, D2], dtype="bf16", route="wgmma",
             forward_ms=new["forward_ms"], backward_ms=new["backward_ms"], per_stage_ms=new["per_stage_ms"],
             per_stage_device_ms={s: v or "not measured" for s, v in new["per_stage_device_ms"].items()},
             device_ms=new["device_ms"] or "not measured", **pad,
             block_ms=blk_ms, block_device_ms=blk_dev or "not measured",
             block_device_pct_of_bound=100 * bound_blk / blk_dev if blk_dev else "not measured",
             tap3_route={**{key: old[key] for key in ("forward_ms", "backward_ms", "per_stage_ms")},
                         "per_stage_device_ms": {s: v or "not measured" for s, v in old["per_stage_device_ms"].items()},
                         "device_ms": old["device_ms"] or "not measured",
                         "what": "the parent's body, cbt.TILE, on the same inputs in this call"},
             device_speedup=old["device_ms"] / blk_dev if blk_dev and old["device_ms"] else "not measured",
             plain_forward_ms=sum(plain[s] for s in fwd), plain_backward_ms=sum(plain[s] for s in bwd),
             bound_forward_ms=sum(bounds[s][0] for s in fwd), bound_backward_ms=sum(bounds[s][0] for s in bwd),
             per_stage_bound={s: {"ms": b[0], "by": b[1], "gflop": flops[s] / 1e9, "mbytes": moved[s] / 1e6}
                              for s, b in bounds.items()},
             module_forward_ms=mod_f, module_forward_backward_ms=mod_fb,
             module_backward_ms_by_subtraction=mod_fb - mod_f, library_ms=None,
             library="none: no single PyTorch call computes a ConvBlock; the module ConvBlock is beside it")
        k6["ms"] += blk_ms
        k6["device_ms"] = none_sum([k6["device_ms"], blk_dev])
        k6["tap3_ms"] += old["ms"]
        k6["tap3_device_ms"] = none_sum([k6["tap3_device_ms"], old["device_ms"]])
        k6["plain_ms"] += sum(plain.values())
        k6["bound_ms"] += bound_blk
        k6["flops"] += sum(flops.values())
        k6["bytes"] += sum(moved.values())
        k6["module_ms"] += mod_fb
    k6_by = bound_ms(k6["flops"], k6["bytes"], peaks, "bf16")[1]
    emit(timing="K6 conv_block_train, five blocks forward and backward (one fused step's)", dtype="bf16",
         route="wgmma", kernel_ms=k6["ms"], device_ms=k6["device_ms"] or "not measured",
         tap3_route_ms=k6["tap3_ms"], tap3_route_device_ms=k6["tap3_device_ms"] or "not measured",
         bound_ms=k6["bound_ms"], bound_by=k6_by, pct_of_bound=100 * k6["bound_ms"] / k6["ms"],
         device_pct_of_bound=100 * k6["bound_ms"] / k6["device_ms"] if k6["device_ms"] else "not measured",
         tap3_device_pct_of_bound=(100 * k6["bound_ms"] / k6["tap3_device_ms"] if k6["tap3_device_ms"]
                                   else "not measured"),
         plain_ms=k6["plain_ms"], module_blocks_ms=k6["module_ms"])
    del ins, xm, gm

    # K3 at the eval's B=2048 and the Trainer's B=64, Z bf16, Y f32. kernel_ms
    # and library_ms include their preparation (the new body's one-pass
    # split, norms and diagonal; the library's cast to f32, norms and
    # diagonal); prep_ms and products_ms split the new body, *_alone the
    # library. f32_body_ms is the f32 CUDA-core body, the parent's route for
    # these inputs, with its own preparation (and alone). bound_ms: the three
    # bf16 products at the bf16 peak against y and z read once, ranks written
    # once; f32_cuda_core_bound_ms the same products once at the f32 peak of
    # the CUDA cores; prep_bytes_bound_ms the preparation's bytes (y and z
    # read, three pieces written)
    eps = 1e-8

    def k3_library(prepared):
        y, z, ny, nz, diag = prepared
        return ((torch.matmul(y, z.T) / torch.clamp_min(ny[:, None] * nz[None, :], eps)) > diag[:, None]).sum(1)

    k3 = {}
    for b_, reps in ((NE, 3), (64, 20)):
        Z, Y = k3_inputs(b_, F * T)
        ms = time_ms(lambda: retrieval_ranks(Z, Y), reps=reps, warmup=1)
        if retrieval_ranks.route != "wgmma":
            raise AssertionError(f"K3 timing at B={b_} took {retrieval_ranks.route}")
        splits = retrieval_ranks.splits
        dev_ms = device_ms(lambda: retrieval_ranks(Z, Y), reps=3)
        plain = time_ms(lambda: retrieval_ranks_plain(Z, Y), reps=3, warmup=1)
        lib = time_ms(lambda: k3_library(k3_module._prepare(Z, Y, eps)), reps=3, warmup=1)
        lib_dev = device_ms(lambda: k3_library(k3_module._prepare(Z, Y, eps)), reps=3)
        prep_ms = time_ms(lambda: k3_module._prep(Z, Y, eps), reps=reps, warmup=1)
        prep_dev = device_ms(lambda: k3_module._prep(Z, Y, eps), reps=3)
        pieces, ny, nz, diag = k3_module._prep(Z, Y, eps)
        prod_ms = time_ms(lambda: k3_module._products(pieces, Z, ny, nz, diag, eps), reps=reps, warmup=1)
        prod_dev = device_ms(lambda: k3_module._products(pieces, Z, ny, nz, diag, eps), reps=3)
        del pieces
        prepared = k3_module._prepare(Z, Y, eps)
        lib_alone = time_ms(lambda: k3_library(prepared), reps=3, warmup=1)
        old_alone = time_ms(lambda: k3_module._ranks_kernel(*prepared, eps), reps=3, warmup=1)
        del prepared
        old = time_ms(lambda: k3_module._ranks_kernel(*k3_module._prepare(Z, Y, eps), eps), reps=3, warmup=1)
        old_dev = device_ms(lambda: k3_module._ranks_kernel(*k3_module._prepare(Z, Y, eps), eps), reps=3)
        moved = nbytes(Z, Y) + b_ * 4
        bound, by = bound_ms(3 * 2 * b_ * b_ * F * T, moved, peaks, "bf16")
        k3[b_] = dict(
            shape=[b_, F * T], dtype="Z bf16, Y f32 (three bf16 pieces)", route="wgmma", depth_splits=splits,
            kernel_ms=ms, device_ms=dev_ms or "not measured", plain_ms=plain, library_ms=lib,
            library_device_ms=lib_dev or "not measured",
            library="torch.matmul(y, z.T) in f32 plus the compare-and-count, after its preparation",
            prep_ms=prep_ms, prep_device_ms=prep_dev or "not measured", products_ms=prod_ms,
            products_device_ms=prod_dev or "not measured", library_alone_ms=lib_alone,
            f32_body_ms=old, f32_body_device_ms=old_dev or "not measured", f32_body_alone_ms=old_alone,
            bound_ms=bound, bound_by=by,
            f32_cuda_core_bound_ms=bound_ms(2 * b_ * b_ * F * T, moved, peaks, "f32")[0],
            prep_bytes_bound_ms=(nbytes(Z, Y) + 3 * b_ * F * T * 2) / peaks["bytes"] * 1e3,
            pct_of_bound=100 * bound / ms, device_pct_of_bound=100 * bound / dev_ms if dev_ms else "not measured")
        emit(timing=f"K3 retrieval_ranks B={b_}", **k3[b_],
             launches_per_eval=eval_launches["retrieval_ranks"] if b_ == NE else "1 a Trainer eval")
        del Z, Y

    # -- 12. the K7 tool path: the port's bench_cross_block_merge --------------------
    # for every boundary (k_next 1..4): its equivalence checks and its timings
    # by CUDA events (the tap3 pair F3 + F1, f31_tile's bitwise partner; the
    # wgmma pair, f31's bitwise partner and yardstick; f31_tile; f31, the
    # best of 3 rounds of 50); the counters span the four runs. Then each of
    # the four on the device alone, and f31's waits on its ready counters
    torch.cuda.synchronize()
    reset_counts()
    tools = {k_next: merge_tool.run("cuda", k_next) for k_next in range(1, 5)}
    tool_launches = read_counts()
    if min(tool_launches[f"conv_block_train.{st}"]
           for st in ("F31", "F31_tile", "F3", "F1", "F3_tile", "F1_tile")) < 1:
        raise AssertionError(f"a kernel of the tool path never launched: {tool_launches}")
    if any(tool["route"] != "wgmma" for tool in tools.values()):
        raise AssertionError(f"the tool's f31 took {[tool['route'] for tool in tools.values()]}, not wgmma")
    sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                  capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    x7 = merge_tool.make_inputs(B, T, D2, bf16, dev)
    k7 = {}
    for k_next, tool in tools.items():
        args7 = (x7["y1"], x7["mi1"], x7["gb1"], x7["w2"], x7["b2"], x7["w0n"], x7["b0n"], k_next)
        pair_dev = {name: device_ms(lambda f3=f3, f1=f1: f1(f3(*args7[:5]), args7[5], args7[6], k_next))
                    for name, f3, f1 in (("tap3", cbt.f3_tile, cbt.f1_tile), ("wgmma", cbt.f3, cbt.f1))}
        merged_dev, tile_dev = device_ms(lambda: cbt.f31(*args7)), device_ms(lambda: cbt.f31_tile(*args7))
        flops = conv_flops(D2, 2 * D2, 2) + conv_flops(D2, D2, tool["d0n"])
        moved = nbytes(*args7[:7]) + 2 * B * T * D2 * 2 + 2 * D2 * 4
        bnd, by = bound_ms(flops, moved, peaks, "bf16")
        waits = tool["ready_waits"]
        k7[k_next] = dict(
            k_next=k_next, d0n=tool["d0n"], route=tool["route"], merged_ms=tool["merged_ms"],
            merged_device_ms=merged_dev or "not measured", pair_ms=tool["pair_ms"],
            wgmma_pair_device_ms=pair_dev["wgmma"] or "not measured", merged_tap3_ms=tool["merged_tap3_ms"],
            merged_tap3_device_ms=tile_dev or "not measured", split_ms=tool["split_ms"],
            tap3_pair_device_ms=pair_dev["tap3"] or "not measured",
            plain_ms=time_ms(lambda: cbt.f31_plain(*args7), reps=5), bound_ms=bnd, bound_by=by,
            pct_of_bound=100 * bnd / tool["merged_ms"],
            device_pct_of_bound=100 * bnd / merged_dev if merged_dev else "not measured",
            gflop=flops / 1e9, mbytes=moved / 1e6, vs_plain_max_abs_err=tool["vs_plain_max_abs_err"],
            saving_us_per_boundary=tool["saving_us_per_boundary"], ready_waits=waits["waits"],
            ready_wait_cycles=waits["wait_cycles"], ready_claims=waits["claims"],
            ready_wait_ms_summed_over_blocks=waits["wait_cycles"] / (sm_mhz * 1e3),
            ready_wait_clock=f"clock64 cycles of the producers' polls at the {sm_mhz:.0f} MHz maximum SM clock",
            bitwise_equal_to_pair=tool["out_y0n_bitwise_equal"] and tool["s0n_bitwise_equal"],
            tile_out_y0n_bitwise_equal=tool["tile_out_y0n_bitwise_equal"],
            tile_s0n_bitwise_equal=tool["tile_s0n_bitwise_equal"])
        emit(tool="speech_decoding_tpu_torch.tools.bench_cross_block_merge", shape=tool["shape"],
             dtype=tool["dtype"], **k7[k_next], **({"launches": tool_launches} if k_next == 1 else {}),
             timing=tool["timing"])
    del x7, args7

    # -- 12b. BN: the port's bench_batchnorm_gelu ----------------------------------------------
    # one layer of train-mode BatchNorm + GELU at the benchmark cell's shape, with and without
    # the residual input: h, the running statistics, dy, dscale and dbias against the plain
    # version (raises past the card tests' tolerances), then the kernels' ms by CUDA events and
    # on the device (each kernel apart) beside the bound and the plain version's eager chain
    torch.cuda.synchronize()
    reset_counts()
    bn = bn_tool.run("cuda")
    bn_launches = read_counts()
    bn_runs = ("with_skip", "without_skip")
    emit(tool="speech_decoding_tpu_torch.tools.bench_batchnorm_gelu", **bn, launches=bn_launches)
    if bn_launches != expect(batchnorm_gelu=bn_launches["batchnorm_gelu"]) or bn_launches["batchnorm_gelu"] < 1:
        raise AssertionError(f"the BN tool launched other kernels or none of its own: {bn_launches}")

    # -- 12c. GLU: the port's bench_glu ----------------------------------------------------------
    # one ConvBlock's GLU at the benchmark cell's shape: h and dY against the f32 formulas within
    # one bf16 rounding (raises past it), then the op's forward and backward by CUDA events and on
    # the device (each kernel apart) beside the bound (0.141 ms), the plain chain's same two times and
    # the library's (torch.nn.functional.glu: ATen's glu and glu_backward)
    torch.cuda.synchronize()
    reset_counts()
    glu_run = glu_tool.run("cuda")
    glu_launches = read_counts()
    emit(tool="speech_decoding_tpu_torch.tools.bench_glu", **glu_run, launches=glu_launches)
    if glu_launches != expect(glu=glu_launches["glu"]) or glu_launches["glu"] < 1 or glu_run["launches_a_block"] != 2:
        raise AssertionError(f"the GLU tool launched other kernels or not its own two a block: {glu_launches}, "
                             f"{glu_run['launches_a_block']} a block")

    # -- 13. the training loop: the port's scale run at the flagship ---------------------
    # Trainer.run_epoch over a device-resident world (scan_steps 8), eval of
    # the 64 held-out segments every epoch, checkpoints in a temporary
    # directory (keep 2, best by testTop10acc); the learning gate of
    # tests/test_learning_gate.py must clear
    SR_EPOCHS, SR_UPDATES, SR_POOL = 4, 100, 512
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_checkpoints_")
    try:
        world = scale_run.World(SR_POOL, scale_run.FLAGSHIP, dev, args.seed)
        ckpts = CheckpointManager(os.path.join(ckdir, "run"), keep=2, track_metric="testTop10acc")
        torch.cuda.synchronize()
        reset_counts()
        summary, trainer, _ = scale_run.run(SR_EPOCHS, SR_UPDATES, SR_POOL, device="cuda", checkpoints=ckpts,
                                            world=world, seed=args.seed)
        torch.cuda.synchronize()
        trainer_launches = read_counts()
        steps = SR_EPOCHS * SR_UPDATES
        hist = trainer.history
        emit(phase="trainer", tool="speech_decoding_tpu_torch.tools.scale_run",
             config="flagship: B=64 C=208 T=360 D1=270 D2=320 F=1024 K=32 S=27, bf16, channels-last, "
                    "conv_impl=gemm_pdw, scan_steps 8, lr 3e-4, device-resident pool",
             epochs=SR_EPOCHS, updates=SR_UPDATES, train_pool=SR_POOL, test_segments=scale_run.N_TEST,
             steps=trainer.state.step, steady_steps_per_s=summary["steady_steps_per_sec"],
             steady_segments_per_s=summary["steady_segments_per_sec"],
             segments_per_s_by_epoch=[h["train_segments_per_sec"] for h in hist],
             epoch_seconds_host_clock=summary["epoch_seconds"], last_epoch_seconds=trainer.last_epoch_seconds,
             train_loss=[h["train_loss"] for h in hist], testTop10acc=[h["testTop10acc"] for h in hist],
             chance_top10=summary["chance_top10"], gate=summary["gate"], wall_s=summary["wall_s"],
             checkpoints={"latest": ckpts.latest_epoch(), "best": ckpts.best_epoch()}, launches=trainer_launches,
             k3_route=retrieval_ranks.route, k3_pieces=retrieval_ranks.pieces, k3_depth_splits=retrieval_ranks.splits)
        # the evals of 64 held-out segments: bf16 embeddings against the world's bf16 targets
        if (retrieval_ranks.route, retrieval_ranks.pieces) != ("wgmma", 1) or retrieval_ranks.splits < 2:
            raise AssertionError(f"trainer: K3 took {retrieval_ranks.route}, {retrieval_ranks.pieces} pieces, "
                                 f"{retrieval_ranks.splits} depth slices")
        # the module step replays its graph from its second call on
        launched = launched_steps(steps, [trainer.train_step])
        want = expect(subject_matmul=2 * launched + SR_EPOCHS, tap_conv_dw=15 * launched, retrieval_ranks=SR_EPOCHS,
                      batchnorm_gelu=BN_STEP * launched, glu=GLU_STEP * launched + GLU_FORWARD * SR_EPOCHS)
        if launched != 2 or trainer_launches != want:
            raise AssertionError(f"trainer launches: {trainer_launches} in {launched} launched steps, "
                                 f"expected {want}")
        if not all(summary["gate"].values()) or not all(np.isfinite([h["train_loss"] for h in hist])):
            raise AssertionError(f"the scale run did not learn: {summary['gate']}, {[h['train_loss'] for h in hist]}")

        # -- 13b. the fused Trainer (tpu.fused_train_blocks=true reaches K6) ------------
        # one short epoch of host batches (numpy, f32), which the Trainer
        # moves through pinned memory, one step a dispatch
        host = []
        for i in range(4):
            b_ = world.batch(np.random.default_rng(10 + i).choice(SR_POOL, B, replace=False))
            host.append({k: v.float().cpu().numpy() if v.is_floating_point() else v.numpy() for k, v in b_.items()})
        args_f = scale_run.flagship_args(1, ["tpu.fused_train_blocks=true", "tpu.scan_steps=1"])
        fused_tr = Trainer(scale_run.make_encoder(args_f, scale_run.FLAGSHIP, args.seed + 1), args_f, device="cuda")
        n_fused = 12
        torch.cuda.synchronize()
        reset_counts()
        out_f = fused_tr.run_epoch(0, [host[i % 4] for i in range(n_fused)], world.test_batch())
        torch.cuda.synchronize()
        fused_trainer_launches = read_counts()
        emit(phase="trainer_fused", steps=fused_tr.state.step, host_batches="numpy f32, pinned, non_blocking",
             train_loss=out_f["train_loss"], testTop10acc=out_f["testTop10acc"],
             segments_per_s=out_f["train_segments_per_sec"], epoch_seconds=fused_tr.last_epoch_seconds,
             launches=fused_trainer_launches)
        want = expect(subject_matmul=2 * n_fused + 1, tap_conv_dw=15 * n_fused, retrieval_ranks=1, glu=GLU_FORWARD,
                      **dict.fromkeys(cbt.STAGES, 5 * n_fused))
        if fused_trainer_launches != want or not np.isfinite(out_f["train_loss"]):
            raise AssertionError(f"trainer_fused launches: {fused_trainer_launches}, expected {want}; {out_f}")
        del host, fused_tr

        # -- 13c. the preemption drill ---------------------------------------------
        # a real SIGTERM after 2 dispatches (16 steps) of a 24-step epoch: the
        # epoch stops, eval is skipped, the state is saved; a fresh Trainer
        # resumes it bit for bit and runs one more epoch to its end
        args_p = scale_run.flagship_args(2)
        ck_p = CheckpointManager(os.path.join(ckdir, "preempt"), keep=2)
        pre_tr = Trainer(scale_run.make_encoder(args_p, scale_run.FLAGSHIP, args.seed + 2), args_p,
                         checkpoints=ck_p, device="cuda")
        handler = signal.getsignal(signal.SIGTERM)
        rng_p = np.random.default_rng(2)
        torch.cuda.synchronize()
        reset_counts()
        pre_tr.preemption = PreemptionGuard(inject_after_steps=2).install()
        try:
            out_p = pre_tr.run_epoch(0, world.train_batches(rng_p, 24), world.test_batch())
        finally:
            pre_tr.preemption.uninstall()
        if not (pre_tr.preempted and "test_loss" not in out_p and pre_tr.state.step == 16
                and ck_p.latest_epoch() == 0 and signal.getsignal(signal.SIGTERM) is handler):
            raise AssertionError(f"preemption: step {pre_tr.state.step}, saved {ck_p.latest_epoch()}, {out_p}")
        res_tr = Trainer(scale_run.make_encoder(args_p, scale_run.FLAGSHIP, args.seed + 3), args_p,
                         checkpoints=ck_p, device="cuda")
        a_, b_ = pre_tr.state, res_tr.state
        sa, sb = a_.optimizer.state_dict()["state"], b_.optimizer.state_dict()["state"]
        same = {
            "step": a_.step == b_.step and res_tr.start_epoch == 1,
            "parameters_and_bn_statistics": all(torch.equal(x, y) for x, y in
                                                zip(a_.encoder.state_dict().values(), b_.encoder.state_dict().values())),
            "temperature": torch.equal(a_.clip.temp, b_.clip.temp),
            "adam_moments": sa.keys() == sb.keys() and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]),
        }
        if not all(same.values()):
            raise AssertionError(f"the resumed state differs from the preempted one: {same}")
        out_r = res_tr.run_epoch(1, world.train_batches(rng_p, 24), world.test_batch())
        torch.cuda.synchronize()
        preempt_launches = read_counts()
        emit(phase="preemption", signal="SIGTERM from PreemptionGuard(inject_after_steps=2) after 2 dispatches",
             stopped_at_step=16, checkpoint_epoch=0, resumed_start_epoch=res_tr.start_epoch, bitwise_equal=same,
             resumed_epoch_steps=res_tr.state.step - 16, resumed_train_loss=out_r["train_loss"],
             resumed_testTop10acc=out_r["testTop10acc"], launches=preempt_launches)
        # each Trainer's module step replays its graph from its second call on
        launched = launched_steps(16 + 24, [pre_tr.train_step, res_tr.train_step])
        want = expect(subject_matmul=2 * launched + 1, tap_conv_dw=15 * launched, retrieval_ranks=1,
                      batchnorm_gelu=BN_STEP * launched, glu=GLU_STEP * launched + GLU_FORWARD)
        if (launched != 4 or preempt_launches != want or res_tr.state.step != 40
                or not np.isfinite(out_r["train_loss"])):
            raise AssertionError(f"preemption launches {preempt_launches} in {launched} launched steps, expected "
                                 f"{want}; step {res_tr.state.step}")
        del pre_tr, res_tr, a_, b_, sa, sb

        # -- 13d. serving the best checkpoint -----------------------------------------
        # SpeechDecoder.from_checkpoint(best=True) on the scale run's
        # checkpoints, a bank of the 64 held-out Y, the 64 held-out X decoded
        # through the serving path (K1 and K4). The trainer's testTop10acc
        # ranks brain embeddings per audio segment; a decode ranks the bank
        # per brain segment. So the served hit rate is held, within 2/64 (a
        # near-tie may flip between the module and the K4 encode in bf16),
        # against the same orientation computed through the eval path from
        # the same checkpoint, and its gap to testTop10acc is reported
        test = world.test_batch()
        best = ckpts.best_epoch()
        best_top10 = trainer.history[best]["testTop10acc"]
        args_s = scale_run.flagship_args(1)
        decoder = SpeechDecoder.from_checkpoint(
            ckpts.directory, scale_run.make_encoder(args_s, scale_run.FLAGSHIP, args.seed + 4),
            bank=test["Y"].transpose(1, 2).float(), best=True, device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        _, ids_served = decoder.decode(test["X"], test["subject_idxs"], k=10)
        serve_ck_launches = read_counts()
        served = float(np.mean([i in row for i, row in enumerate(ids_served)]))
        st_eval = create_train_state(scale_run.make_encoder(args_s, scale_run.FLAGSHIP, args.seed + 5),
                                     device="cuda")
        st_eval, _ = ckpts.restore_for_eval(st_eval, best=True)
        ev = {k: float(v) for k, v in make_eval_step()(st_eval, test).items()}
        with torch.no_grad():
            Z_eval = st_eval.encoder(test["X"], test["subject_idxs"])
        _, eval_brain_to_audio = retrieval_metrics_kernel(test["Y"], Z_eval, ks=(1, 10))
        eval_brain_to_audio = float(eval_brain_to_audio)
        emit(phase="checkpoint_serve", best_epoch=best, checkpoint_testTop10acc=best_top10,
             eval_path_testTop10acc=ev["top10"], served_top10=served,
             eval_path_brain_to_audio_top10=eval_brain_to_audio, gap_served_vs_same_orientation=served -
             eval_brain_to_audio, gap_served_vs_testTop10acc=served - best_top10, tolerance=2 / 64,
             launches=serve_ck_launches)
        if serve_ck_launches != expect(subject_matmul=1, conv_block_fused=5):
            raise AssertionError(f"checkpoint_serve launches: {serve_ck_launches}")
        if abs(ev["top10"] - best_top10) > 1 / 64 or abs(served - eval_brain_to_audio) > 2 / 64:
            raise AssertionError(f"served {served} / eval {ev['top10']} against the checkpoint's {best_top10}")
        del world, trainer, decoder, st_eval, test, Z_eval
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # -- 13e. xlsr-53's call on the device alone ------------------------------
    wav2vec2_device_timing(args.seed)

    # -- 15. data parallelism -------------------------------------------------------------
    dp_paths = data_parallel_phase(step_ms, expect)

    # -- 16-18. remat, the row-sharded bank, sharded preprocessing ----------------------------------
    t = time.perf_counter()
    ms_paths = memory_scaling_phase(expect)
    emit(phase="memory_scaling", seconds=time.perf_counter() - t)

    # -- 19. the model axis; the int8 contraction A/B -----------------------------------------------
    t = time.perf_counter()
    ma_paths = model_axis_phase(expect)
    emit(phase="model_axis", seconds=time.perf_counter() - t)
    int8_retrieval_ab()

    # -- 14. summary ---------------------------------------------------------
    paths = {"serve": launches, "train": train_launches, "eval": eval_launches, "fused_train": fused_launches,
             "taps_train": taps_launches, "taps_eval": eval_paths["taps_eval"], "tool": tool_launches,
             "bn_tool": bn_launches, "glu_tool": glu_launches, "trainer": trainer_launches, "trainer_fused": fused_trainer_launches,
             "preemption": preempt_launches,
             "checkpoint_serve": serve_ck_launches, **prep_paths, **cli_paths, **dp_paths, **ms_paths, **ma_paths}

    def launches_of(kernel):
        return sum(p[kernel] for p in paths.values())

    emit(kernels=[
        {"name": "subject_matmul", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/subject_matmul.cu",
         "replaces": "speech_decoding_tpu/ops/pallas/subject_conv.py:43",
         "launches": launches_of("subject_matmul"),
         "launches_by_path": {k: p["subject_matmul"] for k, p in paths.items()},
         "max_abs_err": max(k1_err.values()),
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": k1_lib, "device_ms": k1_dev or "not measured",
         "library_device_ms": k1_lib_dev or "not measured", "body": k1_route,
         "with_pack_ms": k1_pack_ms, "with_pack_device_ms": k1_pack_dev or "not measured",
         "pack_device_ms": pack_dev or "not measured", "wmma_body_device_ms": k1_wmma_dev or "not measured",
         "backward_max_abs_err": max(k1b_err.values()), "backward_dx_ms": k1b_ms,
         "backward_dx_device_ms": k1b_dev or "not measured", "backward_dx_library_ms": k1b_lib,
         "backward_dx_library_device_ms": k1b_lib_dev or "not measured"},
        {"name": "conv_block_fused", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/conv_block.cu",
         "replaces": "speech_decoding_tpu/ops/pallas/conv_block.py:92",
         "launches": launches_of("conv_block_fused"),
         "launches_by_path": {k: p["conv_block_fused"] for k, p in paths.items()},
         "header": "speech_decoding_tpu_torch/csrc/conv_wg.cuh", "body": "wgmma",
         "max_abs_err": max(k4_err.values()),
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"], "bound_by": k4_by,
         "library_ms": None, "device_ms": k4["device_ms"] or "not measured",
         "module_blocks_ms": k4["module_ms"], "module_blocks_device_ms": k4["module_device_ms"] or "not measured",
         "library": "none: no single PyTorch call computes a ConvBlock; the module eval ConvBlock is its yardstick",
         "timed": "the five blocks of one decode"},
        {"name": "tap_conv_dw", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/tap_conv_dw.cu",
         "replaces": "speech_decoding_tpu/ops/pallas/tap_conv.py:144",
         "launches": launches_of("tap_conv_dw"),
         "launches_by_path": {k: p["tap_conv_dw"] for k, p in paths.items()},
         "max_abs_err": max(k2_err.values()),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2_by,
         "library_ms": k2["library_ms"], "device_ms": k2["device_ms"], "header": "speech_decoding_tpu_torch/csrc/hopper.cuh",
         "timed": "the 15 launches of one flagship train step"},
        {"name": "retrieval_ranks", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/retrieval_ranks.cu",
         "replaces": "speech_decoding_tpu/ops/pallas/retrieval.py:90",
         "launches": launches_of("retrieval_ranks"),
         "launches_by_path": {k: p["retrieval_ranks"] for k, p in paths.items()},
         "header": "speech_decoding_tpu_torch/csrc/hopper.cuh", "body": "wgmma",
         "max_abs_err": k3_err,
         "ms": k3[NE]["kernel_ms"], "plain_ms": k3[NE]["plain_ms"], "bound_ms": k3[NE]["bound_ms"],
         "bound_by": k3[NE]["bound_by"], "library_ms": k3[NE]["library_ms"], "device_ms": k3[NE]["device_ms"],
         "f32_cuda_core_bound_ms": k3[NE]["f32_cuda_core_bound_ms"], "f32_body_ms": k3[NE]["f32_body_ms"],
         "timed": f"B={NE}, D={F * T}, Z bf16, Y f32",
         "b64": {k: k3[64][k] for k in ("kernel_ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "f32_body_ms", "depth_splits")}},
        {"name": "tap_conv", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/tap_conv.cu",
         "header": "speech_decoding_tpu_torch/csrc/hopper.cuh (bf16), speech_decoding_tpu_torch/csrc/tap3.cuh (f32)",
         "replaces": "speech_decoding_tpu/ops/pallas/tap_conv.py:69",
         "launches": launches_of("tap_conv"),
         "launches_by_path": {k: p["tap_conv"] for k, p in paths.items()},
         "max_abs_err": max(k5_err.values()),
         "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5_by,
         "library_ms": k5["library_ms"], "device_ms": k5["device_ms"], "timed": "the 30 launches of one pallas_taps step"},
        {"name": "conv_block_train", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/conv_block_train.cu",
         "header": "speech_decoding_tpu_torch/csrc/conv_wg.cuh on hopper.cuh (bf16), "
                   "speech_decoding_tpu_torch/csrc/tap3.cuh (f32)",
         "body": "wgmma", "tap3_route_device_ms": k6["tap3_device_ms"] or "not measured",
         "replaces": "speech_decoding_tpu/ops/pallas/conv_block_train.py:334",
         "also_replaces": "speech_decoding_tpu/ops/pallas/conv_block_train.py:409",
         "launches": sum(launches_of(f"conv_block_train.{st}") for st in cbt.STAGES),
         "launches_by_path": {k: sum(p[f"conv_block_train.{st}"] for st in cbt.STAGES) for k, p in paths.items()},
         "launches_by_stage": {st: launches_of(f"conv_block_train.{st}") for st in cbt.STAGES},
         "max_abs_err": max(k6_err.values()),
         "ms": k6["ms"], "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"], "bound_by": k6_by,
         "library_ms": None, "module_blocks_ms": k6["module_ms"], "device_ms": k6["device_ms"] or "not measured",
         "timed": "the six stages of all five blocks, one step's forward and backward"},
        {"name": "f31", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/conv_block_train.cu",
         "header": "speech_decoding_tpu_torch/csrc/conv_wg.cuh on hopper.cuh (bf16), "
                   "speech_decoding_tpu_torch/csrc/tap3.cuh (f32, f31_tile)",
         "body": "wgmma: one persistent launch of conv_wg's tiles, every F3 tile then every F1 tile, out through L2",
         "bitwise_partner": "K6's wgmma pair f3 then f1 (out, y0n, s0n)",
         "replaces": "tools/bench_cross_block_merge.py:43",
         "also_replaces": "tools/bench_cross_block_merge.py:109",
         "launches": launches_of("conv_block_train.F31"),
         "launches_by_path": {k: p["conv_block_train.F31"] for k, p in paths.items()},
         "tile_launches": launches_of("conv_block_train.F31_tile"),
         "max_abs_err": max(k7_err.values()),
         "ms": k7[1]["merged_ms"], "plain_ms": k7[1]["plain_ms"], "bound_ms": k7[1]["bound_ms"],
         "bound_by": k7[1]["bound_by"], "library_ms": None, "device_ms": k7[1]["merged_device_ms"],
         "wgmma_pair_ms": k7[1]["pair_ms"], "wgmma_pair_device_ms": k7[1]["wgmma_pair_device_ms"],
         "tap3_route_ms": k7[1]["merged_tap3_ms"], "tap3_route_device_ms": k7[1]["merged_tap3_device_ms"],
         "tap3_pair_ms": k7[1]["split_ms"], "tap3_pair_device_ms": k7[1]["tap3_pair_device_ms"],
         "device_ms_by_k_next": {k: v["merged_device_ms"] for k, v in k7.items()},
         "library": "none: no single PyTorch call computes it; K6's wgmma pair F3 + F1 is its yardstick",
         "timed": "one block boundary (k_next=1, d0n=4) at the flagship, by the port's bench_cross_block_merge"},
        {"name": "batchnorm_gelu", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/batchnorm_gelu.cu",
         "header": "speech_decoding_tpu_torch/csrc/tap3.cuh (its BatchNorm and GELU device functions)",
         "replaces": "none: the module path's train-mode BatchNorm and GELU, eager PyTorch before",
         "launches": launches_of("batchnorm_gelu"),
         "launches_by_path": {k: p["batchnorm_gelu"] for k, p in paths.items()},
         "max_abs_err": max(bn[k]["check"]["h_max_abs_err"] for k in bn_runs),
         "backward_max_abs_err": {out: max(bn[k]["check"][f"{out}_max_abs_err"] for k in bn_runs)
                                  for out in ("dy", "dscale", "dbias")},
         "max_over_tol": max(v for k in bn_runs for name, v in bn[k]["check"].items() if name.endswith("_over_tol")),
         "ms": bn["with_skip"]["ms"], "plain_ms": bn["with_skip"]["plain_ms"], "bound_ms": bn["bound_ms"],
         "bound_by": bn["bound_by"], "library_ms": None, "device_ms": bn["with_skip"]["device_ms"],
         "plain_device_ms": bn["with_skip"]["plain_device_ms"],
         "kernel_records": bn["with_skip"]["kernel_records"],
         "plain_kernel_records": bn["with_skip"]["plain_kernel_records"],
         "without_skip": {k: bn["without_skip"][k] for k in ("ms", "device_ms", "plain_ms", "plain_device_ms")},
         "library": "none: no single PyTorch call computes train-mode BatchNorm then GELU with its backward",
         "timed": "one layer's forward and backward at B=256, T=360, C=320 with the residual input"},
        {"name": "glu", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/glu.cu",
         "header": "speech_decoding_tpu_torch/csrc/tap3.cuh (its sigmoid)",
         "replaces": "none: the module path's ConvBlock GLU, a * torch.sigmoid(b) with autograd before",
         "launches": launches_of("glu"),
         "launches_by_path": {k: p["glu"] for k, p in paths.items()},
         "max_abs_err": glu_run["check"]["h_max_abs_err"],
         "backward_max_abs_err": glu_run["check"]["dy_max_abs_err"],
         "max_over_one_rounding": max(glu_run["check"]["h_over_one_rounding"],
                                      glu_run["check"]["dy_over_one_rounding"]),
         "ms": glu_run["op"]["ms"], "plain_ms": glu_run["plain"]["ms"], "bound_ms": glu_run["bound_ms"],
         "bound_by": glu_run["bound_by"], "library_ms": glu_run["library"]["ms"],
         "device_ms": glu_run["op"]["device_ms"], "plain_device_ms": glu_run["plain"]["device_ms"],
         "library_device_ms": glu_run["library"]["device_ms"], "kernel_records": glu_run["op"]["kernel_records"],
         "plain_kernel_records": glu_run["plain"]["kernel_records"],
         "library_kernel_records": glu_run["library"]["kernel_records"],
         "library_max_over_one_rounding": max(glu_run["check"]["library_h_over_one_rounding"],
                                              glu_run["check"]["library_dy_over_one_rounding"]),
         "library_bitwise": glu_run["check"]["library_bitwise"],
         "library": "torch.nn.functional.glu(Y, -1): ATen's glu and glu_backward kernels over the strided halves",
         "timed": "one block's forward and backward at B=256, T=360, D=320 (Y 640 channels)"},
    ])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
