#!/usr/bin/env python3
"""Drive the PyTorch port (``speech_decoding_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

What it does, in order (one JSON object per line on stdout):

  1. the card's name and power limit (``nvidia-smi``);
  2. builds both hand-written CUDA kernels from ``speech_decoding_tpu_torch/csrc``
     with ``nvcc`` (one process per source, all started together) and times it;
  3. K1 ``subject_matmul`` against its plain version, f32 and bf16, at the
     serving shape (B=64, T=360, D1=270, S=27, mixed subject ids) and at a
     ragged small shape; an out-of-range id must raise;
  4. K4 ``conv_block_fused`` against its plain version for blocks k=0..4 at
     (64, 360, D) in bf16, in f32 at a smaller batch, and at a ragged shape
     where every dilation reaches both edges of the recording;
  5. the whole encode at full width (S=27, C=208, T=360, D1=270, D2=320,
     F=1024, K=32, random BatchNorm running statistics): the fused serving
     path (K1 + five K4 launches) against the module path, f32 and bf16;
  6. the main path: ``SpeechDecoder`` with a 512-row f32 bank, then an int8
     bank, behind ``DecoderServer`` on an ephemeral port; 12 + 8 concurrent
     ``/decode`` requests of 1-16 rows each must equal a direct
     ``decoder.decode`` of the same rows. Every launch counter is set to 0
     just before and read just after; both kernels must have launched;
  7. timings with CUDA events (kernel, plain version, one PyTorch call where
     one exists, the bound for this card), the fused vs module encode with
     the input on the card, retrieval against each bank, and one whole
     decode on the host clock; kernel launches per decode;
  8. the ``kernels`` summary line, the card line again, and last
     ``{"ok": true, "device": {...}}``.

Any mismatch or exception exits non-zero without the last line; so does a
machine without a CUDA device, or a directory without the port package.
Weights are random, made from ``--seed`` (default 0).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of the H100 SXM (NVIDIA data sheet, 700 W): bf16
# tensor-core FLOP/s and device-memory bytes/s
H100_SXM = ("H100 80GB HBM3", {"bf16": 989e12, "bytes": 3.35e12})


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


def compare(name: str, got, want, atol: float, rtol: float) -> float:
    """Elementwise |got - want| <= atol + rtol·|want| (in f32); raises otherwise."""
    import torch

    torch.cuda.synchronize()
    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite values")
    err = (g - w).abs()
    worst = float((err - rtol * w.abs()).max())
    max_abs = float(err.max())
    emit(check=name, max_abs_err=max_abs, max_abs_ref=float(w.abs().max()), atol=atol, rtol=rtol)
    if worst > atol:
        raise AssertionError(f"{name}: max |got - want| - rtol·|want| = {worst} > {atol}")
    return max_abs


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from speech_decoding_tpu_torch.data.layout import ch_locations_2d
        from speech_decoding_tpu_torch.inference import SpeechDecoder
        from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
        from speech_decoding_tpu_torch.ops import _build
        from speech_decoding_tpu_torch.ops.conv_block import (
            conv_block_fused, conv_block_plain, prepare_fused_stack,
        )
        from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul, subject_matmul_plain
        from speech_decoding_tpu_torch.serving import DecoderServer, decode_request
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
    libs = _build.build(["subject_matmul", "conv_block"])
    emit(phase="build", seconds=time.perf_counter() - t, libraries=[os.path.relpath(p, ROOT) for p in libs])

    B, C, T, D1, D2, F, K, S = 64, 208, 360, 270, 320, 1024, 32, 27
    bf16, f32 = torch.bfloat16, torch.float32

    # -- 3. K1 vs plain ------------------------------------------------------
    def k1_inputs(b, t_, din, dout, s, dtype):
        x = torch.randn(b, t_, din, generator=gen).to(dev, dtype)
        w = (torch.rand(s, din, dout, generator=gen) * 2 - 1).div(din ** 0.5).to(dev, dtype)
        ids = torch.from_numpy(rng.integers(0, s, size=b).astype(np.int32)).to(dev)
        return x, w, ids

    k1_err = {}
    for dtype, atol, rtol in ((f32, 1e-5, 1e-5), (bf16, 1e-2, 1e-2)):
        for shape in ((B, T, D1, D1, S), (3, 37, 19, 150, 4)):
            x, w, ids = k1_inputs(*shape, dtype)
            name = f"K1 {str(dtype)[6:]} {shape}"
            k1_err[name] = compare(name, subject_matmul(x, w, ids), subject_matmul_plain(x, w, ids), atol, rtol)
    try:
        subject_matmul(x, w, torch.full_like(ids, 4))
        raise AssertionError("K1 accepted an out-of-range subject id")
    except ValueError:
        emit(check="K1 rejects an out-of-range subject id")

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

    k4_err = {}
    for k in range(5):
        cin = D1 if k == 0 else D2
        x = torch.randn(B, T, cin, generator=gen).to(dev, bf16)
        name = f"K4 k={k} bf16 {(B, T, cin)}"
        k4_err[name] = compare(name, conv_block_fused(x, *staged16[k], k=k),
                               conv_block_plain(x, *staged16[k], k=k), 1e-2, 1e-2)
        x = torch.randn(4, T, cin, generator=gen).to(dev, f32)
        name = f"K4 k={k} f32 {(4, T, cin)}"
        k4_err[name] = compare(name, conv_block_fused(x, *staged32[k], k=k),
                               conv_block_plain(x, *staged32[k], k=k), 1e-4, 1e-4)
    # ragged: D2 not a multiple of the 128-channel tile, Cin not of the
    # 32-deep chunk, T shorter than the widest halo (every dilation hits an edge)
    small = BrainEncoder(num_subjects=2, loc=loc, D1=40, D2=48, F=16, K=4,
                         generator=torch.Generator().manual_seed(args.seed + 1))
    random_bn_stats(small, gen)
    small.to(dev)
    staged_small = prepare_fused_stack(small.conv_blocks, f32)
    for k in range(5):
        for t_ in (37, 13):
            x = torch.randn(3, t_, 40 if k == 0 else 48, generator=gen).to(dev)
            name = f"K4 k={k} f32 ragged {tuple(x.shape)}"
            compare(name, conv_block_fused(x, *staged_small[k], k=k),
                    conv_block_plain(x, *staged_small[k], k=k), 1e-4, 1e-4)

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
        subject_matmul.launches = conv_block_fused.launches = 0
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
        launches = {"subject_matmul": subject_matmul.launches, "conv_block_fused": conv_block_fused.launches}
        stats = {"dispatches": server.batcher.dispatches, "rows": server.batcher.rows}
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
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # -- 7. timings at the serving shape (bf16, B=64) ---------------------------
    subject_matmul.launches = conv_block_fused.launches = 0
    decoder.decode(X, sidx, k=10)
    per_decode = {"subject_matmul": subject_matmul.launches, "conv_block_fused": conv_block_fused.launches}
    x, w, ids = k1_inputs(B, T, D1, D1, S, bf16)
    k1_ms = time_ms(lambda: subject_matmul(x, w, ids))
    k1_plain = time_ms(lambda: subject_matmul_plain(x, w, ids))
    k1_lib = time_ms(lambda: torch.bmm(x, w[ids.long()]))
    present = int(torch.unique(ids).numel())
    k1_bound, k1_by = bound_ms(2 * B * T * D1 * D1,
                               nbytes(x, ids) + present * D1 * D1 * 2 + B * T * D1 * 2, peaks, "bf16")
    emit(timing="K1 subject_matmul", shape=[B, T, D1, D1, S], dtype="bf16", kernel_ms=k1_ms,
         plain_ms=k1_plain, library_ms=k1_lib, library="torch.bmm over W[sidx]",
         bound_ms=k1_bound, bound_by=k1_by, launches_per_decode=per_decode["subject_matmul"])

    k4 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    for k in range(5):
        cin = D1 if k == 0 else D2
        x = torch.randn(B, T, cin, generator=gen).to(dev, bf16)
        args_k = staged16[k]
        ms = time_ms(lambda: conv_block_fused(x, *args_k, k=k), reps=10)
        plain = time_ms(lambda: conv_block_plain(x, *args_k, k=k), reps=5)
        flops = 2 * B * T * 3 * (cin * D2 + D2 * D2 + D2 * 2 * D2)
        moved = nbytes(x, *args_k) + B * T * D2 * 2
        bnd, by = bound_ms(flops, moved, peaks, "bf16")
        emit(timing=f"K4 conv_block_fused k={k}", shape=[B, T, cin, D2], dtype="bf16", kernel_ms=ms,
             plain_ms=plain, library_ms=None, library="none: no single PyTorch call computes a ConvBlock",
             bound_ms=bnd, bound_by=by, gflop=flops / 1e9, mbytes=moved / 1e6,
             launches_per_decode=per_decode["conv_block_fused"] / 5)
        k4["ms"] += ms
        k4["plain_ms"] += plain
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

    # -- 8. summary ----------------------------------------------------------
    emit(kernels=[
        {"name": "subject_matmul", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/subject_matmul.cu",
         "replaces": "speech_decoding_tpu/ops/pallas/subject_conv.py:43",
         "launches": launches["subject_matmul"], "max_abs_err": max(k1_err.values()),
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": k1_lib},
        {"name": "conv_block_fused", "route": "cuda",
         "source": "speech_decoding_tpu_torch/csrc/conv_block.cu",
         "replaces": "speech_decoding_tpu/ops/pallas/conv_block.py:92",
         "launches": launches["conv_block_fused"], "max_abs_err": max(k4_err.values()),
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"], "bound_by": k4_by,
         "library_ms": None},
    ])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
