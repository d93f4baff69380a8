"""A/B of the int8 serving bank's contraction on the card.

Port of ``tools/ab_int8_retrieval.py``:

    python -m speech_decoding_tpu_torch.tools.ab_int8_retrieval [N ...]   # bank sizes, default 2048 4096

The port's path (``inference.retrieve_topk_int8``) keeps the bank int8 on
the card and upcasts it to bf16 a 256 MB chunk of rows at a time inside
the product (bf16 × bf16 products of int8 values are exact and accumulate
in f32, so no int32 overflow at any D). Timed beside it on the same bank
and queries, by CUDA events:

  * ``whole``: the same contraction with the whole bank upcast at once (the
    port's path before the chunking);
  * ``int32``: the JAX tool's baseline, int8 × int8 → int32 products
    (``torch._int_mm``) over 2^17-term chunks of D (D·127² would pass 2^31 at
    the flagship's D = F·T = 368,640), summed in f32 across chunks;
  * ``f32``: ``retrieve_topk`` on the f32 bank.

Prints one JSON line a bank size with each route's ms, the top-1 ids'
agreement with the port's path and the largest score difference. Runs on
the card; ``ab(..., device="cpu")`` checks the arithmetic (not a rate).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.inference import (
    quantize_query_int8, quantize_rows_int8, retrieve_topk, retrieve_topk_int8,
)
from speech_decoding_tpu_torch.tools import device_name, seconds_for
from speech_decoding_tpu_torch.utils.device import resolve_device

B, D, K = 64, 1024 * 360, 10  # a serving batch against flagship rows (F·T)
INT8_DOT_CHUNK = 2**17  # <= 2^31 / 127^2 terms per int32 product: overflow-free


def pack_int8_bank(bank_q: torch.Tensor, chunk: int = INT8_DOT_CHUNK) -> torch.Tensor:
    """(N, D) int8 -> (n_chunks, N, chunk) int8, zero-padded: the int32
    route's layout, made once when the bank is set."""
    n_rows, d = bank_q.shape
    n = -(-d // chunk)
    return Fn.pad(bank_q, (0, n * chunk - d)).reshape(n_rows, n, chunk).transpose(0, 1).contiguous()


def retrieve_topk_int8_int32(Z: torch.Tensor, bank_q3: torch.Tensor, bank_scale: torch.Tensor,
                             k: int = K) -> Tuple[torch.Tensor, torch.Tensor]:
    """``retrieve_topk_int8`` on a ``pack_int8_bank`` layout: each chunk's
    int8 × int8 product exact in int32, the chunks summed in f32."""
    n, n_rows, chunk = bank_q3.shape
    zq, zscale = quantize_query_int8(Z)
    zq3 = pack_int8_bank(zq, chunk)
    sim = torch.zeros((zq.shape[0], n_rows), dtype=torch.float32, device=zq.device)
    for c in range(n):
        sim += torch._int_mm(zq3[c], bank_q3[c].t()).float()
    return torch.topk(sim * zscale * bank_scale[None, :], min(int(k), n_rows), dim=-1)


def retrieve_topk_int8_whole(Z: torch.Tensor, bank_q: torch.Tensor, bank_scale: torch.Tensor,
                             k: int = K) -> Tuple[torch.Tensor, torch.Tensor]:
    """``retrieve_topk_int8`` with the whole bank upcast at once (bf16 on
    the card, f32 on the CPU)."""
    zq, zscale = quantize_query_int8(Z)
    if zq.is_cuda:
        sim = torch.mm(zq.to(torch.bfloat16), bank_q.to(torch.bfloat16).T, out_dtype=torch.float32)
    else:
        sim = zq.float() @ bank_q.float().T
    return torch.topk(sim * zscale * bank_scale[None, :], min(int(k), bank_q.shape[0]), dim=-1)


def ab(n_rows: int, batch: int = B, dim: int = D, device: Optional[str] = None, seed: int = 0,
       reps: int = 10) -> Dict:
    """One bank of ``n_rows`` unit rows of ``dim`` and ``batch`` queries,
    drawn on the device from ``seed``: each route's ms a call (after one
    warm-up call), and each int8 route's top-1 agreement and largest score
    difference against the port's path."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn((n_rows, dim), generator=gen, device=dev)
    bank = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    del rows
    Z = torch.randn((batch, dim), generator=gen, device=dev)
    q, scale = quantize_rows_int8(bank)
    q3 = pack_int8_bank(q)
    routes = {"port": lambda: retrieve_topk_int8(Z, q, scale, K),
              "whole": lambda: retrieve_topk_int8_whole(Z, q, scale, K),
              "int32": lambda: retrieve_topk_int8_int32(Z, q3, scale, K),
              "f32": lambda: retrieve_topk(Z, bank, K)}
    ref_scores, ref_ids = routes["port"]()
    out = {"tool": "ab_int8_retrieval", "device": device_name(dev), "N": n_rows, "D": dim, "B": batch, "k": K,
           "bank_gb": {"f32": n_rows * dim * 4 / 1e9, "int8": n_rows * dim / 1e9}}
    for name, fn in routes.items():
        scores, ids = fn()
        out[f"{name}_ms"] = seconds_for(fn, dev, reps) / reps * 1e3
        if name != "port":
            out[f"{name}_top1_agreement"] = float((ids[:, 0] == ref_ids[:, 0]).float().mean())
            out[f"{name}_max_score_diff"] = float((scores - ref_scores).abs().max())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_rows", nargs="*", type=int, default=[2048, 4096], help="bank sizes")
    for n in ap.parse_args(argv).n_rows:
        print(json.dumps(ab(n)), flush=True)


if __name__ == "__main__":
    main()
