"""CPU side of K3's ``wgmma`` body (``speech_decoding_tpu_torch/ops/retrieval.py``):
the bf16 split of y (``split_bf16_pieces``), the plain version of the
body's arithmetic (``retrieval_ranks_pieces_plain``) against JAX's Pallas
``retrieval_ranks_pallas`` in interpret mode, the route rule
(``_fast_path``), the depth-split rule and its workspace bound, and the
wrapper's constants against the source. Ranks are compared outside
``near_tie_rows`` (tol 1e-6): there another summation order may flip a
compare. The kernels themselves run on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.ops.pallas.retrieval import retrieval_ranks_pallas as j_retrieval_ranks  # noqa: E402
from speech_decoding_tpu_torch.ops import _build  # noqa: E402
from speech_decoding_tpu_torch.ops import retrieval as k3  # noqa: E402

torch.set_num_threads(1)


def _inputs(B, D, seed):
    """Z = 2/sqrt(D)·Y + noise, rounded to bf16 (the eval's embeddings);
    Y f32: the diagonal cosine sits two standard deviations above a random
    pair's, so ranks spread."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(B, D)).astype(np.float32)
    Z = (2 / math.sqrt(D) * Y + rng.normal(size=(B, D))).astype(np.float32)
    Zb = torch.from_numpy(Z).bfloat16()
    return Zb, torch.from_numpy(Y)


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e6, 1e30])
def test_f32_pieces_add_back(scale):
    """Three bf16 pieces of f32 y add back to y within 2^-26·|y| (exactly,
    for normal numbers)."""
    rng = np.random.default_rng(0)
    y = torch.from_numpy((rng.normal(size=(7, 1000)) * scale).astype(np.float32))
    p = k3.split_bf16_pieces(y)
    assert p.shape == (3, 7, 1000) and p.dtype == torch.bfloat16
    err = (p.double().sum(0) - y.double()).abs()
    assert bool((err <= 2.0 ** -26 * y.double().abs()).all())
    # each piece is the rounding of what the earlier ones leave
    assert torch.equal(p[0], y.bfloat16())
    assert torch.equal(p[1], (y - p[0].float()).bfloat16())


def test_bf16_is_its_own_piece():
    y = torch.randn(5, 16).bfloat16()
    p = k3.split_bf16_pieces(y)
    assert p.shape == (1, 5, 16) and torch.equal(p[0], y)
    with pytest.raises(ValueError, match="f32 or bf16"):
        k3.split_bf16_pieces(y.half())


@pytest.mark.parametrize("ydtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D", [(64, 1000), (130, 4096), (333, 1000)])
def test_pieces_plain_matches_pallas(B, D, ydtype):
    """The body's arithmetic (Σ over y's bf16 pieces of y_p @ z.T in f32,
    then the epilogue) against the Pallas kernel in interpret mode on the
    same bf16-rounded Z (and Y, for bf16): ranks equal outside near ties."""
    Z, Y = _inputs(B, D, B + D)
    Y = Y.to(ydtype)
    want = np.asarray(j_retrieval_ranks(jnp.asarray(Z.float().numpy()), jnp.asarray(Y.float().numpy()),
                                        interpret=True))
    got = k3.retrieval_ranks_pieces_plain(Z, Y)
    assert got.dtype == torch.int32 and got.shape == (B,)
    differ = set(np.nonzero(got.numpy() != want)[0].tolist())
    assert differ <= k3.near_tie_rows(Z, Y), sorted(differ)[:10]
    assert len(np.unique(want)) > 10  # ranks spread
    # and against the plain version, which the CPU route and the f32 body follow
    plain = k3.retrieval_ranks_plain(Z, Y)
    assert set(torch.nonzero(got != plain).flatten().tolist()) <= k3.near_tie_rows(Z, Y)


_GOOD = dict(B=64, D=368640, z_dtype=torch.bfloat16, y_dtype=torch.float32, ptrs=(4096, 8192))


@pytest.mark.parametrize("change,taken", [
    ({}, True),                                   # the eval's shape: Z bf16, Y f32
    ({"y_dtype": torch.bfloat16}, True),          # bf16 targets: one piece
    ({"B": 1, "D": 8}, True),                     # the smallest
    ({"z_dtype": torch.float32}, False),          # f32 Z is not one bf16 piece
    ({"y_dtype": torch.float16}, False),          # only f32 and bf16 Y are split
    ({"D": 1001}, False),                         # rows not whole 16-byte pieces
    ({"D": 1004}, False),                         # D % 8 == 4 still not
    ({"ptrs": (4096 + 2, 8192)}, False),          # Z's base misaligned
    ({"ptrs": (4096, 8192 + 4)}, False),          # Y's base misaligned
    ({"B": 0}, False),                            # nothing to rank
    ({"D": 0}, False),                            # no depth
])
def test_fast_path_domain(change, taken):
    assert k3._fast_path(**{**_GOOD, **change}) is taken


@pytest.mark.parametrize("B", [1, 64, 130, 333, 1024, 2048, 4096])
@pytest.mark.parametrize("D", [8, 1000, 36864, 368640])
def test_depth_splits(B, D):
    """No slice is empty, splits × tiles stays within one wave of 132 SMs
    when the tiles alone do not fill it (the workspace bound: at most 132
    partial 64 × 256 f32 tiles, 8.7 MB), and the large eval (B = 2048, 256
    tiles) and short depths are not split."""
    sms = 132
    s = k3._splits(B, D, sms)
    assert k3.TILE == (64, 256) and k3.CHUNK == 64
    tiles = math.ceil(B / 64) * math.ceil(B / 256)
    chunks = math.ceil(D / 64)
    per = math.ceil(chunks / s)
    assert 1 <= s <= chunks and (s - 1) * per < chunks  # the last slice has depth
    if s > 1:
        assert s * tiles <= sms and s * tiles * 64 * 256 * 4 <= 8.7e6
    if tiles >= sms // 2 + 1 or chunks == 1:
        assert s == 1
    if B == 64 and D == 368640:  # the Trainer's eval: one tile over about every SM
        assert s >= sms - 2


def test_constants_match_the_source():
    """The wrapper's preparation slice, tile and stage depth are the kernel's."""
    with open(os.path.join(_build.SRC_DIR, "retrieval_ranks.cu")) as f:
        src = f.read()
    src = src[src.index("namespace k3 {"):]  # the bf16 body's constants
    assert re.search(r"PREP_SLICE = (\d+);", src).group(1) == str(k3.PREP_SLICE)
    assert (int(re.search(r"int TM = (\d+);", src).group(1)), int(re.search(r"int TN = (\d+);", src).group(1))) \
        == k3.TILE
    assert int(re.search(r"int BK = (\d+);", src).group(1)) == k3.CHUNK


def test_cpu_route_is_the_plain_version():
    """CPU tensors take ``retrieval_ranks_plain`` whatever their dtypes, and
    launch nothing."""
    Z, Y = _inputs(40, 64, 3)
    before = k3.retrieval_ranks.launches
    assert torch.equal(k3.retrieval_ranks(Z, Y), k3.retrieval_ranks_plain(Z, Y))
    assert torch.equal(k3.retrieval_ranks(Z, Y.bfloat16()), k3.retrieval_ranks_plain(Z, Y.bfloat16()))
    assert k3.retrieval_ranks.launches == before
