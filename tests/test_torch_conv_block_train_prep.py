"""The host-side preparation of K6's wgmma route (``ops.conv_block_train``),
on CPU tensors at small widths: the GLU-interleaved K-major packing of w2
(``glu_pack``) and its inverse, the 270 → 272-channel x that F1's conv and
B3's K2 launch share (``x_padded``) and B3's 270-channel dx from packed w0ᵀ,
the partial-sum scratch against each route's tile, the route rule, the tap3
stages that stay K7's bitwise partner, K7's route rule, scratch and tile
walk (which F3 tiles each F1 tile reads, all claimed before it). Convs here are
the plain version (``tap_conv_plain``) on the prepared operands, sliced
back, held against the plain version on the originals (f32, rtol and atol
1e-5: sums of ~100 products of order 1)."""

import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402

from speech_decoding_tpu_torch.ops import _build  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block as tcb  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block_train as cbt  # noqa: E402
from speech_decoding_tpu_torch.ops.tap_conv import (  # noqa: E402
    flip_taps, pack_weights, pad_channels, tap_conv_dw, tap_conv_dw_plain, tap_conv_plain,
)

torch.set_num_threads(1)

DILATIONS = [1, 2, 4, 8, 16]  # every dilation of the flagship's k=3 convs
T = 40


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _glu_unpack(wk, cin):
    """The inverse of glu_pack: (3, 2C, Cin8) -> w2 (3, Cin, 2C)."""
    c2 = wk.shape[1]
    return wk[..., :cin].reshape(3, c2 // 2, 2, cin).permute(0, 3, 2, 1).reshape(3, cin, c2)


@pytest.mark.parametrize("cin,C", [(16, 8), (13, 10), (40, 24), (320, 320)])
def test_glu_pack_layout_and_inverse(cin, C):
    """Packed row 2c is channel c's value column, 2c + 1 its gate column;
    the input channels are zero-padded to a multiple of 8; glu_unpack
    undoes it bit for bit."""
    w2 = _rand(np.random.default_rng(cin + C), 3, cin, 2 * C)
    wk = tcb.glu_pack(w2)
    cin8 = -(-cin // 8) * 8
    assert wk.shape == (3, 2 * C, cin8) and wk.is_contiguous()
    assert torch.equal(wk[:, 0::2, :cin], w2[:, :, :C].transpose(1, 2))
    assert torch.equal(wk[:, 1::2, :cin], w2[:, :, C:].transpose(1, 2))
    assert not wk[:, :, cin:].any()
    assert torch.equal(_glu_unpack(wk, cin), w2)


@pytest.mark.parametrize("d", [2, 16])
@pytest.mark.parametrize("cin,C", [(16, 8), (13, 10)])
def test_glu_conv_on_packed_weights(d, cin, C):
    """The GLU conv as F3's and B1's body reads it: its output columns come
    interleaved (value, gate) per channel; de-interleaved they are conv_2's
    two halves, and F3's GLU of them is f3_plain's."""
    rng = np.random.default_rng(d + cin)
    h = _rand(rng, 2, T, cin)
    w2 = 0.2 * _rand(rng, 3, cin, 2 * C)
    want = tap_conv_plain(h, w2, d)
    got = tap_conv_plain(pad_channels(h), tcb.glu_pack(w2).transpose(1, 2), d)
    torch.testing.assert_close(got[..., 0::2], want[..., :C], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[..., 1::2], want[..., C:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_x_padded_is_made_once_per_x(dtype):
    """Block 0's 270-channel x becomes one 272-channel copy that F1 and B3's
    K2 launch share: the same object for the same, unchanged x; a new copy
    after an in-place write, for another x or for an inference tensor; x
    itself when TMA can read it."""
    x = _rand(np.random.default_rng(0), 2, 5, 270).to(dtype)
    xp = cbt.x_padded(x)
    assert xp.shape == (2, 5, 272) and torch.equal(xp[..., :270], x) and not xp[..., 270:].any()
    assert cbt.x_padded(x) is xp
    x.add_(1)
    xq = cbt.x_padded(x)
    assert xq is not xp and torch.equal(xq[..., :270], x)
    other = x.clone()
    assert cbt.x_padded(other) is not xq
    aligned = torch.zeros(2, 5, 320, dtype=dtype)
    assert cbt.x_padded(aligned) is aligned
    with torch.inference_mode():
        xi = torch.zeros(2, 5, 270, dtype=dtype)
        first = cbt.x_padded(xi)
        assert first.shape == (2, 5, 272) and cbt.x_padded(xi) is not first


@pytest.mark.parametrize("d", DILATIONS)
def test_block0_convs_on_the_272_channel_copy(d):
    """Block 0 as the wgmma route runs it: F1's conv of the padded x with
    w0 packed (3, C, 272), and B3's dx with w0ᵀ packed (3, 270, C) whose
    270 outputs are kept, equal the plain convs of the originals."""
    rng = np.random.default_rng(d)
    cin, C = 270, 16
    x = _rand(rng, 2, T, cin)
    w0 = 0.05 * _rand(rng, 3, cin, C)
    dy0 = _rand(rng, 2, T, C)
    xp = cbt.x_padded(x)
    y = tap_conv_plain(xp, pack_weights(w0).transpose(1, 2), d)
    torch.testing.assert_close(y, tap_conv_plain(x, w0, d), rtol=1e-5, atol=1e-5)
    w0t = flip_taps(w0)
    wk = pack_weights(w0t)
    assert wk.shape == (3, cin, C)
    dx = tap_conv_plain(dy0, wk.transpose(1, 2), d)
    assert dx.shape == (2, T, cin)
    torch.testing.assert_close(dx, tap_conv_plain(dy0, w0t, d), rtol=1e-5, atol=1e-5)
    # B3's K2 launch takes the same copy
    torch.testing.assert_close(tap_conv_dw(x, dy0, d, padded=xp), tap_conv_dw_plain(x, dy0, d), rtol=0, atol=0)


def test_tap_conv_dw_refuses_a_wrong_padded_x():
    x, g = torch.zeros(2, 6, 270), torch.zeros(2, 6, 16)
    for bad in (torch.zeros(2, 6, 270), torch.zeros(2, 6, 280), torch.zeros(2, 5, 272)):
        with pytest.raises(ValueError, match="padded"):
            tap_conv_dw(x, g, 2, padded=bad)


def _c_constant(src: str, name: str) -> str:
    m = re.search(r"constexpr int " + name + r" = ([^;]+);", src)
    assert m, name
    return m.group(1)


def test_tiles_match_the_cuda_sources():
    """_TM follows the tiles the kernels use: wg::TM = 64 * CONSUMERS rows on
    the wgmma route (conv_wg.cuh, the body K6 shares with K4), tap3's TM on
    the tap3 route (and the BN-backward pass)."""
    with open(os.path.join(_build.SRC_DIR, "conv_wg.cuh")) as f:
        wg = f.read().split("namespace wg {")[1].split("}  // namespace wg")[0]
    with open(os.path.join(_build.SRC_DIR, "tap3.cuh")) as f:
        tap3 = f.read()
    consumers = int(_c_constant(wg, "CONSUMERS"))
    assert _c_constant(wg, "TM") == "64 * CONSUMERS" and cbt._TM["wgmma"] == 64 * consumers
    assert int(_c_constant(tap3, "TM")) == cbt._TM["tap3"]


@pytest.mark.parametrize("route", ["wgmma", "tap3"])
@pytest.mark.parametrize("B,T,C", [(64, 360, 320), (3, 37, 320), (1, 1, 8), (2, 193, 24), (5, 64, 16)])
def test_partials_sizing(route, B, T, C):
    """The scratch holds the conv's two sums for every (recording, time
    tile) of the route's tile, and the BN-backward pass's one sum per
    (recording, 64-row tile), which runs on both routes."""
    n = cbt._part_elems(B, T, C, route)
    conv = B * -(-T // cbt._TM[route]) * 2 * C
    bn_bwd = B * -(-T // 64) * C
    assert n == max(conv, bn_bwd)


def test_fast_path_rule():
    y = torch.zeros(2, 4, 16, dtype=torch.bfloat16)
    assert cbt._fast_path(torch.bfloat16, 16, y)
    assert not cbt._fast_path(torch.float32, 16, y.float())
    assert not cbt._fast_path(torch.bfloat16, 12)
    assert cbt._fast_path(torch.bfloat16, 2048) and not cbt._fast_path(torch.bfloat16, 2056)
    flat = torch.zeros(2 * 4 * 16 + 1, dtype=torch.bfloat16)
    assert not cbt._fast_path(torch.bfloat16, 16, flat[1:].view(2, 4, 16))


@pytest.mark.parametrize("stage", list(cbt.STAGES))
def test_tile_stages_take_the_plain_version_on_the_cpu(stage):
    """The tap3 stages (TILE, K7's bitwise partners f3_tile and f1_tile) take
    the plain version for CPU tensors, like the stages, and count nothing."""
    ins = cbt.stage_inputs(2, 9, 16, 16, 1, torch.float32, "cpu", torch.Generator().manual_seed(1))[stage]
    before = cbt.TILE[stage].launches
    got, want = cbt.TILE[stage](*ins), cbt.PLAIN[stage](*ins)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert cbt.TILE[stage].launches == before and cbt.conv_block_train.route is None
    assert cbt.f3_tile is cbt.TILE["F3"] and cbt.f1_tile is cbt.TILE["F1"]


# -- K7 (f31): the route rule, the scratch and the tile walk of the wgmma route --------


def test_f31_route_rule():
    """K7 takes the stages' rule on y1 (bf16, C % 8 == 0, C <= 2048, y1
    16-byte aligned); f31_tile is tap3 whatever it is given."""
    bf16 = torch.bfloat16
    y = torch.zeros(2, 4, 16, dtype=bf16)
    assert cbt._f31_route(False, bf16, 16, y) == "wgmma"
    assert cbt._f31_route(True, bf16, 16, y) == "tap3"
    assert cbt._f31_route(False, torch.float32, 16, y.float()) == "tap3"
    assert cbt._f31_route(True, torch.float32, 16, y.float()) == "tap3"
    assert cbt._f31_route(False, bf16, 20, torch.zeros(2, 4, 20, dtype=bf16)) == "tap3"
    assert cbt._f31_route(False, bf16, 2056, torch.zeros(1, 1, 2056, dtype=bf16)) == "tap3"
    flat = torch.zeros(2 * 4 * 16 + 1, dtype=bf16)
    assert cbt._f31_route(False, bf16, 16, flat[1:].view(2, 4, 16)) == "tap3"


@pytest.mark.parametrize("B,T,C", [(64, 360, 320), (3, 37, 320), (3, 400, 320), (1, 1, 8)])
def test_f31_scratch_sizing(B, T, C):
    """K7's wgmma scratch: the wgmma route's partials (F1's two sums per
    (recording, 192-row tile)), then the sync words: a u64 of wait cycles on
    8 bytes, the claim counter, the wait count and one ready counter per
    (recording, time tile)."""
    n_part = cbt._part_elems(B, T, C, "wgmma")
    t_tiles = -(-T // 192)
    assert n_part >= B * t_tiles * 2 * C and n_part % 2 == 0
    assert cbt._f31_scratch_elems(B, T, C) == n_part + 4 + B * t_tiles


def test_f31_constants_match_the_cuda_sources():
    """The sync words' layout follows f31s in conv_block_train.cu, and the
    claim order's column tiles are conv_wg.cuh's wg::TN packed columns."""
    with open(os.path.join(_build.SRC_DIR, "conv_block_train.cu")) as f:
        f31s = f.read().split("namespace f31s {")[1].split("}  // namespace f31s")[0]
    assert "constexpr int CYCLES = 0, CLAIM = 2, WAITS = 3, READY = 4;" in f31s and cbt._F31_READY == 4
    with open(os.path.join(_build.SRC_DIR, "conv_wg.cuh")) as f:
        wg = f.read().split("namespace wg {")[1].split("}  // namespace wg")[0]
    tn = int(re.search(r"constexpr int TN = (\d+);", wg).group(1))
    order = cbt._f31_order(1, 1, 320)
    assert sum(t[0] == "F3" for t in order) == -(-640 // tn) and sum(t[0] == "F1" for t in order) == -(-320 // tn)


@pytest.mark.parametrize("T", [37, 192, 360, 400])
@pytest.mark.parametrize("d0n", [2, 4, 8, 16])
def test_f31_dependency_rule(d0n, T):
    """F1's tile tt reads the time tiles of `out` that hold a row one of its
    three taps reads inside [0, T) (at most tt - 1 .. tt + 1); every F3
    tile of those (all column tiles) is claimed before it, and every tile is
    claimed once."""
    B, C, tm = 2, 320, cbt._TM["wgmma"]
    t_tiles, co3, co1 = -(-T // tm), 4, 2
    order = cbt._f31_order(B, T, C)
    want = [("F3", b, tt, co) for b in range(B) for tt in range(t_tiles) for co in range(co3)]
    want += [("F1", b, tt, co) for b in range(B) for tt in range(t_tiles) for co in range(co1)]
    assert len(order) == len(set(order)) and sorted(order) == sorted(want)
    pos = {tile: i for i, tile in enumerate(order)}
    for st, b, tt, co in order:
        if st != "F1":
            continue
        rows = {t for j in range(3) for t in range(tt * tm + (j - 1) * d0n, (tt + 1) * tm + (j - 1) * d0n)
                if 0 <= t < T}
        reads = cbt._f31_reads(tt, T, d0n)
        assert list(reads) == sorted({t // tm for t in rows})
        assert tt in reads and reads[0] >= tt - 1 and reads[-1] <= tt + 1
        assert all(pos[("F3", b, q, c)] < pos[(st, b, tt, co)] for q in reads for c in range(co3))
    if T == 400:  # three time tiles: the middle one waits on both neighbours
        assert list(cbt._f31_reads(1, T, d0n)) == [0, 1, 2]


def test_f31_and_f31_tile_take_the_plain_version_on_the_cpu():
    """Both K7 wrappers run f31_plain for CPU tensors and count nothing."""
    ins = cbt.stage_inputs(2, 9, 16, 16, 1, torch.float32, "cpu", torch.Generator().manual_seed(2))
    args = (*ins["F3"], *ins["F1"][1:3], 1)
    before = (cbt.f31.launches, cbt.f31_tile.launches)
    want = cbt.f31_plain(*args)
    for fn in (cbt.f31, cbt.f31_tile):
        assert all(torch.equal(a, b) for a, b in zip(fn(*args), want))
    assert (cbt.f31.launches, cbt.f31_tile.launches) == before and cbt.f31.route is None
