"""The port's data layer against the JAX package's, on the CPU in f32:
``natsorted``, ``load_wav`` and the preprocessing cache; the native segment
gather (built into ``build/native/``) against its numpy version and the JAX
gather; the synthetic trees byte for byte; tiny Gwilliams2022 and
Brennan2018 builds by both packages (the port's tiny wav2vec2 carries the
JAX fixture's weights); a JAX-built cache loaded by the port; the sampling
draws; and ``DeviceResidentGwilliams`` in every store dtype and layout.

Tolerances: the DSP outputs X and Y at ``tests/test_torch_dsp.py``'s f32
tolerance (rtol 1e-4, atol 1e-5: cuFFT/pocketfft against XLA's FFT, f32
sums in another order); per-word scale stats at rtol 1e-5, atol 1e-6 (the
two packages interpolate the quartiles of one sort with different
formulas); everything that only copies or draws (onsets, counts, pools,
choices, gathers, int16 scales) bit for bit; the int16 dequantization within
1e-6 relative."""

import json
import os
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import scipy.io.wavfile  # noqa: E402

from speech_decoding_tpu.data import brennan2018 as j_brennan  # noqa: E402
from speech_decoding_tpu.data import gwilliams2022 as j_gw  # noqa: E402
from speech_decoding_tpu.data import native_loader as j_native  # noqa: E402
from speech_decoding_tpu.data import preproc_cache as j_cache  # noqa: E402
from speech_decoding_tpu.data import synthetic as j_syn  # noqa: E402
from speech_decoding_tpu.data.device_resident import DeviceResidentGwilliams as JaxResident  # noqa: E402
from speech_decoding_tpu.data.sampling import random_split as j_random_split  # noqa: E402
from speech_decoding_tpu.utils import natsort as j_natsort  # noqa: E402
from speech_decoding_tpu.utils import wavio as j_wavio  # noqa: E402
from speech_decoding_tpu_torch.data import brennan2018 as t_brennan  # noqa: E402
from speech_decoding_tpu_torch.data import gwilliams2022 as t_gw  # noqa: E402
from speech_decoding_tpu_torch.data import native_loader  # noqa: E402
from speech_decoding_tpu_torch.data import preproc_cache as t_cache  # noqa: E402
from speech_decoding_tpu_torch.data import synthetic as t_syn  # noqa: E402
from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams  # noqa: E402
from speech_decoding_tpu_torch.data.sampling import random_split  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import load_flax_wav2vec2  # noqa: E402
from speech_decoding_tpu_torch.utils import natsort as t_natsort  # noqa: E402
from speech_decoding_tpu_torch.utils import wavio as t_wavio  # noqa: E402

torch.set_num_threads(1)

DSP = dict(rtol=1e-4, atol=1e-5)
STATS = dict(rtol=1e-5, atol=1e-6)
DIMS = dict(num_subjects=2, num_sessions=2, num_tasks=2)


def _files(root):
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(dp, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dp, f), root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def w2v():
    """(JAX fixture wav2vec2, the port's tiny wav2vec2 with its weights)."""
    jw = j_syn.tiny_wav2vec()
    tw = t_syn.tiny_wav2vec(device="cpu")
    load_flax_wav2vec2(tw.model, jax.tree.map(np.asarray, jw.variables))
    return jw, tw


@pytest.fixture(scope="module")
def gw(tmp_path_factory, w2v):
    """One Gwilliams tree (a session missing) written by each package's
    generator, each built by its own package: (jax_root, port_root, jax
    dataset, port dataset)."""
    jroot, troot = (str(tmp_path_factory.mktemp(n)) for n in ("gw_jax", "gw_port"))
    j_syn.make_gwilliams_tree(jroot, missing=((1, 1),))
    t_syn.make_gwilliams_tree(troot, missing=((1, 1),))
    jcfg = j_syn.make_config(jroot, "Gwilliams2022", rebuild_dataset=True)
    tcfg = t_syn.make_config(troot, "Gwilliams2022", rebuild_dataset=True)
    jds = j_gw.Gwilliams2022ShallowSplit(jcfg, wav2vec=w2v[0], **DIMS)
    tds = t_gw.Gwilliams2022ShallowSplit(tcfg, wav2vec=w2v[1], device="cpu", **DIMS)
    return jroot, troot, jds, tds


@pytest.fixture(scope="module")
def port_on_jax_cache(gw):
    """The port's dataset loaded from the cache the JAX package built."""
    cfg = t_syn.make_config(gw[0], "Gwilliams2022")
    return t_gw.Gwilliams2022ShallowSplit(cfg, device="cpu", **DIMS)


# -- copies ------------------------------------------------------------------------------


def test_natsort_and_wavio_match_jax(tmp_path):
    names = ["S10.mat", "S2.mat", "S1.mat", "a10b2", "a10b10", "a2", "x", "S01.mat"]
    assert t_natsort.natsorted(names) == j_natsort.natsorted(names)
    rng = np.random.default_rng(0)
    datas = {"i16": (rng.normal(size=(500, 2)) * 8000).astype(np.int16),
             "i32": (rng.normal(size=700) * 2e8).astype(np.int32),
             "u8": rng.integers(0, 256, 300).astype(np.uint8),
             "f32": rng.normal(size=(400, 3)).astype(np.float32)}
    for name, data in datas.items():
        path = str(tmp_path / f"{name}.wav")
        scipy.io.wavfile.write(path, 16000, data)
        got, want = t_wavio.load_wav(path), j_wavio.load_wav(path)
        assert got[1] == want[1] == 16000
        assert got[0].dtype == np.float32 and np.array_equal(got[0], want[0]), name


def test_check_preprocs_matches_jax(tmp_path):
    """The same directories, flags and settings files, and each package
    finds the other's directories."""
    a = {"brain_resample_rate": 120, "seq_len_sec": 3, "last4layers": True}
    b = dict(a, seq_len_sec=2)
    for mod, root in ((j_cache, tmp_path / "j"), (t_cache, tmp_path / "t")):
        flags, d = mod.check_preprocs(a, str(root))
        assert flags == {"x_done": False, "y_done": False} and d.endswith("0" + os.sep)
        assert mod.mark_done(a, d, "x_done") == {"x_done": True, "y_done": False}
        assert mod.check_preprocs(b, str(root))[1].endswith("1" + os.sep)
        # x_done/y_done and the legacy keys are not part of the key
        assert mod.check_preprocs(dict(a, mode="x", x_done=False), str(root)) == (
            {"x_done": True, "y_done": False}, d)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    # a directory written by one package names the same config in the other
    assert t_cache.check_preprocs(b, str(tmp_path / "j"))[1] == str(tmp_path / "j" / "1") + os.sep
    assert j_cache.check_preprocs(a, str(tmp_path / "t"))[1] == str(tmp_path / "t" / "0") + os.sep


# -- the native gather ------------------------------------------------------------------


@pytest.mark.parametrize("baseline_len", [0, 13, 60, 500])
def test_native_gather_bitwise(baseline_len):
    """The library against gather_segments_plain and the JAX package's
    gather, bit for bit, with and without baseline (500 > L clamps to the
    window), on f32, f64 (copied) and strided sources."""
    rng = np.random.default_rng(baseline_len)
    srcs = [rng.normal(size=(7, 300 + 11 * i)).astype(np.float32) for i in range(5)]
    srcs.append(rng.normal(size=(7, 320)))  # f64: copied to f32
    srcs.append(rng.normal(size=(320, 7)).astype(np.float32).T)  # not C-contiguous
    ons = rng.integers(0, 200, len(srcs))
    got = native_loader.gather_segments(srcs, ons, 60, baseline_len, num_threads=3)
    np.testing.assert_array_equal(got, native_loader.gather_segments_plain(srcs, ons, 60, baseline_len))
    np.testing.assert_array_equal(got, j_native.gather_segments(srcs, ons, 60, baseline_len))
    out = np.empty_like(got)
    assert native_loader.gather_segments(srcs, ons, 60, baseline_len, out=out) is out
    np.testing.assert_array_equal(out, got)


def test_native_gather_memmap_and_bounds(tmp_path):
    """Memory-mapped sources gather in place; a window outside its
    recording, a bad ``out`` and mismatched channels raise before the
    library reads anything."""
    a = np.random.default_rng(1).normal(size=(4, 100)).astype(np.float32)
    np.save(tmp_path / "a.npy", a)
    mm = np.load(tmp_path / "a.npy", mmap_mode="r")
    np.testing.assert_array_equal(native_loader.gather_segments([mm, mm], [0, 40], 60), np.stack([a[:, :60], a[:, 40:]]))
    with pytest.raises(ValueError, match="outside"):
        native_loader.gather_segments([a], [41], 60)
    with pytest.raises(ValueError, match="outside"):
        native_loader.gather_segments([a], [-1], 60)
    with pytest.raises(ValueError, match="sources must be"):
        native_loader.gather_segments([a, a[:3]], [0, 0], 10)
    with pytest.raises(ValueError, match="out must be"):
        native_loader.gather_segments([a], [0], 10, out=np.empty((1, 4, 11), np.float32))


def test_native_gather_build_and_no_fallback(tmp_path, monkeypatch):
    """The library is built into build/native/ keyed by a hash of the source
    and flags (never into native/, where the JAX package builds); its ctypes
    signatures match the C declarations; without the source or without
    g++, gather_segments raises: nothing falls back to numpy unasked."""
    import re

    path = native_loader.lib_path()
    assert os.path.dirname(path) == native_loader.BUILD_DIR
    assert native_loader.BUILD_DIR.endswith(os.path.join("build", "native"))
    native_loader.get_lib()
    assert os.path.exists(path)
    with open(native_loader.SRC_PATH) as f:
        src = f.read()
    decls = dict(re.findall(r"void (sd_\w+)\(([^)]*)\)", src))
    assert sorted(decls) == sorted(native_loader._SIGNATURES)
    kinds = {"const float**": "PP", "const int64_t*": "P64", "int64_t": "I64", "float*": "PF", "int": "I"}
    ct = {"PP": "LP_LP_c_float", "P64": "LP_c_long", "I64": "c_long", "PF": "LP_c_float", "I": "c_int"}
    for name, params in decls.items():
        want = [ct[kinds[" ".join(p.split()[:-1])]] for p in params.replace("\n", " ").split(",")]
        assert [t.__name__ for t in native_loader._SIGNATURES[name]] == want, name

    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.gather_segments([np.zeros((2, 8), np.float32)], [0], 4)
    monkeypatch.setattr(native_loader, "SRC_PATH", str(tmp_path / "missing.cpp"))
    with pytest.raises(RuntimeError, match="missing"):
        native_loader.get_lib()


# -- synthetic trees ----------------------------------------------------------------------


def test_synthetic_trees_byte_for_byte(tmp_path):
    """The port's generators write the JAX package's files, byte for byte."""
    j_syn.make_gwilliams_tree(str(tmp_path / "j"), n_subjects=2, n_sessions=1, n_tasks=3, rec_secs=6.0,
                              n_words_per_task=8, n_channels=20, missing=((1, 0, 2),))
    t_syn.make_gwilliams_tree(str(tmp_path / "t"), n_subjects=2, n_sessions=1, n_tasks=3, rec_secs=6.0,
                              n_words_per_task=8, n_channels=20, missing=((1, 0, 2),))
    j_syn.make_brennan_tree(str(tmp_path / "j"), n_subjects_present=3, eeg_secs=4.0, audio_secs=4.0)
    t_syn.make_brennan_tree(str(tmp_path / "t"), n_subjects_present=3, eeg_secs=4.0, audio_secs=4.0)
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert len(jf) == (2 * 1 * 3 - 1) * 2 + 3 + 2 + 3  # recordings x (npy, json), stimuli, Brennan wavs and .mat
    assert sorted(jf) == sorted(tf)
    for name in jf:
        assert jf[name] == tf[name], name
    cfg = t_syn.make_config("/r", "Gwilliams2022", **{"tpu.scan_steps": 2})
    assert (cfg.dataset, cfg.root_dir, cfg.rebuild_dataset, cfg.tpu.scan_steps) == ("Gwilliams2022", "/r", False, 2)


# -- Gwilliams2022 ------------------------------------------------------------------------


def test_onset_logic_matches_jax():
    rng = np.random.default_rng(0)
    starts = np.concatenate([np.sort(rng.uniform(0, 9, 12)), np.sort(rng.uniform(0, 7, 9))])
    np.testing.assert_array_equal(t_gw.continuous(starts.copy()), j_gw.continuous(starts.copy()))
    desc = [{"start": float(s), "kind": "word" if i % 3 else "phoneme", "sequence_id": i // 5}
            for i, s in enumerate(starts)]
    desc = [str(d) if i % 2 else d for i, d in enumerate(desc)]
    for gap in (None, 1.0, 3.0):
        for a, b in zip(t_gw.parse_annotations(desc, gap), j_gw.parse_annotations(desc, gap)):
            np.testing.assert_array_equal(a, b)


def test_gwilliams_build_matches_jax(gw):
    """The port's build on the CPU against the JAX build of the same tree:
    X and Y at the DSP tolerance, onsets, segment counts and manifests
    equal, the scale stats at their tolerance, the same split pools."""
    jroot, troot, jds, tds = gw
    assert (tds.num_subjects, len(tds), tds.num_segments_foreach_task) == (
        jds.num_subjects, len(jds), jds.num_segments_foreach_task)
    assert list(tds.X) == list(jds.X) and len(tds.X) == 3
    np.testing.assert_allclose(tds.Y, jds.Y, **DSP)
    np.testing.assert_array_equal(tds.segment_task_ids, jds.segment_task_ids)
    np.testing.assert_array_equal(tds.segment_y_onsets, jds.segment_y_onsets)
    for key, tasks in jds.X.items():
        assert list(tds.X[key]) == list(tasks)
        for task, x in tasks.items():
            assert isinstance(tds.X[key][task], np.memmap)
            np.testing.assert_allclose(tds.X[key][task], x, **DSP)
            np.testing.assert_array_equal(tds.meg_onsets[key][task], jds.meg_onsets[key][task])
            np.testing.assert_allclose(tds.scale_stats[key][task], jds.scale_stats[key][task], **STATS)
    with open(os.path.join(jds.preproc_dir, "settings.json")) as f, \
            open(os.path.join(tds.preproc_dir, "settings.json")) as g:
        assert json.load(f) == json.load(g)
    for a, b in zip(random_split(len(tds), 0.8, np.random.default_rng(5)),
                    j_random_split(len(jds), 0.8, np.random.default_rng(5))):
        np.testing.assert_array_equal(a, b)


def test_gwilliams_host_backend_matches_jax(tmp_path, w2v):
    """``tpu.preproc_backend: host`` (the numpy/scipy twin, a copy of the
    JAX package's, through ``preprocess_auto``): X bit for bit the JAX
    build's, Y at the DSP tolerance."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    for root in (jroot, troot):
        j_syn.make_gwilliams_tree(root, n_subjects=1, n_sessions=1, n_tasks=1, rec_secs=20.0, n_words_per_task=8)
    over = {"rebuild_dataset": True, "tpu.preproc_backend": "host"}
    dims = dict(num_subjects=1, num_sessions=1, num_tasks=1)
    jds = j_gw.Gwilliams2022ShallowSplit(j_syn.make_config(jroot, "Gwilliams2022", **over), wav2vec=w2v[0], **dims)
    tds = t_gw.Gwilliams2022ShallowSplit(t_syn.make_config(troot, "Gwilliams2022", **over), wav2vec=w2v[1],
                                         device="cpu", **dims)
    np.testing.assert_array_equal(tds.X["subject01_sess0"]["task0"], jds.X["subject01_sess0"]["task0"])
    np.testing.assert_allclose(tds.Y, jds.Y, **DSP)


def test_jax_cache_loads_in_port(gw, port_on_jax_cache):
    """A cache the JAX package built loads in the port to identical arrays;
    ``sample_batch`` under the same rng draws identical choices and
    batches (scale stats at their tolerance: each package computes them)."""
    jds, tds = gw[2], port_on_jax_cache
    assert tds.preproc_dir == jds.preproc_dir
    np.testing.assert_array_equal(tds.Y, jds.Y)
    for key, tasks in jds.X.items():
        for task, x in tasks.items():
            np.testing.assert_array_equal(tds.X[key][task], x)
            np.testing.assert_array_equal(tds.meg_onsets[key][task], jds.meg_onsets[key][task])
    np.testing.assert_array_equal(tds.draw_choices(np.random.default_rng(4), 9),
                                  jds.draw_choices(np.random.default_rng(4), 9))
    ids = np.array([0, 47, 3, 24, 23, 11])
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    jb, tb = jds.sample_batch(jr, ids), tds.sample_batch(tr, ids)
    for k in ("X", "Y", "subject_idxs"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    np.testing.assert_allclose(tb["scale_stats"], jb["scale_stats"], **STATS)
    assert jr.integers(1 << 30) == tr.integers(1 << 30)  # the streams stay in step


def test_gwilliams_splits_match_jax(gw):
    """Sentence (seed-keyed and legacy global rng) and deep splits on the
    port's cache: the same word sets and segment counts as the JAX package
    on its cache."""
    jroot, troot = gw[0], gw[1]
    for over in ({"resolved_seed": 7}, {"resolved_seed": 7, "split_legacy_global_rng": True}):
        jcfg, tcfg = j_syn.make_config(jroot, "Gwilliams2022", **over), t_syn.make_config(troot, "Gwilliams2022", **over)
        np.random.seed(3)
        jtr = j_gw.Gwilliams2022SentenceSplit(jcfg, **DIMS)
        np.random.seed(3)
        ttr = t_gw.Gwilliams2022SentenceSplit(tcfg, device="cpu", **DIMS)
        assert ttr.test_word_idxs_dict == jtr.test_word_idxs_dict
        tte = t_gw.Gwilliams2022SentenceSplit(tcfg, test_word_idxs_dict=ttr.test_word_idxs_dict, device="cpu", **DIMS)
        assert len(ttr) + len(tte) == len(gw[3]) and ttr.num_segments_foreach_task == jtr.num_segments_foreach_task
    for train in (True, False):
        j = j_gw.Gwilliams2022DeepSplit(j_syn.make_config(jroot, "Gwilliams2022"), train=train, **DIMS)
        t = t_gw.Gwilliams2022DeepSplit(t_syn.make_config(troot, "Gwilliams2022"), train=train, device="cpu", **DIMS)
        assert t.num_segments_foreach_task == j.num_segments_foreach_task
        np.testing.assert_allclose(t.Y, j.Y, **DSP)


def test_memory_efficient_and_in_ram_batches_identical(tmp_path, w2v):
    """memory_efficient=false (X in RAM from x_dict.npy, the shift applied
    to X) gives the batches of the default mmap parts (shift folded into the
    onsets), bit for bit."""
    root = str(tmp_path)
    t_syn.make_gwilliams_tree(root, n_subjects=1, n_sessions=2, n_tasks=1, rec_secs=20.0, n_words_per_task=8)
    dims = dict(num_subjects=1, num_sessions=2, num_tasks=1, device="cpu")
    mm = t_gw.Gwilliams2022ShallowSplit(t_syn.make_config(root, "Gwilliams2022", rebuild_dataset=True),
                                        wav2vec=w2v[1], **dims)
    ram = t_gw.Gwilliams2022ShallowSplit(t_syn.make_config(root, "Gwilliams2022", rebuild_dataset=True,
                                                           memory_efficient=False), wav2vec=w2v[1], **dims)
    assert not os.path.isdir(os.path.join(ram.preproc_dir, "_parts"))
    assert os.path.exists(os.path.join(ram.preproc_dir, "x_dict.npy"))
    b1 = mm.sample_batch(np.random.default_rng(2), np.arange(6))
    b2 = ram.sample_batch(np.random.default_rng(2), np.arange(6))
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)


def test_default_source_selection(tmp_path, monkeypatch):
    """ArrayBIDSSource without mne_bids (this environment) or with a stub
    that lacks the API; MNEBIDSSource with one that has it (its reads need
    mne, which is not installed here: only the selection rule is tested)."""
    assert isinstance(t_gw.default_source(str(tmp_path)), t_gw.ArrayBIDSSource)
    monkeypatch.setitem(sys.modules, "mne_bids", types.ModuleType("mne_bids"))
    assert isinstance(t_gw.default_source(str(tmp_path)), t_gw.ArrayBIDSSource)
    fake = types.ModuleType("mne_bids")
    fake.BIDSPath, fake.read_raw_bids = object, lambda p: None
    monkeypatch.setitem(sys.modules, "mne_bids", fake)
    src = t_gw.default_source(str(tmp_path), 3.0)
    assert isinstance(src, t_gw.MNEBIDSSource) and src.drop_overlap_sec == 3.0
    assert isinstance(j_gw.default_source(str(tmp_path)), j_gw.MNEBIDSSource)


def test_array_source_missing_recording(gw):
    root = os.path.join(gw[1], "data", "Gwilliams2022")
    assert t_gw.ArrayBIDSSource(root).read(1, 1, 0) is None
    meg, m_on, s_on, s_idx = t_gw.ArrayBIDSSource(root).read(0, 0, 0)
    jout = j_gw.ArrayBIDSSource(os.path.join(gw[0], "data", "Gwilliams2022")).read(0, 0, 0)
    for a, b in zip((meg, m_on, s_on, s_idx), jout):
        np.testing.assert_array_equal(a, b)


def test_build_needs_a_device_choice(gw):
    """Without a GPU the default device raises; nothing continues on the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_gw.Gwilliams2022ShallowSplit(t_syn.make_config(gw[1], "Gwilliams2022"), **DIMS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceResidentGwilliams(gw[3])


# -- the device-resident batcher ----------------------------------------------------------


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "int16"])
def test_device_resident_matches_jax(gw, port_on_jax_cache, store, channels_last):
    """The port's batcher against the JAX one on the same cache and stats:
    index batches and gathered X, Y, stats and subject ids bit for bit (the
    int16 scales too, the dequantized batch within 1e-6 relative); and in
    f32 against the port's own sample_batch, transposed for channels-last."""
    import jax.numpy as jnp

    jds, tds = gw[2], port_on_jax_cache
    tds.scale_stats = jds.scale_stats  # the same stats on both sides: the gather is under test
    jb = JaxResident(jds, store_dtype=jnp.dtype(store), channels_last=channels_last)
    tb = DeviceResidentGwilliams(tds, store_dtype=store, channels_last=channels_last, device="cpu")
    assert tb.X_stack.dtype == getattr(torch, store) and tuple(tb.X_stack.shape) == jb.X_stack.shape
    ids = np.array([5, 30, 0, 47, 12, 24, 23, 40])
    jidx = jb.make_index_batch(np.random.default_rng(9), ids)
    tidx = tb.make_index_batch(np.random.default_rng(9), ids)
    for k in jidx:
        np.testing.assert_array_equal(tidx[k], jidx[k], err_msg=k)
    got = {k: v.numpy() for k, v in tb.gather(tidx).items()}
    want = {k: np.asarray(v) for k, v in jb.gather(jidx).items()}
    assert got["X"].dtype == got["Y"].dtype == np.float32 and got["subject_idxs"].dtype == np.int32
    for k in ("scale_stats", "subject_idxs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if store == "int16":
        np.testing.assert_array_equal(tb.x_scale.numpy(), np.asarray(jb.x_scale))
        np.testing.assert_array_equal(tb.y_scale.numpy(), np.asarray(jb.y_scale))
        for k in ("X", "Y"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    else:
        for k in ("X", "Y"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if store == "float32":
        host = tds.sample_batch(np.random.default_rng(9), ids)
        for k in ("X", "Y"):
            np.testing.assert_array_equal(got[k].transpose(0, 2, 1) if channels_last else got[k], host[k], err_msg=k)
        for k in ("scale_stats", "subject_idxs"):
            np.testing.assert_array_equal(got[k], host[k], err_msg=k)
    assert tb.nbytes == sum(t.numel() * t.element_size() for t in
                            (tb.X_stack, tb.Y_stack, tb.stats_stack, tb.onsets_stack)) + (
        0 if store != "int16" else tb.x_scale.numel() * 4 + tb.y_scale.numel() * 4)


def test_device_resident_rejects_other_dtypes(gw):
    with pytest.raises(ValueError, match="store_dtype"):
        DeviceResidentGwilliams(gw[3], store_dtype="float16", device="cpu")


# -- Brennan2018 --------------------------------------------------------------------------


def test_brennan_build_matches_jax(tmp_path, w2v):
    """The port's Brennan build (exact-grid EEG resample, wav2vec2, robust
    scale and clamp on the CPU) against the JAX build of the same tree, for
    subject-wise and pooled scaling; the segments, the draws and the
    batches (native gather with baseline) at the DSP tolerance."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    for root in (jroot, troot):
        j_syn.make_brennan_tree(root, n_subjects_present=3, eeg_secs=20.0, audio_secs=20.0)
    for subject_wise in (True, False):
        over = {"rebuild_dataset": True, "preprocs.subject_wise": subject_wise}
        jds = j_brennan.Brennan2018Dataset(j_syn.make_config(jroot, "Brennan2018", **over), wav2vec=w2v[0])
        tds = t_brennan.Brennan2018Dataset(t_syn.make_config(troot, "Brennan2018", **over), wav2vec=w2v[1],
                                           device="cpu")
        assert (tds.num_subjects, tds.num_segments, tds.segment_len, tds.baseline_len_samp) == (
            jds.num_subjects, jds.num_segments, jds.segment_len, jds.baseline_len_samp)
        assert tds.srate == pytest.approx(jds.srate, rel=1e-12)
        np.testing.assert_allclose(tds.Y, jds.Y, **DSP)
        np.testing.assert_allclose(tds.X, jds.X, **DSP)
        ids = np.arange(min(6, len(tds)))
        jr, tr = np.random.default_rng(1), np.random.default_rng(1)
        jb, tb = jds.sample_batch(jr, ids), tds.sample_batch(tr, ids)
        np.testing.assert_array_equal(tb["subject_idxs"], jb["subject_idxs"])
        for k in ("X", "Y"):
            np.testing.assert_allclose(tb[k], jb[k], **DSP, err_msg=k)
        assert jr.integers(1 << 30) == tr.integers(1 << 30)
    # the port's cache files load in the JAX package (and back)
    back = j_brennan.Brennan2018Dataset(j_syn.make_config(troot, "Brennan2018", **{"preprocs.subject_wise": False}))
    np.testing.assert_allclose(back.X, tds.X, **DSP)
