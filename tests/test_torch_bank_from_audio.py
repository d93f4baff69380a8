"""The port's ``bank_from_audio`` against the JAX package's on the tiny
wav2vec2's weights (rtol 1e-4, atol 1e-5): the last-4-layer and feature
paths, a source rate other than 16 kHz, a clip count that is not a
``batch_size`` multiple, embeddings longer and shorter than the segment;
then the bank goes unchanged into the port's ``SpeechDecoder.set_bank``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.inference import bank_from_audio as jax_bank  # noqa: E402
from speech_decoding_tpu.models import wav2vec2 as jw  # noqa: E402
from speech_decoding_tpu.models.wav2vec_util import FrozenWav2Vec2 as JaxFrozen  # noqa: E402
from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.inference import SpeechDecoder, bank_from_audio  # noqa: E402
from speech_decoding_tpu_torch.models import wav2vec2 as pw  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import load_flax_wav2vec2  # noqa: E402
from speech_decoding_tpu_torch.models.wav2vec_util import FrozenWav2Vec2  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def embedders():
    cfg = jw.Wav2Vec2Config.tiny()
    v = jw.Wav2Vec2Model(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 1600)))
    v = jax.tree.map(np.asarray, v)
    port = load_flax_wav2vec2(pw.Wav2Vec2Model(pw.Wav2Vec2Config.tiny()), v)
    return JaxFrozen(cfg, jax.tree.map(jnp.asarray, v)), FrozenWav2Vec2(port, device="cpu")


def _clips(seed, n, length):
    return (np.random.default_rng(seed).normal(size=(n, length)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("case", ["last4_crop", "last4_pad", "features", "rate_8k", "rate_44k1"])
def test_bank_from_audio_matches_jax(embedders, case):
    """0.1 s at 16 kHz is 79 frames (790 Hz), 12 samples at 120 Hz: segment
    10 crops, 15 pads; 3 clips at batch_size 2 pad the count to 4."""
    jf, pf = embedders
    rate, length, seg, last4 = {
        "last4_crop": (16000, 1600, 10, True), "last4_pad": (16000, 1600, 15, True),
        "features": (16000, 1600, 10, False), "rate_8k": (8000, 800, 10, True),
        "rate_44k1": (44100, 4410, 15, True),
    }[case]
    wav = _clips(1, 3, length)
    got = bank_from_audio(pf, wav, rate, segment_len=seg, batch_size=2, last4layers=last4)
    want = jax_bank(jf, wav, rate, segment_len=seg, batch_size=2, last4layers=last4)
    feat = 32 if last4 else 16
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (3, feat, seg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if case == "last4_pad":
        assert not bool(got[..., 12:].any())


def test_bank_from_audio_rejects_non_2d(embedders):
    with pytest.raises(ValueError, match="mono clips"):
        bank_from_audio(embedders[1], np.zeros(1600, np.float32), 16000, segment_len=10)


def test_bank_goes_into_set_bank(embedders):
    """The (N, F, segment_len) bank feeds the port's decoder unchanged: each
    bank row, fed back as a brain embedding, retrieves itself."""
    _, pf = embedders
    bank = bank_from_audio(pf, _clips(2, 5, 1600), 16000, segment_len=12, batch_size=4)
    enc = BrainEncoder(loc=ch_locations_2d("Gwilliams2022", cache=False), num_subjects=2, D1=16, D2=16,
                       F=32, K=4, generator=torch.Generator().manual_seed(0))
    dec = SpeechDecoder(enc, device="cpu")
    dec.set_bank(bank)
    assert dec.bank_size == 5
    scores, ids = dec.retrieve(bank, k=3)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(5))
    np.testing.assert_allclose(scores[:, 0].numpy(), 1.0, rtol=1e-5)
    X = np.random.default_rng(3).normal(size=(2, 208, 12)).astype(np.float32)
    s, i = dec.decode(X, np.zeros(2, np.int32), k=3)
    assert s.shape == i.shape == (2, 3) and np.isfinite(s).all() and (i < 5).all()
