"""PyTorch port, TTS preprocessing (`bins/tts/preprocess.py`) against the
JAX package on the CPU, on a tiny LibriTTS-layout corpus.

The corpus adapter's splits, the phone ids and ``symbols.dict`` must be
equal; the mels, energies and F0 within 1e-4; codes (a tiny Amphion codec)
and semantic tokens (a tiny RepCodec over the mel) equal and the semantic
latents within 1e-4, the port's codecs carrying the JAX weights through
`utils/convert.from_flax`. The clips all pad to one length, so each JAX
extractor compiles once, with most XLA optimizations off (`quick_xla`).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.data.preprocessors import preprocess_dataset as j_preprocess_dataset
from amphion_tpu.data.processors.acoustic import (
    extract_acoustic_features as j_extract_acoustic_features,
)
from amphion_tpu.data.processors.phone import extract_phone_sequences as j_extract_phones
from amphion_tpu.models.codec.amphion_codec import AmphionCodec as JCodec
from amphion_tpu.models.codec.amphion_codec import CodecConfig as JCodecConfig
from amphion_tpu.models.codec.repcodec import RepCodec as JRepCodec
from amphion_tpu.models.codec.repcodec import RepCodecConfig as JRepCodecConfig
from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.utils.config import JsonHParams
from amphion_tpu.utils.logging import get_logger as j_get_logger
from amphion_tpu_torch.bins.tts import preprocess as port_pre
from amphion_tpu_torch.bins.tts.inference import _codec_config
from amphion_tpu_torch.data.audio_io import save_wav
from amphion_tpu_torch.data.metadata import load_metadata
from amphion_tpu_torch.data.preprocessors import preprocess_dataset
from amphion_tpu_torch.data.processors.acoustic import extract_acoustic_features
from amphion_tpu_torch.data.processors.phone import extract_phone_sequences
from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec
from amphion_tpu_torch.models.codec.repcodec import RepCodec
from amphion_tpu_torch.ops.mel import MelConfig
from amphion_tpu_torch.utils.convert import from_flax
from amphion_tpu_torch.utils.logging import get_logger
from test_torch_tts_losses import quick_xla

torch.set_num_threads(1)  # one xdist worker per core

SR = 8000
TEXTS = ["hello world", "good morning to you", "synthetic speech, again!",
         "a tiny corpus", "the quick brown fox", "jumps over the lazy dog"]
PREPROCESS = {"sample_rate": SR, "n_mel": 16, "n_fft": 64, "win_size": 32, "hop_size": 8,
              "fmin": 0, "fmax": 4000, "f0_min": 50, "f0_max": 1100, "phone_dir": "phones",
              "symbols_dict": "symbols.dict", "semantic_source": "mel"}
MODEL = {"codec": {"strides": [2, 4], "num_quantizers": 3, "codebook_size": 16,
                   "codebook_dim": 4, "encoder_dim": 4, "latent_dim": 8, "decoder_dim": 4},
         "semantic_codec": {"codebook_size": 16, "hidden": 8, "codebook_dim": 4,
                            "num_blocks": 1}}


def write_libritts(root, n=6, seed=0):
    """``n`` clips in LibriTTS's layout (<split>/<spk>/<chapter>/<uid>.wav +
    .normalized.txt), 1 300-1 480 samples: one codec and mel padding bucket
    (1 536), 162-185 frames."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        spk, chap = 100 + i % 2, 7
        d = root / "train-clean-100" / str(spk) / str(chap)
        d.mkdir(parents=True, exist_ok=True)
        uid = f"{spk}_{chap}_{i:06d}"
        t = np.arange(int(rng.integers(1300, 1480))) / SR
        f0 = rng.uniform(120, 260)
        x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(t.shape)
        save_wav(d / f"{uid}.wav", x.astype(np.float32), SR)
        (d / f"{uid}.normalized.txt").write_text(TEXTS[i % len(TEXTS)])


def corpus_config(root, processed, **extra) -> dict:
    return {"dataset": ["libritts"], "dataset_path": {"libritts": str(root / "raw")},
            "log_dir": str(root / "ckpts"), "preprocess": {**PREPROCESS,
                                                           "processed_dir": str(processed)},
            "model": MODEL, **extra}


@pytest.fixture(scope="module", autouse=True)
def _quick_xla():
    with quick_xla():
        yield


def jax_codecs():
    """Weights for the codecs in the shapes of their Flax inits (traced by
    ``jax.eval_shape``, not compiled): random normal leaves, scaled by
    √fan_in for kernels; the codebooks unit normal."""
    rng = np.random.default_rng(5)

    def tree(module, x):
        shapes = jax.eval_shape(module.init, jax.random.key(0), x)["params"]

        def leaf(path, s):
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if path[-1].key == "kernel" else 1.0
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        return jax.tree_util.tree_map_with_path(leaf, shapes)

    jc = JCodec(JCodecConfig(sample_rate=SR, strides=(2, 4), num_quantizers=3,
                             codebook_size=16, codebook_dim=4, encoder_dim=4, latent_dim=8,
                             decoder_dim=4))
    js = JRepCodec(JRepCodecConfig(feature_dim=16, hidden=8, codebook_size=16, codebook_dim=4,
                                   num_blocks=1))
    return tree(jc, jnp.zeros((1, 8 * 4))), tree(js, jnp.zeros((1, 8, 16)))


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """The corpus through JAX's preprocessing and the port's, each into
    its own processed directory. JAX's extractors, which draw their codecs
    with ``init`` when given no checkpoint, get `jax_codecs`'s weights, and
    so does the port."""
    root = tmp_path_factory.mktemp("tts_pre")
    cparams, sparams = jax_codecs()
    mp = pytest.MonkeyPatch()
    mp.setattr(JCodec, "init", lambda self, *a, **k: {"params": cparams})
    mp.setattr(JRepCodec, "init", lambda self, *a, **k: {"params": sparams})
    write_libritts(root / "raw")
    out = {}
    mel_kw = dict(extract_f0=True, extract_energy=True)
    jtrain, jtest = j_preprocess_dataset("libritts", str(root / "raw"), str(root / "jax"))
    j_extract_acoustic_features(jtrain + jtest, root / "jax" / "libritts",
                                JMelConfig.from_preprocess_cfg(JsonHParams(**PREPROCESS)),
                                **mel_kw)
    j_extract_phones(jtrain + jtest, root / "jax" / "libritts")
    from bins.tts.preprocess import extract_codes as j_codes
    from bins.tts.preprocess import extract_semantic as j_semantic
    jcfg = JsonHParams(**corpus_config(root, root / "jax"))
    j_codes(jtrain + jtest, root / "jax" / "libritts", jcfg, "", j_get_logger("t"))
    j_semantic(jtrain + jtest, root / "jax" / "libritts", jcfg, "", j_get_logger("t"))
    mp.undo()

    train, test = preprocess_dataset("libritts", str(root / "raw"), str(root / "port"))
    d = root / "port" / "libritts"
    extract_acoustic_features(train + test, d, MelConfig.from_preprocess_cfg(PREPROCESS),
                              device="cpu", **mel_kw)
    extract_phone_sequences(train + test, d)
    cfg = corpus_config(root, root / "port")
    codec = from_flax(AmphionCodec(_codec_config(cfg)), cparams)
    sem = from_flax(RepCodec(port_pre.semantic_codec_config(cfg), with_decode=True), sparams)
    log = get_logger("t")
    port_pre.extract_codes(train + test, d, cfg, "", log, "cpu", codec=codec)
    port_pre.extract_semantic(train + test, d, cfg, "", log, "cpu", codec=sem)
    out.update(root=root, jax=root / "jax" / "libritts", port=d,
               uids=[u.uid for u in train + test])
    return out


def test_splits_metadata_and_phones_equal(processed):
    j, p = processed["jax"], processed["port"]
    for split in ("train", "test"):
        assert (json.loads((p / f"{split}.json").read_text())
                == json.loads((j / f"{split}.json").read_text()))
    assert [u.uid for u in load_metadata(p / "test.json")]  # the seeded split has a test row
    assert (p / "symbols.dict").read_text() == (j / "symbols.dict").read_text()
    for uid in processed["uids"]:
        ids = json.loads((p / "phones" / f"{uid}.json").read_text())
        assert ids and ids == json.loads((j / "phones" / f"{uid}.json").read_text())


def test_acoustic_features_match(processed):
    j, p = processed["jax"], processed["port"]
    for uid in processed["uids"]:
        for feat in ("mels", "energy", "f0"):
            a, b = np.load(p / feat / f"{uid}.npy"), np.load(j / feat / f"{uid}.npy")
            assert a.shape == b.shape, (feat, a.shape, b.shape)
            np.testing.assert_allclose(a, b, atol=1e-4 * max(1.0, np.abs(b).max()),
                                       rtol=0, err_msg=f"{feat} {uid}")
        np.testing.assert_array_equal(np.load(p / "uv" / f"{uid}.npy"),
                                      np.load(j / "uv" / f"{uid}.npy"))


def test_codes_and_semantic_tokens_equal(processed):
    j, p = processed["jax"], processed["port"]
    for uid in processed["uids"]:
        codes = np.load(p / "codes" / f"{uid}.npy")
        assert codes.dtype == np.int32 and codes.shape[0] == 3 and len(np.unique(codes)) > 1
        np.testing.assert_array_equal(codes, np.load(j / "codes" / f"{uid}.npy"))
        sem = np.load(p / "semantic" / f"{uid}.npy")
        assert sem.dtype == np.int32 and sem.shape == (codes.shape[1],)
        np.testing.assert_array_equal(sem, np.load(j / "semantic" / f"{uid}.npy"))
        np.testing.assert_allclose(np.load(p / "semantic_feats" / f"{uid}.npy"),
                                   np.load(j / "semantic_feats" / f"{uid}.npy"), atol=1e-4)


def test_cli_runs_every_stage(processed, tmp_path):
    """`main` as a user runs it (random codecs, seed 0, with a warning)
    writes every stage's files for every utterance."""
    cfg = corpus_config(processed["root"], tmp_path / "out")
    cfg["dataset_path"]["libritts"] = str(processed["root"] / "raw")
    cfg["preprocess"]["extract_phone"] = True
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    port_pre.main(["--config", str(path), "--extract_codes", "--extract_semantic",
                   "--device", "cpu"])
    d = tmp_path / "out" / "libritts"
    for uid in processed["uids"]:
        for sub, ext in (("mels", "npy"), ("phones", "json"), ("codes", "npy"),
                         ("semantic", "npy"), ("semantic_feats", "npy")):
            assert (d / sub / f"{uid}.{ext}").is_file(), (sub, uid)


def test_unported_paths_raise_with_their_label(tmp_path):
    with pytest.raises(NotImplementedError, match="A6.7"):
        preprocess_dataset("vctk", str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(ValueError, match="unsupported dataset"):
        preprocess_dataset("no_such_corpus", str(tmp_path), str(tmp_path / "out"))
    cfg = corpus_config(tmp_path, tmp_path / "out")
    log = types.SimpleNamespace(info=print, warning=print)
    with pytest.raises(NotImplementedError, match="A6.5"):
        port_pre.extract_codes([], tmp_path, {**cfg, "model": {"codec": {"type": "encodec"}}},
                               "", log, "cpu")
    cfg["preprocess"]["semantic_source"] = "w2v_bert"
    with pytest.raises(NotImplementedError, match="A6.2"):
        port_pre.extract_semantic([], tmp_path, cfg, "", log, "cpu")
    with pytest.raises(NotImplementedError, match="A6.7"):
        extract_acoustic_features([], tmp_path, MelConfig.from_preprocess_cfg(PREPROCESS),
                                  pitch_extractor="pyin", device="cpu")
