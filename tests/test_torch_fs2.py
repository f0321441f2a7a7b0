"""PyTorch port, FastSpeech2 on the CPU against the JAX package: the model
with given durations and with predicted ones (``d_control``), its loss, one
trainer step from a synthetic TextGrid corpus, the TextGrid reader,
Griffin-Lim's mel inversion, and the CLIs (preprocess → train → inference
with Griffin-Lim and with a HiFi-GAN checkpoint).

The same numpy inputs and, through `utils/convert.from_flax`, the same
weights (random leaves in the Flax init's shapes, from ``jax.eval_shape``;
the pitch and energy bins kept at their sorted initial boundaries) go to
both. Tolerances (float32): 1e-4 absolute, or 1e-4 of max|ref| where that
exceeds 1; frame masks, TextGrid phones and durations exactly; the trainer
step's parameter updates within 1 % of lr on at least 1 − 1e-3 of the
elements (Adam's first update is about lr·sign(g)). JAX compiles with most
XLA optimizations off (`quick_xla`).
"""

import copy
import functools
import json
import types
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.data.processors import duration as jduration
from amphion_tpu.models.tts.fastspeech2 import fs2 as jfs2
from amphion_tpu.ops.dsp import mel_to_audio as j_mel_to_audio
from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.ops.mel import mel_filterbank as j_mel_filterbank
from amphion_tpu.runtime.tts_trainer import FastSpeech2Trainer as JFastSpeech2Trainer
from amphion_tpu.utils.config import JsonHParams
from amphion_tpu_torch.bins.tts import inference as port_infer
from amphion_tpu_torch.bins.tts import preprocess as port_pre
from amphion_tpu_torch.bins.tts import train as port_train
from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.data.processors import duration
from amphion_tpu_torch.models.tts.fastspeech2 import fs2
from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
from amphion_tpu_torch.ops.dsp import mel_to_audio
from amphion_tpu_torch.ops.mel import MelConfig
from amphion_tpu_torch.runtime.tts_trainer import FastSpeech2Trainer
from amphion_tpu_torch.runtime.vocoder_trainer import save_generator
from amphion_tpu_torch.utils.config import load_config, save_config
from amphion_tpu_torch.utils.convert import from_flax, init_like_flax
from test_torch_tts_losses import quick_xla
from test_torch_vits import close, fill, masks, quick_trace

torch.set_num_threads(1)  # one xdist worker per core

T = torch.from_numpy
REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_phones=30, hidden=32, n_enc_layers=2, n_dec_layers=2, n_heads=2,
             ffn_hidden=64, kernel_size=9, n_mel=8, max_frames=40, pitch_bins=16,
             energy_bins=16, n_speakers=3, variance_hidden=32)
B, L = 2, 6
SR, HOP = 8000, 8
PREPROCESS = {"sample_rate": SR, "n_mel": 8, "n_fft": 64, "win_size": 32, "hop_size": HOP,
              "fmin": 0, "fmax": 4000, "f0_min": 50, "f0_max": 1100}
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _quick_xla():
    with quick_xla(), quick_trace():
        yield


def fs2_tree(module, seed, *args):
    """A Flax tree of ``module``'s init shapes with random leaves, its bins
    the sorted initial ones."""
    init = functools.partial(flax.linen.Module.init, module)
    shapes = jax.eval_shape(init, jax.random.key(0), *args)["params"]
    tree = fill(shapes, seed)
    c = module.cfg
    tree["variance"]["pitch_bins"] = jfs2._default_bins(
        c.pitch_min, c.pitch_max, c.pitch_bins, c.pitch_quantization).astype(np.float32)
    tree["variance"]["energy_bins"] = jfs2._default_bins(
        c.energy_min, c.energy_max, c.energy_bins, c.energy_quantization).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=1)
def tiny_fs2():
    """(JAX model, tree, port model, batch): phones with padding, durations
    (a row longer than max_frames), pitch and energy targets."""
    jm = jfs2.FastSpeech2(jfs2.FastSpeech2Config(**SMALL))
    rng = np.random.default_rng(1)
    pm = masks(rng, B, L, [6, 4])
    phones = (rng.integers(1, 30, (B, L)) * pm).astype(np.int32)
    durs = (rng.integers(0, 5, (B, L)) * pm).astype(np.int32)
    durs[0, 2] = 30  # the row's frames pass max_frames: cut
    pitch = rng.standard_normal((B, 40)).astype(np.float32)
    energy = rng.standard_normal((B, 40)).astype(np.float32)
    sid = np.array([1, 2], np.int32)
    batch = {"phones": phones, "phone_mask": pm, "durations": durs, "pitch": pitch,
             "energy": energy, "sid": sid,
             "mel": rng.standard_normal((B, 40, 8)).astype(np.float32)}
    tree = fs2_tree(jm, 2, phones, pm, durs, pitch, energy, sid)
    return jm, tree, from_flax(fs2.FastSpeech2(fs2.FastSpeech2Config(**SMALL)), tree), batch


def _torch(batch):
    out = {k: T(v) for k, v in batch.items()}
    for k in ("phones", "sid", "durations"):
        out[k] = out[k].long()
    return out


def test_forward_with_durations_and_its_loss_match_jax():
    jm, tree, model, batch = tiny_fs2()

    @jax.jit
    def ref_fn(params, b):
        out = jm.apply({"params": params}, b["phones"], b["phone_mask"], b["durations"],
                       b["pitch"], b["energy"], b["sid"])
        return out, jfs2.fastspeech2_loss(out, b)

    ref, (jloss, jparts) = ref_fn(tree, batch)
    tb = _torch(batch)
    with torch.no_grad():
        out = model(tb["phones"], tb["phone_mask"], tb["durations"], tb["pitch"],
                    tb["energy"], tb["sid"])
        loss, parts = fs2.fastspeech2_loss(out, tb)
    assert np.array_equal(out["frame_mask"].numpy(), np.asarray(ref["frame_mask"]))
    for k in ("mel", "mel_postnet", "log_duration_pred", "pitch_pred", "energy_pred"):
        close(out[k], ref[k], what=k)
    close(loss, jloss, what="loss")
    for k, v in parts.items():
        close(v, jparts[k], what=k)


def test_infer_with_d_control_matches_jax():
    """Predicted durations (× 1.8), pitch and energy: the frame mask exact,
    the mels within tolerance."""
    jm, tree, model, batch = tiny_fs2()
    ref = jax.jit(lambda p, ph, pm, sid: jm.apply({"params": p}, ph, pm, sid=sid,
                                                  d_control=1.8))(
        tree, batch["phones"], batch["phone_mask"], batch["sid"])
    tb = _torch(batch)
    with torch.no_grad():
        out = model(tb["phones"], tb["phone_mask"], sid=tb["sid"], d_control=1.8)
    assert np.array_equal(out["frame_mask"].numpy(), np.asarray(ref["frame_mask"]))
    assert out["frame_mask"].sum() > 0
    for k in ("mel", "mel_postnet", "pitch_pred", "energy_pred"):
        close(out[k], ref[k], what=k)


def test_init_like_flax_draws_the_raw_leaves():
    """The bins start at their boundaries, Postnet's affine at (1, 0), and
    every parameter is drawn."""
    model = init_like_flax(fs2.FastSpeech2(fs2.FastSpeech2Config(**SMALL)),
                           torch.Generator().manual_seed(0))
    want = jfs2._default_bins(-4.0, 4.0, 16, "linear").astype(np.float32)
    assert np.array_equal(model.variance.pitch_bins.detach().numpy(), want)
    assert torch.equal(model.postnet.bn_3_scale, torch.ones(512))
    assert torch.equal(model.postnet.bn_3_bias, torch.zeros(512))


# -- TextGrids ----------------------------------------------------------------------------


def write_textgrid(path, phones: list[str], frames: list[int], hop: int = HOP,
                   sr: int = SR) -> None:
    """A long-format Praat TextGrid (what MFA writes): a words tier and a
    phones tier whose intervals last ``frames`` hops each."""
    edges = np.concatenate([[0], np.cumsum(frames)]) * hop / sr
    end = edges[-1]

    def tier(i, name, labels, bounds):
        rows = [f'    item [{i}]:', '        class = "IntervalTier" ',
                f'        name = "{name}" ', '        xmin = 0 ', f'        xmax = {end} ',
                f'        intervals: size = {len(labels)} ']
        for j, lab in enumerate(labels):
            rows += [f'        intervals [{j + 1}]:', f'            xmin = {bounds[j]} ',
                     f'            xmax = {bounds[j + 1]} ', f'            text = "{lab}" ']
        return rows

    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', '', 'xmin = 0 ',
             f'xmax = {end} ', 'tiers? <exists> ', 'size = 2 ', 'item []: ']
    lines += tier(1, "words", ["word"], [0.0, end])
    lines += tier(2, "phones", phones, list(edges))
    Path(path).write_text("\n".join(lines) + "\n")


def test_textgrid_reader_matches_jax(tmp_path):
    path = tmp_path / "a.TextGrid"
    write_textgrid(path, ["", "h", "e", "sp", "l", "spn", "o"], [3, 5, 2, 4, 7, 1, 6], hop=120,
                   sr=24000)
    for tier in ("phones", "words"):
        assert duration.parse_textgrid(path, tier) == jduration.parse_textgrid(path, tier)
    phones, durs = duration.textgrid_to_durations(path, 120, 24000)
    jphones, jdurs = jduration.textgrid_to_durations(path, 120, 24000)
    assert phones == jphones == ["sil", "h", "e", "sil", "l", "sil", "o"]
    assert np.array_equal(durs, jdurs) and durs.tolist() == [3, 5, 2, 4, 7, 1, 6]
    with pytest.raises(ValueError, match="tier"):
        duration.parse_textgrid(path, "syllables")


# -- Griffin-Lim -----------------------------------------------------------------------------


def test_mel_to_audio_matches_jax_with_its_initial_phase():
    """`mel_to_audio` (32 Griffin-Lim iterations over the centered STFT and
    the ``"center"`` iSTFT) with the phase JAX draws from ``key(0)``."""
    cfg = dict(sample_rate=SR, n_fft=64, win_size=32, hop_size=HOP, n_mel=8, fmax=4000)
    rng = np.random.default_rng(3)
    log_mel = (rng.standard_normal((2, 8, 30)) - 2.0).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(j_mel_to_audio, cfg=JMelConfig(**cfg)))(
        jnp.asarray(log_mel)))
    fb = j_mel_filterbank(SR, 64, 8, 0.0, 4000.0)
    mag_shape = (2, np.asarray(fb).shape[1], 30)
    phase = np.asarray(jax.random.uniform(jax.random.key(0), mag_shape) * 2 * jnp.pi)
    out = mel_to_audio(T(log_mel), MelConfig(**cfg), init_phase=T(phase))
    assert out.shape == (2, HOP * 29)
    close(out, ref, what="griffin-lim")


# -- the trainer and the CLIs --------------------------------------------------------------------


TEXTS = ["hello world", "good morning", "a tiny corpus", "the quick fox",
         "lazy dog jumps", "speech again"]
TINY = {"fastspeech2": {"hidden": 32, "n_enc_layers": 1, "n_dec_layers": 1, "n_heads": 2,
                        "ffn_hidden": 64, "kernel_size": 9}}


def write_corpus(root, n: int = 6, seed: int = 0) -> None:
    """``n`` LJSpeech clips of 560-760 samples (70-95 frames) and a
    TextGrid for each under ``processed/ljspeech/textgrids``: the char
    G2P's symbols, a space as ``sp``, frames split over them."""
    rng = np.random.default_rng(seed)
    (root / "raw" / "wavs").mkdir(parents=True, exist_ok=True)
    tg_dir = root / "processed" / "ljspeech" / "textgrids"
    tg_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n):
        uid, text = f"LJ002-{i:04d}", TEXTS[i % len(TEXTS)]
        frames = int(rng.integers(70, 96))
        t = np.arange(frames * HOP) / SR
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 260) * t) + 0.02 * rng.standard_normal(
            t.shape)
        save_wav(root / "raw" / "wavs" / f"{uid}.wav", x.astype(np.float32), SR)
        rows.append(f"{uid}|{text}|{text}")
        phones = ["sp" if c == " " else c for c in text]
        cuts = np.sort(rng.choice(np.arange(1, frames), len(phones) - 1, replace=False))
        write_textgrid(tg_dir / f"{uid}.TextGrid", phones,
                       np.diff(np.concatenate([[0], cuts, [frames]])).tolist())
    (root / "raw" / "metadata.csv").write_text("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus through `bins/tts/preprocess.py` (the FastSpeech2 recipe's
    switches: mels, F0, energy, phones) → (root, config path)."""
    root = tmp_path_factory.mktemp("fs2_cli")
    write_corpus(root)
    cfg = {"base_config": str(REPO / "config/fs2.json"), "dataset": ["ljspeech"],
           "dataset_path": {"ljspeech": str(root / "raw")}, "log_dir": str(root / "ckpts"),
           "preprocess": {**PREPROCESS, "processed_dir": str(root / "processed")},
           "model": TINY, "train": {"batch_size": 2, "max_frames": 80, "max_steps": 1,
                                    "log_interval": 1, "seed": 0, "adamw": {"lr": LR}}}
    path = root / "fs2.json"
    path.write_text(json.dumps(cfg))
    port_pre.main(["--config", str(path), "--device", "cpu"])
    return root, str(path)


def test_trainer_step_matches_jax(corpus, monkeypatch):
    """`FastSpeech2Trainer` against JAX's on the same TextGrids: the symbol
    table, the first batch of epoch 0 (phones and durations equal, mel,
    pitch and energy within 1e-4), the loss parts, and the updates of one
    step from the same weights."""
    root, path = corpus
    cfg = load_config(path)
    trees = {}

    def init(self, *a, **k):
        return {"params": trees.setdefault("fs2", fs2_tree(self, 4, *a[1:]))}
    monkeypatch.setattr(jfs2.FastSpeech2, "init", init)
    jt = JFastSpeech2Trainer(types.SimpleNamespace(exp_name="jax_fs2", resume=False),
                             JsonHParams(**cfg))
    trainer = FastSpeech2Trainer(types.SimpleNamespace(exp_name="fs2_step", resume=False,
                                                       device="cpu"), cfg)
    assert trainer.symbols.symbols == jt.symbols.symbols
    model = from_flax(trainer.loop.states.model, trees["fs2"])
    start = copy.deepcopy(model)
    utts = trainer._epoch_utts(0)[0]
    jbatch = jt._make_batch(utts)
    batch = trainer.make_batch(utts)
    for k in ("phones", "phone_mask", "durations", "sid"):
        assert np.array_equal(batch[k].numpy(), np.asarray(jbatch[k])), k
    for k in ("mel", "pitch", "energy"):
        close(batch[k], jbatch[k], what=k)
    jstate, jaux = jt.loop.train_step(jt.state, jbatch)
    _, aux = trainer.step(trainer.loop.states, batch)
    for k, v in jaux.items():
        close(aux[k], v, what=k)
    ref = from_flax(copy.deepcopy(model), jax.tree_util.tree_map(np.asarray, jstate.params))
    total = off = 0
    for p, r, s in zip(model.parameters(), ref.parameters(), start.parameters()):
        d = ((p - s) - (r - s)).abs().detach()
        total += d.numel()
        off += int((d > 0.01 * LR).sum())
    assert off <= 1e-3 * total, f"{off} of {total} updates differ by > 1 % of lr"


def test_cli_preprocess_train_infer(corpus):
    """``--device cpu``: one step through `bins/tts/train.py` (a checkpoint
    and ``symbols.dict``), then `bins/tts/inference.py` with Griffin-Lim
    ((frames − 1) · hop samples) and with a HiFi-GAN checkpoint (frames ·
    hop samples), the frame count the model's own mask."""
    root, path = corpus
    trainer = port_train.main(["--config", path, "--exp_name", "fs2", "--device", "cpu"])
    assert trainer.loop.step == 1
    assert (root / "ckpts" / "fs2" / "symbols.dict").is_file()
    text = "hello fox"
    with torch.no_grad():
        ids = port_infer.G2PModule("char").to_ids(text, trainer.symbols)
        ph = torch.tensor(ids)[None]
        frames = int(trainer.loop.states.model.eval()(ph, torch.ones_like(
            ph, dtype=torch.float32))["frame_mask"].sum())
    assert frames > 1
    voc_dir = root / "hifigan"
    gen = HiFiGANGenerator(HiFiGANConfig(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                                         upsample_initial_channel=16,
                                         resblock_kernel_sizes=(3,),
                                         resblock_dilation_sizes=((1,),), n_mel=8))
    init_like_flax(gen, torch.Generator().manual_seed(0))
    save_generator(voc_dir / "checkpoint", gen)
    save_config(voc_dir / "exp_config.json", {
        "preprocess": PREPROCESS, "model": {"generator": "hifigan", "hifigan": {
            "resblock": "1", "upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
            "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
            "resblock_dilation_sizes": [[1]]}}})
    for name, extra, want in (("gl", [], (frames - 1) * HOP),
                              ("voc", ["--vocoder_ckpt", str(voc_dir / "checkpoint")],
                               frames * HOP)):
        out = root / f"{name}.wav"
        port_infer.main(["--config", path, "--exp_name", "fs2", "--text", text,
                         "--output_path", str(out), "--device", "cpu", *extra])
        wav, sr = load_wav(out)
        assert sr == SR and len(wav) == want and np.isfinite(wav).all(), (name, len(wav))
