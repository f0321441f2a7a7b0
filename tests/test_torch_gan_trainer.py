"""PyTorch port, the GAN vocoder trainer end to end on the CPU:
`amphion_tpu_torch.bins.vocoder.train.main` for two steps on a tiny
synthetic corpus (clips longer than a segment, so crops are drawn), a
checkpoint at each step, a resume from the first that repeats the second
step's losses, the checkpoint read back by `restore_generator` and by the
vocoder inference CLI, and the parts that are not ported (a bf16
``compute_dtype``, DiffWave) raising. The CPU
runs are deterministic, so the resumed losses are held to 1e-6 relative.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from amphion_tpu_torch.bins.vocoder import inference
from amphion_tpu_torch.bins.vocoder.train import main
from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.data.metadata import Utterance, save_metadata
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.vocoder_trainer import restore_generator
from amphion_tpu_torch.utils.config import load_config

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 8000
KEYS = ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six clips of 300-500 samples (longer than the 256-sample segment) and
    a config over egs/vocoder/gan/bigvgan cut to a 32-channel BigVGAN with
    rates (4, 2), an 8 kHz mel with hop 8, and MPD (periods 2, 3) + one MSD
    scale at a sixteenth of their width."""
    root = tmp_path_factory.mktemp("gan_train")
    rng = np.random.default_rng(0)
    utts = []
    for i in range(6):
        n = int(rng.integers(300, 500))
        x = 0.3 * np.sin(np.arange(n) * rng.uniform(0.05, 0.3)) + 0.02 * rng.standard_normal(n)
        save_wav(root / "wav" / f"{i}.wav", x.astype(np.float32), SR)
        utts.append(Utterance("tiny", f"u{i}", str(root / "wav" / f"{i}.wav"), n / SR))
    save_metadata(root / "data" / "tiny" / "train.json", utts)

    def config(name: str, model: dict | None = None, **train) -> Path:
        cfg = {"base_config": str(REPO / "egs/vocoder/gan/bigvgan/exp_config.json"),
               "dataset": ["tiny"], "log_dir": str(root / "ckpts"),
               "preprocess": {"processed_dir": str(root / "data"), "sample_rate": SR,
                              "n_fft": 64, "win_size": 32, "hop_size": 8, "n_mel": 16,
                              "fmax": 4000},
               "model": {"bigvgan": {"upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
                                     "upsample_initial_channel": 32,
                                     "resblock_kernel_sizes": [3],
                                     "resblock_dilation_sizes": [[1, 3]]},
                         "mpd_periods": [2, 3], "msd_scales": 1,
                         "discriminator_channel_mult_factor": 0.0625, **(model or {})},
               "train": {"batch_size": 2, "segment_frames": 32, "log_interval": 1,
                         "metrics_path": str(root / f"{name}.jsonl"), **train}}
        path = root / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return path

    return root, config


def _metrics(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_gan_trainer_two_steps_save_resume_and_synthesize(corpus):
    root, config = corpus
    trainer = main(["--config", str(config("run", max_steps=2, save_checkpoints_steps=1)),
                    "--exp_name", "run", "--device", "cpu"])
    rows = _metrics(root / "run.jsonl")
    assert len(rows) == 2 and all(np.isfinite(r[k]) for r in rows for k in KEYS)
    assert all(abs(r["g_loss"] - r["g_adv"] - r["g_fm"] - r["g_mel"]) <= 1e-4 * r["g_loss"]
               for r in rows)
    states = trainer.loop.states
    assert trainer.loop.step == states["g"].step == states["d"].step == 2
    assert states["g"].optimizer.count == states["d"].optimizer.count == 2

    ckdir = root / "ckpts" / "run" / "checkpoint"
    names = sorted(p.name for p in ckdir.glob("epoch-*"))
    assert [n.split("_")[1] for n in names] == ["step-0000001", "step-0000002"]
    saved, _, _ = CheckpointManager(ckdir).restore_raw(str(ckdir / names[0]))
    assert set(saved) == {"g", "d", "epoch", "batch_in_epoch"}
    assert set(saved["g"]) == set(saved["d"]) == {"model", "step", "optimizer", "generator"}
    assert (root / "ckpts" / "run" / "exp_config.json").is_file()

    # the resume from step 1, in a run directory of its own, repeats step 2
    again = main(["--config", str(config("resume", max_steps=2)), "--exp_name", "resume",
                  "--resume", "--resume_from_ckpt_path", str(ckdir / names[0]),
                  "--device", "cpu"])
    rerun = _metrics(root / "resume.jsonl")
    assert len(rerun) == 1 and again.loop.states["d"].step == 2
    for k in KEYS:
        assert abs(rerun[0][k] - rows[1][k]) <= 1e-6 * abs(rows[1][k]), k

    # the generator's half is what inference reads
    cfg = load_config(root / "ckpts" / "run" / "exp_config.json")
    gen, hop, epoch, step = restore_generator(cfg, ckdir, 16, torch.device("cpu"))
    assert (hop, step) == (8, 2)
    for (name, p), q in zip(gen.state_dict().items(), states["g"].model.state_dict().values()):
        assert torch.equal(p, q), name
    records = inference.main(["--config", str(root / "ckpts" / "run" / "exp_config.json"),
                              "--checkpoint_path", str(ckdir), "--output_dir",
                              str(root / "out"), "--mode", "from_audio", "--audio_dir",
                              str(root / "wav"), "--device", "cpu"])
    assert len(records) == 6
    for r in records:
        wav, sr = load_wav(r["path"], sr=SR)
        assert sr == SR and len(wav) == r["samples"] > 0 and np.isfinite(wav).all()


@pytest.mark.parametrize("change,match", [
    ({"train": {"compute_dtype": "bfloat16"}}, "ROADMAP.md A5"),
    ({"model_type": "DiffusionVocoder"}, "ROADMAP.md A5"),
], ids=["bf16", "diffwave"])
def test_gan_trainer_raises_where_not_ported(corpus, change, match):
    root, config = corpus
    path = config("todo", model=change.get("model"), max_steps=1, **change.get("train", {}))
    if "model_type" in change:
        cfg = json.loads(path.read_text())
        cfg["model_type"] = change["model_type"]
        path.write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match=match):
        main(["--config", str(path), "--exp_name", "todo", "--device", "cpu"])
