"""PyTorch port, the Vevo trainers end to end on the CPU: two steps of each
stage through `amphion_tpu_torch.bins.vc.train.main` on a tiny synthetic
corpus, a checkpoint at every step, and a resume from the first one that
repeats the second step's loss; plus the loop's and the checkpoint
manager's rules. The CPU runs are deterministic, so the resumed loss is
held to 1e-6 relative.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from amphion_tpu_torch.bins.vc.train import main
from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.data.dataset import Prefetcher, SegmentAudioDataset
from amphion_tpu_torch.data.metadata import Utterance, load_metadata, save_metadata
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager, parse_ckpt_name
from amphion_tpu_torch.runtime.loop import LoopConfig, TrainLoop

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


REPO = Path(__file__).resolve().parents[1]
SR = 24000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six 0.1 s clips (shorter than the 0.12 s segment: no random offsets) and a
    config that cuts config/vevo.json to 2 layers of width 64."""
    root = tmp_path_factory.mktemp("vevo_train")
    rng = np.random.default_rng(0)
    utts = []
    for i in range(6):
        t = np.arange(2400) / SR
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(90, 400) * t) + 0.02 * rng.standard_normal(t.size)
        save_wav(root / "wav" / f"{i}.wav", x, SR)
        utts.append(Utterance("tiny", f"u{i}", str(root / "wav" / f"{i}.wav"), 0.1))
    save_metadata(root / "data" / "tiny" / "train.json", utts)

    def config(name: str, **train) -> Path:
        cfg = {"base_config": str(REPO / "config" / "vevo.json"), "dataset": ["tiny"],
               "log_dir": str(root / "ckpts"),
               "preprocess": {"processed_dir": str(root / "data")},
               "model": {"ar": {"hidden": 64, "num_layers": 2, "num_heads": 4},
                         "fm": {"hidden": 64, "num_layers": 2, "num_heads": 4},
                         "style_tokenizer": {"hidden": 32},
                         "content_tokenizer": {"hidden": 32}},
               "train": {"batch_size": 2, "segment_frames": 24, "max_content_tokens": 24,
                         "log_interval": 1, "metrics_path": str(root / f"{name}.jsonl"),
                         **train}}
        path = root / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return path

    return root, utts, config


def _losses(path: Path, key: str) -> list[float]:
    return [json.loads(line)[key] for line in path.read_text().splitlines()]


@pytest.mark.parametrize("model_type,key", [("FlowMatchingTransformer", "fm_loss"),
                                            ("AutoregressiveTransformer", "ar_loss")])
def test_trainer_two_steps_save_and_resume(corpus, model_type, key):
    root, _, config = corpus
    first = config(f"{key}_run", max_steps=2, save_checkpoints_steps=1)
    trainer = main(["--config", str(first), "--model_type", model_type,
                    "--exp_name", f"{key}_run", "--device", "cpu"])
    losses = _losses(root / f"{key}_run.jsonl", key)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert trainer.loop.step == 2 and trainer.loop.states.step == 2
    grads = trainer.first_grads
    assert grads["tensors"] == len(list(trainer.loop.states.model.parameters()))
    assert not grads["missing"]
    # the time embedding reaches the loss only through the adaptive norms'
    # zero-initialised projections, so its MLP's first gradient is 0 (as in JAX)
    assert all(n.startswith("diff_estimator.diff_step_mlp.") for n in grads["all_zero"])
    ckpts = sorted((root / "ckpts" / f"{key}_run" / "checkpoint").glob("epoch-*"))
    assert [parse_ckpt_name(p.name)[1] for p in ckpts] == [1, 2]

    # resume from the step-1 checkpoint in a fresh run directory
    resumed = root / "ckpts" / f"{key}_resume" / "checkpoint"
    resumed.mkdir(parents=True)
    shutil.copytree(ckpts[0], resumed / ckpts[0].name)
    again = config(f"{key}_resume", max_steps=2)
    trainer = main(["--config", str(again), "--model_type", model_type,
                    "--exp_name", f"{key}_resume", "--device", "cpu", "--resume"])
    assert trainer.loop.step == 2 and trainer.loop.batch_in_epoch == 2
    rerun = _losses(root / f"{key}_resume.jsonl", key)
    assert len(rerun) == 1 and abs(rerun[0] - losses[1]) <= 1e-6 * abs(losses[1])


def test_trainer_rejects_unported_options(corpus):
    _, _, config = corpus
    path = config("prosody", max_steps=1)
    with pytest.raises(NotImplementedError, match="prosody"):
        main(["--config", str(path), "--model_type", "AutoregressiveTransformer",
              "--device", "cpu", "--prosody_ckpt", "x"])
    with pytest.raises(ValueError, match="model_type"):
        main(["--config", str(path), "--model_type", "Vevo", "--device", "cpu"])
    orbax = path.parent / "orbax_tok" / "epoch-0001_step-0000100_loss-0.100000"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        main(["--config", str(path), "--model_type", "FlowMatchingTransformer",
              "--device", "cpu", "--style_ckpt", str(orbax.parent)])


def test_loop_rejects_unported_options():
    for kw in ({"tensorboard_dir": "tb"}, {"profile_steps": (1, 2)}):
        with pytest.raises(NotImplementedError):
            TrainLoop(LoopConfig(**kw), None, None, None)
    with pytest.raises(NotImplementedError, match="mesh"):
        TrainLoop(LoopConfig(), None, None, None, mesh="auto")


def test_loop_epoch_mode_and_nan_guard(tmp_path):
    """Epoch mode saves by stride at each epoch's end; a non-finite metric
    raises."""

    class State:
        step = 0
        model = torch.nn.Linear(1, 1)

        def state_dict(self):
            return {"step": self.step}

    def step(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(batch)}

    ckpt = CheckpointManager(tmp_path / "c", [2], [1])
    loop = TrainLoop(LoopConfig(max_epoch=4, log_interval=10), step, State(),
                     lambda skip: [1.0, 2.0][skip:], ckpt=ckpt)
    loop.run()
    assert loop.step == 8 and loop.epoch == 4
    kept = [p.name for p in (tmp_path / "c").glob("epoch-*")]
    assert len(kept) == 1 and parse_ckpt_name(kept[0]) == (4, 8)
    assert kept[0].endswith("loss-1.500000")
    bad = TrainLoop(LoopConfig(max_steps=3), step, State(), lambda skip: [1.0, float("nan")])
    with pytest.raises(FloatingPointError, match="step 2"):
        bad.run()
    empty = TrainLoop(LoopConfig(max_steps=3), step, State(), lambda skip: [])
    with pytest.raises(ValueError, match="no batch"):
        empty.run()


def test_checkpoint_manager_refuses_orbax_and_keeps_strides(tmp_path):
    orbax = tmp_path / "epoch-0001_step-0000010_loss-0.500000"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        CheckpointManager(tmp_path).restore_raw()

    class State:
        def state_dict(self):
            return {"w": torch.ones(2)}

    mgr = CheckpointManager(tmp_path / "s", [1, 2], [1, -1])
    for epoch in range(1, 5):
        mgr.save(State(), epoch, epoch * 10, 0.1 * epoch)
    kept = sorted(parse_ckpt_name(p.name)[0] for p in (tmp_path / "s").glob("epoch-*"))
    assert kept == [2, 4]  # the last of stride 1, every even epoch of stride 2
    state, epoch, step = mgr.restore_raw()
    assert (epoch, step) == (4, 40) and torch.equal(state["w"], torch.ones(2))
    assert mgr.should_save(3) and not CheckpointManager(tmp_path / "t", [2]).should_save(3)


def test_data_copies_roundtrip(corpus):
    root, utts, _ = corpus
    loaded = load_metadata(root / "data" / "tiny" / "train.json")
    assert [u.uid for u in loaded] == [u.uid for u in utts]
    x, sr = load_wav(loaded[0].path)
    assert sr == SR and x.dtype == np.float32 and x.shape == (2400,)
    ds = SegmentAudioDataset(loaded, SR, 3000)
    assert ds[0]["audio"].shape == (3000,) and not ds[0]["audio"][2400:].any()
    got = list(Prefetcher(lambda: iter(range(5))))
    assert got == list(range(5))
    it = iter(Prefetcher(lambda: iter(range(100)), depth=1))
    assert next(it) == 0
    it.close()  # stops the worker thread early
