"""PyTorch port, codec-LM trainers (`bins/tts/train.py`) on the CPU: one
whole step of `VALLETrainer` and `MaskGCTTrainer` against the JAX
trainers' jitted steps on the same processed files, a resume, and the
trainers that are not ported.

The corpus goes through the port's `bins/tts/preprocess.py` (tiny codecs,
phones on). Both trainers start from the same weights (the JAX init's
shapes with random leaves, carried over by `utils/convert.from_flax`),
take the same batch (the port's first batch of epoch 0 must be JAX's) and
the JAX step's draws. Losses within 1e-4; the parameter updates agree
within 1 % of lr on at least 1 − 1e-3 of the elements (Adam's first
update is about lr·sign(g), so a gradient near 0 may flip an element).
JAX compiles with most XLA optimizations off (`quick_xla`).
"""

import copy
import json
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from amphion_tpu.models.tts.maskgct.maskgct import MaskGCTS2A as JS2A
from amphion_tpu.models.tts.maskgct.maskgct import MaskGCTT2S as JT2S
from amphion_tpu.models.tts.valle.valle import VALLE as JVALLE
from amphion_tpu.runtime.tts_trainer import MaskGCTTrainer as JMaskGCTTrainer
from amphion_tpu.runtime.tts_trainer import VALLETrainer as JVALLETrainer
from amphion_tpu.utils.config import JsonHParams
from amphion_tpu_torch.bins.tts import preprocess as port_pre
from amphion_tpu_torch.bins.tts import train as port_train
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.tts_trainer import MaskGCTTrainer, VALLETrainer
from amphion_tpu_torch.utils.convert import from_flax
from test_torch_tts_losses import mask_draws, quick_xla, random_tree, valle_draws
from test_torch_tts_preprocess import corpus_config, write_libritts

torch.set_num_threads(1)  # one xdist worker per core

LR = 1e-3
SMALL = {"hidden": 64, "num_layers": 2, "num_heads": 4}
MODELS = {
    "VALLE": {"valle": {"audio_vocab": 16, "num_quantizers": 3, "max_position": 512, **SMALL}},
    "MaskGCT": {"t2s": {"codebook_size": 16, **SMALL}, "s2a": {"codebook_size": 16, **SMALL}},
}
# 1 000 tokens: the five training clips (bucket 186) make one batch an epoch
TRAIN = {"max_tokens": 1000, "min_bucket": 64, "seed": 0, "log_interval": 1,
         "adamw": {"lr": LR, "adam_b1": 0.9, "adam_b2": 0.95}}


@pytest.fixture(scope="module", autouse=True)
def _quick_xla():
    with quick_xla():
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny LibriTTS corpus through the port's preprocessing CLI: mels,
    phones, codes and semantic tokens of random tiny codecs."""
    root = tmp_path_factory.mktemp("tts_train")
    write_libritts(root / "raw")
    cfg = corpus_config(root, root / "processed")
    cfg["preprocess"]["extract_phone"] = True
    (root / "pre.json").write_text(json.dumps(cfg))
    port_pre.main(["--config", str(root / "pre.json"), "--extract_codes",
                   "--extract_semantic", "--device", "cpu"])
    return root


def config(root, model_type: str, **train) -> dict:
    cfg = corpus_config(root, root / "processed", model_type=model_type)
    cfg["model"] = {**cfg["model"], **MODELS[model_type]}
    cfg["train"] = {**TRAIN, **train}
    return cfg


def args(name: str, **kw):
    return types.SimpleNamespace(exp_name=name, resume=False, resume_type="resume",
                                 log_level="info", device="cpu", **kw)


def assert_updates_agree(port, ref, start):
    """Δport against Δref (both from ``start``): within 1 % of lr on at
    least 1 − 1e-3 of all elements."""
    total = off = 0
    for (name, p), r, s in zip(port.named_parameters(), ref.parameters(), start.parameters()):
        d = ((p - s) - (r - s)).abs().detach()
        total += d.numel()
        off += int((d > 0.01 * LR).sum())
    assert total and off <= 1e-3 * total, f"{off} of {total} updates differ by > 1 % of lr"
    moved = max((p - s).abs().max().item() for p, s in zip(port.parameters(),
                                                           start.parameters()))
    assert 0.5 * LR < moved < 3 * LR


def jax_trainer(cls, root, model_type, params_of, monkeypatch):
    """The JAX trainer over the same files, its models' ``init`` giving
    ``params_of(module)`` (random leaves in the init's shapes: eagerly, an
    init compiles op by op)."""
    for jcls in (JVALLE, JT2S, JS2A):
        monkeypatch.setattr(jcls, "init", lambda self, *a, **k: {"params": params_of(self)})
    return cls(args(f"jax_{model_type}"), JsonHParams(**config(root, model_type)))


def test_valle_step_matches_jax(corpus, monkeypatch):
    trees = {}

    def params_of(module):
        b = (np.zeros((2, 5), np.int32), np.ones((2, 5), np.float32),
             np.zeros((2, 3, 7), np.int32), np.ones((2, 7), np.float32), jax.random.key(1))
        return trees.setdefault("valle", random_tree(module, 21, *b,
                                                     method=JVALLE.train_loss))
    jt = jax_trainer(JVALLETrainer, corpus, "VALLE", params_of, monkeypatch)
    trainer = VALLETrainer(args("valle"), config(corpus, "VALLE"))
    model = trainer.loop.states.model
    from_flax(model, trees["valle"])
    start = copy.deepcopy(model)
    indices, bucket = trainer.epoch_batches(0)[0]
    assert (indices, bucket) == next(iter(jt.sampler))  # epoch 0's first batch, as in JAX
    jbatch = jt._make_batch(indices, bucket)
    _, sub = jax.random.split(jt.state.rng)
    stage, plen = valle_draws(jt.model.cfg, np.asarray(jbatch["token_mask"]), sub)
    jstate, jaux = jt.loop.train_step(jt.state, jbatch)
    state, aux = trainer.step(trainer.loop.states, trainer.make_batch(indices, bucket),
                              {"stage": torch.from_numpy(stage), "plen": plen})
    for k in ("ar_loss", "nar_loss"):
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-4, (k, aux[k].item(), jaux[k])
    ref = from_flax(copy.deepcopy(model), jax.tree_util.tree_map(np.asarray, jstate.params))
    assert_updates_agree(model, ref, start)


def test_maskgct_step_matches_jax(corpus, monkeypatch):
    trees = {}

    def params_of(module):
        t = 7
        if isinstance(module, JT2S):
            return trees.setdefault("t2s", random_tree(
                module, 22, np.zeros((2, t), np.int32), np.ones((2, t), np.float32),
                np.zeros((2, 5), np.int32), np.ones((2, 5), np.float32), jax.random.key(1),
                method=JT2S.compute_loss))
        return trees.setdefault("s2a", random_tree(
            module, 23, np.zeros((2, 3, t), np.int32), np.ones((2, t), np.float32),
            np.zeros((2, t, 8), np.float32), jax.random.key(1), method=JS2A.compute_loss))
    jt = jax_trainer(JMaskGCTTrainer, corpus, "MaskGCT", params_of, monkeypatch)
    trainer = MaskGCTTrainer(args("maskgct"), config(corpus, "MaskGCT"))
    model = trainer.loop.states.model
    assert not hasattr(model["s2a"], "cond_emb") and hasattr(model["s2a"], "sem_proj")
    from_flax(model["t2s"], trees["t2s"])
    from_flax(model["s2a"], trees["s2a"])
    start = copy.deepcopy(model)
    indices, bucket = trainer.epoch_batches(0)[0]
    assert (indices, bucket) == next(iter(jt.sampler))
    jbatch = jt._make_batch(indices, bucket)
    batch = trainer.make_batch(indices, bucket)
    for k, v in batch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch[k]), err_msg=k)
    _, r1, r2 = jax.random.split(jt.state.rng, 3)
    b, t_len = batch["semantic"].shape
    draws = {"t2s": mask_draws(r1, b, t_len), "s2a": mask_draws(r2, b, t_len, s2a_q=3)}
    jstate, jaux = jt.loop.train_step(jt.state, jbatch)
    state, aux = trainer.step(trainer.loop.states, batch, draws)
    for k in ("t2s_loss", "s2a_loss"):
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-4, (k, aux[k].item(), jaux[k])
    assert aux["t2s_acc"].item() == float(jaux["t2s_acc"])
    ref = copy.deepcopy(model)
    from_flax(ref["t2s"], jax.tree_util.tree_map(np.asarray, jstate.params["t2s"]))
    from_flax(ref["s2a"], jax.tree_util.tree_map(np.asarray, jstate.params["s2a"]))
    assert_updates_agree(model, ref, start)


@pytest.mark.parametrize("model_type", ["VALLE", "MaskGCT"])
def test_resume_is_bit_equal(corpus, tmp_path, model_type):
    """Through the CLI: two steps (an epoch each) against one step, a
    resume from its checkpoint and one more step; the step-2 checkpoints'
    weights, optimizer moments and generator state are equal to the bit."""
    def run(name, *extra):
        cfg = config(corpus, model_type, max_steps=2, save_checkpoints_steps=1)
        cfg["log_dir"] = str(tmp_path)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return port_train.main(["--config", str(path), "--exp_name", name, "--device", "cpu",
                                *extra])

    run("whole")
    step1 = next((tmp_path / "whole" / "checkpoint").glob("*_step-0000001_*"))
    shutil.copytree(step1, tmp_path / "resumed" / "checkpoint" / step1.name)
    again = run("resumed", "--resume")
    assert again.loop.step == 2
    states = [CheckpointManager(tmp_path / n / "checkpoint").restore_raw()
              for n in ("whole", "resumed")]
    assert [s[2] for s in states] == [2, 2]
    a, b = states[0][0], states[1][0]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert torch.equal(a["generator"], b["generator"])
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert all(torch.equal(sa[i][m], sb[i][m]) for i in sa for m in ("exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("model_type,label", [
    ("Jets", "A6.4"), ("NaturalSpeech2", "A6.4"), ("Metis", "A6.6"), ("DualCodecTTS", "A6.6")])
def test_unported_trainers_raise_with_their_label(model_type, label):
    with pytest.raises(NotImplementedError, match=label):
        port_train.build_trainer(args("x"), {"model_type": model_type})


def test_missing_phones_name_the_switch(corpus, tmp_path):
    """`config/base.json` sets ``extract_phone`` false: without phone files
    both trainers stop and say which switch to set."""
    cfg = config(corpus, "VALLE")
    shutil.copytree(corpus / "processed", tmp_path / "processed")
    shutil.rmtree(tmp_path / "processed" / "libritts" / "phones")
    cfg["preprocess"]["processed_dir"] = str(tmp_path / "processed")
    for cls in (VALLETrainer, MaskGCTTrainer):
        with pytest.raises(AssertionError, match="extract_phone"):
            cls(args("x"), cfg)
