"""PyTorch port, VALL-E on the CPU against the JAX package: a tiny `VALLE`
(2 layers, width 64, 4 heads, 32 codes a codebook, 3 codebooks) whose Flax
tree, from ``jax.eval_shape`` filled from a numpy seed, reaches the port
through `utils/convert.from_flax`. Held: the ragged prefill's and a decode
step's logits, the greedy fixed-shape and ragged AR decodes token for token
on three ragged requests (the EOS logit raised so that they stop at
different steps), the fixed-shape and ragged NAR codes, and the int8/int4
AR trees of the decode preparation bit for bit against JAX's
`_decode_params`; then, port only, a sampled request in a batch of three
against the same request alone. Every JAX side runs jitted; float32
tolerance 1e-4, ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.tts.valle import valle as jvalle
from amphion_tpu.modules.llama import LlamaDecoder as JLlamaDecoder
from amphion_tpu.ops.ragged import right_pack_valid as right_pack_valid_j
from amphion_tpu_torch.models.tts.valle.valle import (
    VALLE,
    VALLEConfig,
    ar_generate,
    ar_generate_ragged,
    nar_generate_ragged,
    prepare_for_decode,
)
from amphion_tpu_torch.ops.ragged import right_pack_valid
from amphion_tpu_torch.utils.convert import from_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

# the model and the batch's shapes of tests/test_torch_valle_serve.py (its window
# batch: phones and prompts padded to 32, 20 steps), so that the two files
# compile the same JAX programs once
TINY = dict(num_phones=64, audio_vocab=32, num_quantizers=3, hidden=64, num_layers=2,
            num_heads=4, max_position=512)
EOS_BIAS = 1.2  # raises the EOS logit so that greedy decodes end at different steps
# three ragged requests: (phones, prompt frames), padded to (32, 32)
LENS = [(32, 30), (13, 9), (21, 17)]
LPH, LP, MAX_NEW = 32, 32, 20


def fill(shapes, seed: int):
    """Random leaves for a Flax tree of ``jax.ShapeDtypeStruct``s: kernels
    normal over √fan_in, norm scales in [0.5, 1.5], the rest normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def requests(seed: int = 1):
    """(phones (3, LPH), phone_len, prompt codes (3, Q, LP), prompt_len)."""
    rng = np.random.default_rng(seed)
    phones = rng.integers(1, TINY["num_phones"], (3, LPH))
    codes = rng.integers(0, TINY["audio_vocab"], (3, TINY["num_quantizers"], LP))
    for i, (n, m) in enumerate(LENS):
        phones[i, n:], codes[i, :, m:] = 0, 0
    return (phones, np.array([n for n, _ in LENS]), codes, np.array([m for _, m in LENS]))


@pytest.fixture(scope="module")
def tiny():
    """(JAX module, its tree, the port in float32) with EOS raised."""
    jm = jvalle.VALLE(jvalle.VALLEConfig(**TINY))
    b, t = 2, 6
    args = (jnp.zeros((b, 5), jnp.int32), jnp.ones((b, 5)),
            jnp.zeros((b, TINY["num_quantizers"], t), jnp.int32), jnp.ones((b, t)),
            jax.random.key(0))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args,
                                            method=jvalle.VALLE.train_loss))["params"]
    tree = fill(shapes, 3)
    tree["ar_head"]["bias"][TINY["audio_vocab"]] = EOS_BIAS
    return jm, tree, from_flax(VALLE(VALLEConfig(**TINY)), tree).eval()


def L(a):
    return torch.as_tensor(np.array(a)).long()


def test_ragged_prefill_and_step_logits_match_jax(tiny):
    jm, tree, port = tiny
    phones, plen, codes, clen = requests()
    total = LPH + LP + 4

    @jax.jit
    def run(ph, pl, pr, prl, tok):
        kv = right_pack_valid_j([pl, prl], LPH + LP, total)
        caches = JLlamaDecoder(jm.cfg.llama(False)).init_cache(3, total)
        lg, caches = jm.apply({"params": tree}, ph, pl, pr, prl, caches, kv,
                              method=jvalle.VALLE.ar_prefill_ragged)
        lg2, _ = jm.apply({"params": tree}, tok, caches, LPH + LP, kv,
                          method=jvalle.VALLE.ar_step)
        return lg, lg2

    tok = np.array([3, 31, 0])
    want0, want1 = run(phones, plen, codes[:, 0], clen, tok)
    with torch.no_grad():
        kv = right_pack_valid([L(plen), L(clen)], LPH + LP, total)
        caches = port.make_cache(3, total)
        got0, caches = port.ar_prefill_ragged(L(phones), L(plen), L(codes[:, 0]), L(clen),
                                              caches, kv)
        got1, _ = port.ar_step(L(tok), caches, LPH + LP, kv)
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=1e-4)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-4)


@pytest.fixture(scope="module")
def jax_greedy(tiny):
    """JAX's greedy decodes of the three requests, float32: the ragged AR,
    the fixed-shape AR of request 0, the ragged and fixed NAR."""
    jm, tree, _ = tiny
    phones, plen, codes, clen = requests()
    keys = jax.vmap(jax.random.key)(jnp.arange(3, dtype=jnp.uint32))
    toks, gen_len = jvalle.ar_generate_ragged(jm, tree, phones, plen, codes[:, 0], clen, keys,
                                              max_new=MAX_NEW, temperature=0.0,
                                              compute_dtype="float32")
    n0, m0 = LENS[0]
    toks_fixed, len_fixed = jvalle.ar_generate(jm, tree, jnp.asarray(phones[:1, :n0]),
                                               jnp.asarray(codes[:1, 0, :m0]),
                                               jax.random.key(0), max_new=MAX_NEW,
                                               temperature=0.0, compute_dtype="float32")
    nar_r = jvalle.nar_generate_ragged(jm, tree, phones, plen, toks, gen_len, codes, clen,
                                       compute_dtype="float32")
    n = max(int(gen_len[0]), 1)
    tmask = (np.arange(MAX_NEW) < n).astype(np.float32)[None]
    nar_f = jax.jit(lambda p, ph, pm, t0, tm, pc: jm.apply(
        {"params": p}, ph, pm, t0, tm, pc, method=jvalle.VALLE.nar_generate))(
        tree, phones[:1, :n0], np.ones((1, n0), np.float32), toks[:1], tmask, codes[:1, :, :m0])
    return {k: np.asarray(v) for k, v in dict(toks=toks, gen_len=gen_len, toks_fixed=toks_fixed,
                                              len_fixed=len_fixed, nar_r=nar_r,
                                              nar_f=nar_f).items()}


def test_greedy_ar_decodes_match_jax(tiny, jax_greedy):
    """Token for token and gen_len: the ragged decode of three requests that
    stop at different steps, and request 0's fixed-shape decode."""
    _, _, port = tiny
    phones, plen, codes, clen = requests()
    toks, gen_len = ar_generate_ragged(port, L(phones), L(plen), L(codes[:, 0]), L(clen),
                                       max_new=MAX_NEW, temperature=0.0,
                                       compute_dtype="float32")
    want = jax_greedy
    assert len(set(want["gen_len"].tolist())) == 3 and 0 < min(want["gen_len"]) < MAX_NEW
    np.testing.assert_array_equal(gen_len.numpy(), want["gen_len"])
    np.testing.assert_array_equal(toks.numpy(), want["toks"])
    n0, m0 = LENS[0]
    tf, lf = ar_generate(port, L(phones[:1, :n0]), L(codes[:1, 0, :m0]), max_new=MAX_NEW,
                         temperature=0.0, compute_dtype="float32")
    np.testing.assert_array_equal(tf.numpy(), want["toks_fixed"])
    np.testing.assert_array_equal(lf.numpy(), want["len_fixed"])
    assert torch.equal(tf[0], toks[0])  # the right-aligned packing is exact


def test_greedy_nar_codes_match_jax(tiny, jax_greedy):
    _, _, port = tiny
    phones, plen, codes, clen = requests()
    want = jax_greedy
    got = nar_generate_ragged(port, L(phones), L(plen), L(want["toks"]), L(want["gen_len"]),
                              L(codes), L(clen), compute_dtype="float32")
    np.testing.assert_array_equal(got.numpy(), want["nar_r"])
    n0, m0 = LENS[0]
    n = max(int(want["gen_len"][0]), 1)
    with torch.no_grad():
        fixed = port.nar_generate(L(phones[:1, :n0]), torch.ones((1, n0)), L(want["toks"][:1]),
                                  (torch.arange(MAX_NEW) < n).float()[None], L(codes[:1, :, :m0]))
    np.testing.assert_array_equal(fixed.numpy(), want["nar_f"])
    # the ragged layout gives request 0 the codes it gets alone
    np.testing.assert_array_equal(fixed[0, :, :n].numpy(), got[0, :, :n].numpy())


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_ar_tree_bit_equal_to_jax(tiny, quant):
    """The int8/int4 decode preparation against JAX's `_decode_params`: every
    leaf of the quantized VALL-E, AR and NAR, bit for bit; the NAR stays
    bf16."""
    jm, tree, port = tiny
    jtree = jax.jit(lambda p: jvalle._decode_params(p, quant))(tree)
    qmodel, _ = jvalle._decode_model_dtype(jm, quant)
    ours = prepare_for_decode(from_flax(VALLE(VALLEConfig(**TINY)), tree), quant)
    assert ours.cfg.decode_quant == quant and ours.cfg.kv_quant == qmodel.cfg.kv_quant
    theirs = from_flax(prepare_for_decode(VALLE(VALLEConfig(**TINY)), quant), jtree)
    a, b = ours.state_dict(), theirs.state_dict()
    assert sorted(a) == sorted(b) and "ar.layer_1.attn.qkv_proj.kernel_q" in a
    assert "nar.layer_0.attn.q_proj.weight" in a and a["nar_head.weight"].dtype == torch.bfloat16
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    assert prepare_for_decode(ours, quant) is ours
    with pytest.raises(ValueError, match="prepare"):
        ar_generate(ours, L([[1, 2]]), L([[3]]), compute_dtype="float32")


def test_sampled_request_alone_equals_batch(tiny):
    """Request 1 sampled (temperature 1, top-k 8, its own generator) in a
    batch of three equals request 1 alone, token for token."""
    _, _, port = tiny
    phones, plen, codes, clen = requests(5)

    def gens(seeds):
        return [torch.Generator().manual_seed(s) for s in seeds]
    toks, n = ar_generate_ragged(port, L(phones), L(plen), L(codes[:, 0]), L(clen),
                                 gens([7, 8, 9]), max_new=MAX_NEW, top_k=8,
                                 compute_dtype="float32")
    alone, n1 = ar_generate_ragged(port, L(phones[1:2]), L(plen[1:2]), L(codes[1:2, 0]),
                                   L(clen[1:2]), gens([8]), max_new=MAX_NEW, top_k=8,
                                   compute_dtype="float32")
    assert int(n1[0]) == int(n[1]) and torch.equal(alone[0], toks[1])
    again, _ = ar_generate_ragged(port, L(phones), L(plen), L(codes[:, 0]), L(clen),
                                  gens([7, 8, 10]), max_new=MAX_NEW, top_k=8,
                                  compute_dtype="float32")
    assert torch.equal(again[:2], toks[:2]) and not torch.equal(again[2], toks[2])
