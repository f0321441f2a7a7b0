"""PyTorch port, ops layer: STFT/iSTFT, mel, attention and ragged packing
against the JAX package on the CPU, plus the port's import boundary.

Inputs come from a numpy seed and go through both implementations. On the
CPU every kernel wrapper runs its plain version; the Pallas kernels run in
interpret mode. Tolerances (float32): 1e-4 absolute on signals and
activations, 1e-3 on log-mel (as tests/test_pallas.py).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from amphion_tpu.ops.mel import mel_spectrogram_xla
from amphion_tpu.ops.ragged import masked_std as jax_masked_std
from amphion_tpu.ops.ragged import pack_segments as jax_pack_segments
from amphion_tpu.ops.ragged import unpack_target as jax_unpack_target
from amphion_tpu.ops.stft import istft as jax_istft
from amphion_tpu.ops.stft import stft as jax_stft
from amphion_tpu.ops.pallas_kernels import flash_attention_pallas, mel_spectrogram_pallas
from amphion_tpu.utils.config import load_config as jax_load_config
from amphion_tpu_torch.ops import mel as tmel
from amphion_tpu_torch.ops import ragged as tragged
from amphion_tpu_torch.ops import stft as tstft
from amphion_tpu_torch.ops.kernels.flash_attention import attention_ref, flash_attention
from amphion_tpu_torch.utils.config import load_config

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


def test_stft_matches_jax(rng):
    y = (rng.standard_normal((2, 4800)) * 0.3).astype(np.float32)
    for center in (False, True):
        jre, jim = jax_stft(jnp.asarray(y), 1024, 120, 480, center)
        tre, tim = tstft.stft(T(y), 1024, 120, 480, center)
        np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=1e-4)
        np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=1e-4)


@pytest.mark.parametrize("n_fft,hop", [(1024, 120), (64, 16)])
def test_istft_same_with_frame_lengths_matches_jax(rng, n_fft, hop):
    """Vocos geometry (n_fft % hop != 0, general overlap-add) and a dividing
    one; ragged frame lengths zero each row's tail frames. The spectra are
    scaled so the waveform is of order one, as a vocoder's is."""
    f, n = n_fft // 2 + 1, 40
    re = (rng.standard_normal((2, f, n)) * 0.02).astype(np.float32)
    im = (rng.standard_normal((2, f, n)) * 0.02).astype(np.float32)
    lens = np.array([40, 27], np.int32)
    ref = jax_istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop, n_fft,
                      None, "same", jnp.asarray(lens))
    out = tstft.istft(T(re), T(im), n_fft, hop, n_fft, padding="same",
                      frame_lengths=T(lens))
    assert out.shape == (2, n * hop)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_mel_matches_jax_and_pallas_interpret(rng):
    """Port mel (plain version on the CPU) vs the JAX XLA mel and the Pallas
    kernel in interpret mode, including a frame count that is not a
    multiple of any tile."""
    cfg = JMelConfig()
    y = (rng.standard_normal((2, 24000)) * 0.3).astype(np.float32)
    for yy in (y, y[:, : 119 * cfg.hop_size]):
        ref = np.asarray(mel_spectrogram_xla(jnp.asarray(yy), cfg))
        pallas = np.asarray(mel_spectrogram_pallas(jnp.asarray(yy), cfg, interpret=True))
        out = tmel.mel_spectrogram(T(yy), tmel.MelConfig())
        assert out.shape == ref.shape == (2, cfg.n_mel, yy.shape[1] // cfg.hop_size)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
        np.testing.assert_allclose(out.numpy(), pallas, atol=1e-3)
        np.testing.assert_array_equal(
            tmel.mel_spectrogram_ref(T(yy), tmel.MelConfig()).numpy(), out.numpy())


def test_mel_config_and_filterbank_match_jax():
    p = load_config(ROOT / "config/vevo.json")["preprocess"]
    cfg = tmel.MelConfig.from_preprocess_cfg(p)
    assert (cfg.sample_rate, cfg.n_fft, cfg.win_size, cfg.hop_size, cfg.n_mel,
            cfg.fmax) == (24000, 1024, 480, 120, 80, 12000)
    np.testing.assert_array_equal(
        tmel.mel_filterbank(24000, 1024, 80, 0.0, 12000.0),
        jax_mel_filterbank(24000, 1024, 80, 0.0, 12000.0))


# (sample rate, n_fft, win_size, n_mel, fmax): config/base.json, the bigvgan_large
# egs config, and the mel kernel's smallest and largest n_fft
MEL_TABLE_CASES = [(24000, 1024, 480, 80, 12000.0), (24000, 1024, 1024, 100, 12000.0),
                   (16000, 256, 200, 40, 8000.0), (24000, 2048, 1200, 128, 12000.0)]


def _stockham_rfft(x: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """The real FFT as `csrc/mel.cu` runs it, in complex64 over the
    wrapper's float32 twiddles: z[m] = x[2m] + i x[2m+1], Stockham passes
    of radix 8 (the last 4 or 2), then the split into bins k and M - k."""
    w = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(np.complex64)
    m, ns = z.shape[-1], 1
    while ns < m:
        r = min(8, m // ns)
        j = np.arange(m // r)
        k = j & (ns - 1)
        a = np.stack([z[..., j + q * (m // r)] for q in range(r)])  # (r, ..., m / r)
        a = a * w[np.arange(r)[:, None] * k * (2 * m // (ns * r))][:, None]
        dft = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r).astype(np.complex64)
        a = np.tensordot(dft, a, axes=1)
        out = np.empty_like(z)
        for q in range(r):
            out[..., (j - k) * r + k + q * ns] = a[q]
        z, ns = out, ns * r
    k = np.arange(m // 2 + 1)
    zk, zm = z[..., k], z[..., (m - k) % m]
    xe, xo = (zk + np.conj(zm)) / 2, -1j * (zk - np.conj(zm)) / 2
    p = w[k] * xo
    spec = np.empty(x.shape[:-1] + (m + 1,), np.complex64)
    spec[..., m - k] = np.conj(xe - p)
    spec[..., k] = xe + p
    return spec


@pytest.mark.parametrize("sr,n_fft,win,n_mel,fmax", MEL_TABLE_CASES)
def test_mel_kernel_tables_reproduce_the_plain_arithmetic(sr, n_fft, win, n_mel, fmax):
    """The mel kernel's host tables: twiddles within float32 rounding of
    float64, the window's taps equal to the plain version's window, the
    band tables expanding back to the filterbank and giving fbank @ mag,
    and a numpy run of the kernel's FFT passes over them within 1e-5 of
    np.fft.rfft relative to the largest bin."""
    from amphion_tpu_torch.ops.kernels import mel as kmel

    tap0, ntaps, win_taps, tw = kmel.fft_tables(n_fft, win)
    e = np.arange(n_fft)
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], np.exp(-2j * np.pi * e / n_fft),
                               rtol=0, atol=6e-8)
    full = tstft._padded_window(win, n_fft)
    assert np.array_equal(full[tap0: tap0 + ntaps], win_taps)
    assert not full[:tap0].any() and not full[tap0 + ntaps:].any()

    fb = tmel.mel_filterbank(sr, n_fft, n_mel, 0.0, fmax)
    bands, weights = kmel.band_tables(fb)
    dense = np.zeros_like(fb)
    for m, (first, count, off) in enumerate(bands):
        dense[m, first: first + count] = weights[off: off + count]
    assert np.array_equal(dense, fb) and bands[-1, 2] + bands[-1, 1] == weights.size
    assert weights.size < fb.size / 4  # the kernel sums only the bands

    rng = np.random.default_rng(n_fft)
    frames = (rng.standard_normal((3, n_fft)) * full).astype(np.float32)
    spec = _stockham_rfft(frames, tw)
    ref = np.fft.rfft(frames.astype(np.float64))
    assert np.abs(spec - ref).max() <= 1e-5 * np.abs(ref).max()
    mag = np.abs(ref)
    banded = np.stack([[weights[o: o + c].astype(np.float64) @ mag[i, f: f + c]
                        for f, c, o in bands] for i in range(3)])
    np.testing.assert_allclose(banded, mag @ fb.T.astype(np.float64), rtol=1e-12, atol=0)


def test_config_loader_matches_jax_loader():
    assert load_config(ROOT / "config/vevo.json") == \
        jax_load_config(ROOT / "config/vevo.json").to_dict()


@pytest.mark.parametrize("case", ["mask", "causal", "gqa", "uneven"])
def test_attention_matches_pallas_interpret(rng, case):
    b, lq, lk, h, kvh, d = 2, 40, 40, 4, 4, 16
    causal, use_mask = case == "causal", case in ("mask", "causal")
    if case == "gqa":
        kvh = 2
    if case == "uneven":
        lq, lk = 23, 37
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, kvh, d)).astype(np.float32)
    mask = (rng.random((b, lk)) > 0.3).astype(np.float32) if use_mask else None
    if mask is not None:
        mask[:, 0] = 1.0
    ref = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if mask is None else jnp.asarray(mask), causal=causal,
        block_q=16, block_k=16, interpret=True)
    tm = None if mask is None else T(mask)
    out = flash_attention(T(q), T(k), T(v), tm, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(out.numpy(), attention_ref(T(q), T(k), T(v), tm, causal).numpy())


def test_flash_wrapper_rejects_bad_input():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, kv_mask=torch.ones(1, 9))
    meta = torch.zeros(1, 8, 4, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(meta, meta, meta)


def test_ragged_packing_matches_jax(rng):
    a = rng.standard_normal((3, 5, 4)).astype(np.float32)
    c = rng.standard_normal((3, 7, 4)).astype(np.float32)
    la, lc = np.array([5, 2, 3], np.int32), np.array([7, 4, 1], np.int32)
    valid = np.arange(7)[None, :] < lc[:, None]

    @jax.jit  # one program (eager JAX dispatches op by op)
    def jax_side(a, c, la, lc, valid):
        packed = jax_pack_segments([a, c], [la, lc])
        return packed, jax_unpack_target(packed, la, 7), jax_masked_std(c, valid)
    ref, ref_u, ref_std = jax_side(a, c, la, lc, valid)
    out = tragged.pack_segments([T(a), T(c)], [T(la), T(lc)])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tragged.unpack_target(out, T(la), 7).numpy(),
                                  np.asarray(ref_u))
    np.testing.assert_allclose(tragged.masked_std(T(c), T(valid)).numpy(),
                               np.asarray(ref_std), atol=1e-6)


def _imports(path: Path) -> set[str]:
    """Modules a file imports: import statements, and calls of
    ``__import__`` or ``importlib.import_module`` with a literal name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("__import__", "import_module")):
            names.add(node.args[0].value)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = (sorted((ROOT / "amphion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert len(files) > 20 and (ROOT / "tools" / "kernel_ab.py") in files
    port = ROOT / "amphion_tpu_torch"
    assert {port / "serving" / "continuous.py", port / "serving" / "continuous_service.py",
            port / "serving" / "loadgen.py", port / "bins" / "serve.py",
            port / "bins" / "vc" / "inference.py", port / "bins" / "tts" / "inference.py",
            port / "text" / "g2p.py", port / "text" / "cleaners.py",
            port / "text" / "symbol_table.py", port / "text" / "symbols.py",
            port / "models" / "tts" / "maskgct" / "maskgct.py",
            port / "models" / "tts" / "maskgct" / "ragged_sampling.py",
            port / "models" / "codec" / "amphion_codec.py",
            port / "pipelines" / "maskgct_pipeline.py",
            port / "models" / "tts" / "valle" / "valle.py",
            port / "utils" / "tokenizer.py",
            port / "bins" / "tts" / "preprocess.py", port / "bins" / "tts" / "train.py",
            port / "runtime" / "tts_trainer.py", port / "data" / "samplers.py",
            port / "data" / "preprocessors" / "processor.py",
            port / "data" / "processors" / "phone.py",
            port / "data" / "processors" / "acoustic.py",
            port / "ops" / "energy.py"} <= set(files)
    assert _imports(Path(__file__)) >= {"jax.numpy", "amphion_tpu.ops.mel"}  # the scan sees them
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "amphion_tpu", "bins"), (f, name)
