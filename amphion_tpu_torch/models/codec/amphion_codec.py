"""AmphionCodec: convolutional audio codec with residual VQ (port of
`amphion_tpu/models/codec/amphion_codec.py`, MaskGCT's acoustic codec).

Layout (B, T, C) as in JAX; submodules carry the Flax scope names
(``Conv_0``, ``res_{i}_{d}``, ``down_act_{i}``, ``ConvTranspose_{i}``,
``quantizer.q{i}``) so `utils/convert.from_flax` loads a JAX tree. The
convolutions are the codec's own, not BigVGAN's:

- the strided encoder convolution, kernel 2s, pads ``(⌈s/2⌉, ⌊s/2⌋)``;
- the transposed decoder convolution, kernel 2s, pads
  ``(k−1−⌈s/2⌉, k−1−⌊s/2⌋)`` (asymmetric for the odd stride 5);
- the residual units' convolutions are dilated 1, 3 and 9, ``"SAME"``.

Every Snake activation runs kernel 1 (``Snake(use_pallas=True)``,
`ops/kernels/snake.py`) on the card and its plain version on the CPU: the
same function JAX's plain ``Snake`` computes there (JAX's ``use_pallas``
call needs a TPU). 29 activations a pass at the published strides, in the
encoder and in the decoder alike. The Vocos decoder
(``use_vocos_decoder``) is not ported and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from amphion_tpu_torch.modules.activations import Snake
from amphion_tpu_torch.modules.quantize import ResidualVQ
from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConvTranspose1d

DILATIONS = (1, 3, 9)


@dataclass(frozen=True)
class CodecConfig:
    sample_rate: int = 24000
    encoder_dim: int = 32
    latent_dim: int = 256
    decoder_dim: int = 32
    strides: tuple[int, ...] = (2, 4, 5, 6)  # hop = 240 @24k -> 100 Hz
    num_quantizers: int = 8
    codebook_size: int = 1024
    codebook_dim: int = 8
    quantizer_type: str = "fvq"
    use_vocos_decoder: bool = False

    def __post_init__(self):
        if self.use_vocos_decoder:
            raise NotImplementedError("the codec's Vocos decoder (use_vocos_decoder) "
                                      "is not ported")

    @property
    def hop(self) -> int:
        h = 1
        for s in self.strides:
            h *= s
        return h


def _mask(length: torch.Tensor | None, t: int, like: torch.Tensor):
    """(B, t, 1) 1/0 in ``like``'s dtype: position < length, or None."""
    if length is None:
        return None
    pos = torch.arange(t, device=like.device)[None, :]
    return (pos < length.to(like.device)[:, None]).to(like.dtype)[:, :, None]


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.act1 = Snake(channels, use_pallas=True)
        self.Conv_0 = WNConv1d(channels, channels, 7, dilation)
        self.act2 = Snake(channels, use_pallas=True)
        self.Conv_1 = WNConv1d(channels, channels, 1)

    def forward(self, x, mask=None):
        # zero the pad positions before the dilated conv, so a ragged batch
        # matches an unpadded decode (the 1x1 conv is positionwise)
        if mask is not None:
            x = x * mask
        y = self.Conv_0(self.act1(x))
        return x + self.Conv_1(self.act2(y))


class CodecEncoder(nn.Module):
    """(B, T) waveform → (B, T/hop, latent_dim)."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.encoder_dim
        self.Conv_0 = WNConv1d(1, ch, 7)
        for i, s in enumerate(cfg.strides):
            for d in DILATIONS:
                self.add_module(f"res_{i}_{d}", ResidualUnit(ch, d))
            self.add_module(f"down_act_{i}", Snake(ch, use_pallas=True))
            self.add_module(f"Conv_{i + 1}", WNConv1d(
                ch, 2 * ch, 2 * s, stride=s, padding=(s // 2 + s % 2, s // 2)))
            ch *= 2
        self.final_act = Snake(ch, use_pallas=True)
        self.add_module(f"Conv_{len(cfg.strides) + 1}", WNConv1d(ch, cfg.latent_dim, 3))

    def forward(self, x):
        n = len(self.cfg.strides)
        h = self.Conv_0(x[..., None])
        for i in range(n):
            for d in DILATIONS:
                h = getattr(self, f"res_{i}_{d}")(h)
            h = getattr(self, f"Conv_{i + 1}")(getattr(self, f"down_act_{i}")(h))
        return getattr(self, f"Conv_{n + 1}")(self.final_act(h))


class CodecDecoder(nn.Module):
    """(B, N, latent_dim) → (B, N·hop) waveform."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.decoder_dim * (2 ** len(cfg.strides))
        self.Conv_0 = WNConv1d(cfg.latent_dim, ch, 7)
        for i, s in enumerate(reversed(cfg.strides)):
            self.add_module(f"up_act_{i}", Snake(ch, use_pallas=True))
            k = 2 * s
            self.add_module(f"ConvTranspose_{i}", WNConvTranspose1d(
                ch, ch // 2, k, s, padding=(k - 1 - (s // 2 + s % 2), k - 1 - s // 2)))
            ch //= 2
            for d in DILATIONS:
                self.add_module(f"res_{i}_{d}", ResidualUnit(ch, d))
        self.final_act = Snake(ch, use_pallas=True)
        self.Conv_1 = WNConv1d(ch, 1, 7)

    def forward(self, z, frame_lengths=None):
        """``frame_lengths`` (B,): length-masked ragged decode. Every spatial
        conv sees zeros beyond the row's valid extent (scaled by each
        upsampling stride), so ``out[i, :len_i * hop]`` equals an unpadded
        decode of row ``i`` alone."""
        flen = frame_lengths
        mask = _mask(flen, z.shape[1], z)
        if mask is not None:
            z = z * mask
        h = self.Conv_0(z)
        for i, s in enumerate(reversed(self.cfg.strides)):
            if mask is not None:
                h = h * mask
            h = getattr(self, f"ConvTranspose_{i}")(getattr(self, f"up_act_{i}")(h))
            if flen is not None:
                flen = flen * s
                mask = _mask(flen, h.shape[1], h)
            for d in DILATIONS:
                h = getattr(self, f"res_{i}_{d}")(h, mask)
        if mask is not None:
            h = h * mask
        return torch.tanh(self.Conv_1(self.final_act(h)))[..., 0]


class AmphionCodec(nn.Module):
    """Encoder → residual VQ → decoder, with the token APIs."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = CodecEncoder(cfg)
        self.decoder = CodecDecoder(cfg)
        self.quantizer = ResidualVQ(cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim,
                                    cfg.latent_dim, cfg.quantizer_type)

    @torch.inference_mode()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T) → codes (Q, B, T // hop) int64."""
        return self.quantizer.encode(self.encoder(audio))

    @torch.inference_mode()
    def decode_codes(self, codes: torch.Tensor,
                     frame_lengths: torch.Tensor | None = None) -> torch.Tensor:
        """codes (Q, B, N) → waveform (B, N·hop). With ``frame_lengths`` (B,)
        row ``i``'s first ``frame_lengths[i]·hop`` samples equal an unpadded
        decode of that row alone."""
        return self.decoder(self.quantizer.decode(codes), frame_lengths)
