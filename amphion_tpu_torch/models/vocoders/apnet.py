"""APNet generator (port of `amphion_tpu/models/vocoders/apnet.py`):
amplitude and phase predicted in parallel, then an iSTFT.

Two branches over the mel (B, N, n_mel), each a k7 conv, the mean of
HiFi-GAN ``ResBlock1``s and a leaky ReLU of slope 0.01: the amplitude
branch predicts the log-amplitude (``asp_*``), the phase branch a real and
an imaginary part whose ``atan2`` is the wrapped phase (``psp_*``). The
waveform is `ops/stft.istft(..., padding="same")` of the spectrum, N·hop
samples. The submodules carry the Flax names.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.models.vocoders.hifigan import ResBlock1, mrf
from amphion_tpu_torch.modules.weight_norm import WNConv1d
from amphion_tpu_torch.ops.stft import istft


@dataclass(frozen=True)
class APNetConfig:
    n_mel: int = 80
    channels: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    input_conv_kernel: int = 7
    output_conv_kernel: int = 7
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024


class APNetGenerator(nn.Module):
    def __init__(self, cfg: APNetConfig = APNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        f = c.n_fft // 2 + 1
        self.branches = {}
        for tag in ("asp", "psp"):
            self.add_module(f"{tag}_input_conv",
                            WNConv1d(c.n_mel, c.channels, c.input_conv_kernel))
            blocks = []
            for ks, ds in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                block = ResBlock1(c.channels, ks, tuple(ds))
                self.add_module(f"{tag}_res_{ks}", block)
                blocks.append(block)
            self.branches[tag] = (getattr(self, f"{tag}_input_conv"), blocks)
        self.asp_output_conv = WNConv1d(c.channels, f, c.output_conv_kernel)
        self.psp_output_r_conv = WNConv1d(c.channels, f, c.output_conv_kernel)
        self.psp_output_i_conv = WNConv1d(c.channels, f, c.output_conv_kernel)

    def _branch(self, tag: str, mel: torch.Tensor) -> torch.Tensor:
        conv, blocks = self.branches[tag]
        return F.leaky_relu(mrf(blocks, conv(mel)), 0.01)

    def forward(self, mel: torch.Tensor, return_features: bool = False):
        """mel (B, N, n_mel) → waveform (B, N·hop); with ``return_features``
        also (logamp, phase (B, N, F), real, imag (B, F, N)) for APNet's
        amplitude, phase and consistency losses."""
        c = self.cfg
        logamp = self.asp_output_conv(self._branch("asp", mel))
        p = self._branch("psp", mel)
        phase = torch.atan2(self.psp_output_i_conv(p), self.psp_output_r_conv(p))
        amp = torch.exp(logamp)
        real = (amp * torch.cos(phase)).transpose(1, 2)
        imag = (amp * torch.sin(phase)).transpose(1, 2)
        audio = istft(real, imag, c.n_fft, c.hop_size, c.win_size, padding="same")
        if return_features:
            return audio, (logamp, phase, real, imag)
        return audio
