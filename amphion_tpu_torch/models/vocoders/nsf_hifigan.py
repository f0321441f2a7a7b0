"""NSF-HiFiGAN generator (port of `amphion_tpu/models/vocoders/nsf_hifigan.py`):
HiFi-GAN with a harmonic neural-source-filter excitation.

The frame-rate F0 is repeated to the sample rate and turned into one
excitation channel (`modules/nsf.SourceModuleHnNSF`, ``source``). At each
upsampling stage a strided plain conv (``noise_conv_i``: kernel
2·stride, stride the product of the later rates; kernel 1 at full rate)
brings the excitation to that stage's rate, where it is added to the
upsampled features before the resblocks (``res_i_k``). With
``reference_forward`` the stage instead doubles its features, as the
reference's forward does (it overwrites the source with the features), so
weights converted from it run as trained.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.models.vocoders.hifigan import (
    LRELU_SLOPE,
    HiFiGANConfig,
    mrf,
    resblock_class,
)
from amphion_tpu_torch.modules.nsf import SourceModuleHnNSF, upsample_f0
from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConvTranspose1d


@dataclass(frozen=True)
class NSFHiFiGANConfig:
    base: HiFiGANConfig = field(default_factory=HiFiGANConfig)
    sample_rate: int = 24000
    num_harmonics: int = 7
    reference_forward: bool = False


class NSFHiFiGANGenerator(nn.Module):
    def __init__(self, cfg: NSFHiFiGANConfig = NSFHiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.base
        self.upp = int(math.prod(c.upsample_rates))
        self.source = SourceModuleHnNSF(cfg.sample_rate, cfg.num_harmonics)
        self.Conv_0 = WNConv1d(c.n_mel, c.upsample_initial_channel, 7)
        block_cls = resblock_class(c)
        ch = c.upsample_initial_channel
        self.stages = []
        for i, (rate, kernel) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            out = c.upsample_initial_channel // (2 ** (i + 1))
            up = WNConvTranspose1d(ch, out, kernel, rate)
            self.add_module(f"ConvTranspose_{i}", up)
            stride = int(math.prod(c.upsample_rates[i + 1:]))
            noise_conv = (nn.Conv1d(1, out, 2 * stride, stride=stride, padding=stride // 2)
                          if i + 1 < len(c.upsample_rates) else nn.Conv1d(1, out, 1))
            self.add_module(f"noise_conv_{i}", noise_conv)
            blocks = []
            for ks, ds in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                block = block_cls(out, ks, tuple(ds))
                self.add_module(f"res_{i}_{ks}", block)
                blocks.append(block)
            self.stages.append((up, noise_conv, blocks))
            ch = out
        self.Conv_1 = WNConv1d(ch, 1, 7)

    def draw(self, mel: torch.Tensor, f0: torch.Tensor,
             generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The excitation's random draws for a forward on (mel, f0), from
        ``generator``: the keyword arguments of the random path."""
        init_phase, noise = self.source.sinegen.draw(f0.shape[0], f0.shape[1] * self.upp,
                                                     generator)
        return {"init_phase": init_phase, "noise": noise}

    def forward(self, mel: torch.Tensor, f0: torch.Tensor, rng: torch.Generator | None = None,
                init_phase: torch.Tensor | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        """mel (B, N, n_mel), f0 (B, N) frame-rate Hz → (B, N·hop). ``rng``
        None and no draws given: the deterministic excitation."""
        excitation, _ = self.source(upsample_f0(f0, self.upp), rng, init_phase, noise)
        excitation = excitation.transpose(1, 2)  # (B, 1, T)
        x = self.Conv_0(mel)
        for up, noise_conv, blocks in self.stages:
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            exc = noise_conv(excitation).transpose(1, 2)
            n = min(x.shape[1], exc.shape[1])
            x = x[:, :n] * 2.0 if self.cfg.reference_forward else x[:, :n] + exc[:, :n]
            x = mrf(blocks, x)
        x = self.Conv_1(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[..., 0]
