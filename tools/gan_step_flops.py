#!/usr/bin/env python3
"""Count the floating-point work of one GAN vocoder training step for each
recipe that `chip_smoke.py`'s vocoder-zoo phase trains (every
`egs/vocoder/gan` recipe but BigVGAN's, and HiFi-GAN against MPD +
MS-STFT), with the smoke's own overrides (`chip_smoke.zoo_base`), from
shapes alone (`runtime/vocoder_trainer.step_flops`, which the smoke also
calls on each config it trains). Runs on the CPU in seconds:

    python3 tools/gan_step_flops.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from amphion_tpu_torch.runtime.vocoder_trainer import step_flops  # noqa: E402
from amphion_tpu_torch.utils.config import load_config, override_config  # noqa: E402
from chip_smoke import ZOO_RECIPES, zoo_base  # noqa: E402


def main() -> None:
    for name in ZOO_RECIPES + ("msstft",):
        base, model = zoo_base(name)
        cfg = override_config(load_config(os.path.join(ROOT, base)), {"model": model or {}})
        f = step_flops(cfg)
        b, n = cfg["train"]["batch_size"], cfg["train"].get("segment_frames", 64)
        print(f"{name}: G {f['params_g'] / 1e6:.2f} M params, "
              f"{f['generator_forward'] / 1e9:.1f} GFLOP a forward; D {f['params_d'] / 1e6:.2f} M, "
              f"{f['discriminator_forward'] / 1e9:.1f} GFLOP; step {f['step'] / 1e12:.3f} TFLOP "
              f"(batch {b} x {n} frames)")


if __name__ == "__main__":
    main()
