from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
)
from amphion_tpu_torch.models.tts.maskgct.ragged_sampling import (
    s2a_sample_ragged,
    t2s_sample_ragged,
)
