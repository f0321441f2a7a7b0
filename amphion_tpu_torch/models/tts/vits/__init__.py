from amphion_tpu_torch.models.tts.vits.vits import VITS, VITSConfig
