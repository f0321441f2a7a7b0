from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
