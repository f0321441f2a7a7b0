from amphion_tpu_torch.models.tts.fastspeech2.fs2 import FastSpeech2, FastSpeech2Config
