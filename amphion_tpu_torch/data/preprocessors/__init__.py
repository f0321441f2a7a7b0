from amphion_tpu_torch.data.preprocessors.processor import (
    SUPPORTED_DATASETS,
    preprocess_dataset,
)
