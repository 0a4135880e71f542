"""``paddle.incubate.inference``: the inference API re-exported (the
predictor and its server live in ``paddle_tpu_torch.inference``)."""
from ..inference import (  # noqa: F401
    Config, Predictor, load_inference_model, save_inference_model)
