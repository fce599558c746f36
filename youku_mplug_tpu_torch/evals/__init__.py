"""Caption, classification and retrieval metrics: a copy of the JAX
package's ``youku_mplug_tpu/evals/`` metrics and METEOR (pure Python and
numpy), kept here so the port imports nothing of that package."""

from youku_mplug_tpu_torch.evals.meteor import Meteor, meteor_score
from youku_mplug_tpu_torch.evals.metrics import (
    topk_accuracy,
    itm_eval,
    normalize_chinese,
    bleu,
    rouge_l,
    cider,
    caption_eval,
)

__all__ = [
    "Meteor",
    "meteor_score",
    "topk_accuracy",
    "itm_eval",
    "normalize_chinese",
    "bleu",
    "rouge_l",
    "cider",
    "caption_eval",
]
