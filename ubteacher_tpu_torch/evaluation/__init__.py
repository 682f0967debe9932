from .coco_eval import COCOBboxEvaluator
from .evaluator import inference_on_dataset

__all__ = ["COCOBboxEvaluator", "inference_on_dataset"]
