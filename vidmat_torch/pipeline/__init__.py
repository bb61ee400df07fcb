"""The serving pipeline (counterpart of vidmat/pipeline/), exported
lazily."""

from vidmat_torch._exports import lazy_exports

__getattr__ = lazy_exports({"ImageStepper": "vidmat_torch.pipeline.stepper",
                            "VideoStepper": "vidmat_torch.pipeline.stepper"})
