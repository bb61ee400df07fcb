"""The matting network and its weights (counterpart of vidmat/models/),
exported lazily."""

from vidmat_torch._exports import lazy_exports

__getattr__ = lazy_exports(
    {"MattingNetwork": "vidmat_torch.models.matting_net",
     "RecurrentState": "vidmat_torch.models.matting_net",
     "init_params": "vidmat_torch.models.weights",
     "flax_to_torch_state": "vidmat_torch.models.weights",
     "save_checkpoint": "vidmat_torch.models.weights",
     "load_checkpoint": "vidmat_torch.models.weights"})
