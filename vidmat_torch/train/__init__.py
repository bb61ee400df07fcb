"""Training of the port (counterpart of vidmat/train/): the BPTT train
step, the segmentation co-training step, the losses, the optimizer and
schedule, the synthetic batchers (``data``), the directory-format dataset
(``dataset``) and the refiner's trainer (``refine``). Steps run on the
card unless the caller passes ``device="cpu"``, or over the positions of
a ``mesh=``."""

from vidmat_torch.train.losses import (matting_loss,  # noqa: F401
                                       segmentation_loss)
from vidmat_torch.train.loop import (TrainState,  # noqa: F401
                                     make_seg_train_step, make_train_step,
                                     train_on_clips)
from vidmat_torch.train.optim import make_optimizer  # noqa: F401
